"""Fault-tolerant training launcher (the port of the reference's
``launch/train.py``).

  * checkpoint/restart — atomic manifest commits every --ckpt-every steps;
    on start, resumes from the latest valid checkpoint (params + optimizer
    + step + dataloader cursor).
  * preemption handling — SIGTERM/SIGINT trigger a final checkpoint before
    exit, so a preempted worker loses at most one step.
  * straggler log — the data pipeline is positionally deterministic
    (``data/loader.py``), so a replacement host reproduces any batch without
    peer coordination; steps slower than --straggler-factor x the trailing
    median are flagged.

It runs on the card (``--device`` defaults to CUDA and raises without
one); ``--device cpu`` trains on the CPU through the kernels' plain
versions. A step's time is taken after the loss is read back, which waits
for the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \\
      --steps 50 --ckpt-dir build/ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import signal
import statistics
import sys
import time
from typing import Optional

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.loader import ShardedLoader
from repro_torch.kernels.backend import resolve_device
from repro_torch.training.train_loop import init_train_state, make_train_step


def main(argv=None, report: Optional[dict] = None):
    """Train; returns the losses of the steps run. ``report``, when given,
    receives the step times ("step_s") and the final state ("state")."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (full width)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=None, help="default: steps // 10")
    ap.add_argument("--total-steps", type=int, default=None,
                    help="LR schedule horizon (default: --steps); lets a partial "
                         "run share the schedule of the full job it resumes")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        import dataclasses

        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    state = init_train_state(cfg, seed=args.seed, device=device)
    loader = ShardedLoader(cfg.vocab_size, args.global_batch, args.seq_len, seed=args.seed)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, extra = restore_checkpoint(args.ckpt_dir, state)
        loader.restore(extra["loader"])
        start = int(extra["loader"]["step"])
        print(f"[restore] resumed at step {start}")

    warmup = args.warmup if args.warmup is not None else max(args.steps // 10, 1)
    horizon = args.total_steps or args.steps
    train_step = make_train_step(cfg, peak_lr=args.lr, warmup_steps=warmup,
                                 total_steps=horizon)

    stop = {"now": False}

    def _sig(_signo, _frame):
        print("[preempt] signal received — checkpointing before exit", flush=True)
        stop["now"] = True

    prev = (signal.signal(signal.SIGTERM, _sig), signal.signal(signal.SIGINT, _sig))

    def checkpoint(step):
        if args.ckpt_dir:
            path = save_checkpoint(args.ckpt_dir, step, state, extra={"loader": loader.state()})
            print(f"[ckpt] step {step} -> {path}", flush=True)

    step_times = []
    losses = []
    try:
        for step in range(start, args.steps):
            batch = next(loader)
            t0 = time.perf_counter()
            state, metrics = train_step(state, {"tokens": batch["tokens"]})
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            step_times.append(dt)
            losses.append(loss)
            if len(step_times) >= 8:
                med = statistics.median(step_times[-20:])
                if dt > args.straggler_factor * med:
                    print(f"[straggler] step {step} took {dt:.2f}s (median {med:.2f}s)",
                          flush=True)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} grad_norm "
                      f"{float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e} "
                      f"({dt:.2f}s)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                checkpoint(step + 1)
            if stop["now"]:
                checkpoint(step + 1)
                sys.exit(0)
    finally:
        signal.signal(signal.SIGTERM, prev[0])
        signal.signal(signal.SIGINT, prev[1])

    checkpoint(args.steps)
    if losses:
        print(f"final loss {losses[-1]:.4f} (uniform = {math.log(cfg.vocab_size):.4f})")
    if report is not None:
        report.update(step_s=step_times, state=state, cfg=cfg)
    return losses


if __name__ == "__main__":
    main()
