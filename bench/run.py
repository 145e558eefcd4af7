#!/usr/bin/env python3
"""Run one cell of the benchmark once on the card and print its result.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
                         [--control 1] [--sweep R1,R2,...]

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with the reference beside its limit); the same numbers are the
last lines of standard error. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled sub-window.
``--control 1`` runs the cell with the control's answers (the reference in
the next lower precision) judged where the program's served ones would be:
its result should read ``"correct": false``. ``--sweep`` runs one window at
each offered rate after one set-up and prints a ``sweep:`` line per rate,
no result (the knee is found so).

It exits non-zero, printing no result, without a CUDA card, when the
``repro_torch`` package is not in ``src/``, and when ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` is loaded once the window has closed.
Build and kernel caches stay in fixed directories inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sweep", default="", help="comma-separated offered rates: a knee sweep")
    args = ap.parse_args()

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

    import torch

    from harness import cell

    spec = cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.workload["chips"]:
        print(f"needs {spec.workload['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the repro_torch package is not under src/", file=sys.stderr)
        return 2
    rates = [float(r) for r in args.sweep.split(",") if r]
    result = cell.run(spec, args.seed, args.seconds, bool(args.trace),
                      control=bool(args.control), t_start=T_START, rates=rates)
    if rates:
        return 0
    bad = loaded_forbidden()
    if bad:
        print(f"modules loaded that the run must not load: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
