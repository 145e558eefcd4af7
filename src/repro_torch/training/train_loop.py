"""Training step factory: grad accumulation + remat + AdamW(+8bit) + metrics
(the port of the reference's ``training/train_loop.py``).

``make_train_step(cfg)`` builds the (state, batch) -> (state, metrics)
function that ``launch/train.py`` drives. Gradients are taken by autograd
through ``transformer.loss_fn`` (each layer rematerialised under
``cfg.remat``; on the card attention's backward is the flash-attention
backward kernel). Grad accumulation runs the microbatches in a loop and
sums their gradients in float32, or in bfloat16 under the 8-bit optimizer,
as the reference does. Nothing is jitted: the step runs eagerly.

The state lives on the parameters' device; ``step`` is an int32 0-d tensor
on the CPU (the schedule is computed on the host, so a step never waits on
the card for it). ``train_state_specs`` is the reference's second result of
``init_train_state`` (the state's spec tree), and ``abstract_train_state``
the reference's shape-only state with it, on ``meta``, for the dry run.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike
from repro_torch.models import transformer as T
from repro_torch.training import schedule as sched
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    opt_state_specs,
    tree_leaves,
    tree_map,
)

F32 = torch.float32


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor  # int32 0-d, on the CPU


def opt_config(cfg) -> AdamWConfig:
    return AdamWConfig(quantized=cfg.optimizer == "adamw8bit")


def init_train_state(cfg, seed: int = 0, device: DeviceLike = None) -> TrainState:
    """Random parameters from ``seed`` on ``device`` (None = CUDA, raising
    without one), zero moments, step 0."""
    params = T.init_params(cfg, seed=seed, device=device)
    return TrainState(params, init_opt_state(params, opt_config(cfg)),
                      torch.zeros((), dtype=torch.int32))


def train_state_specs(cfg, params=None) -> TrainState:
    """The state's spec tree (the reference's ``init_train_state(...)[1]``):
    the parameters', the moments' (``opt_state_specs``, over ``pod`` too
    under ``cfg.opt_pod_sharded``) and the step's ``()``. ``params`` (a
    tree of tensors or meta tensors) gives the leaves' shapes; the meta
    parameters by default."""
    params = params if params is not None else T.init_params(cfg, device="meta")
    p_specs = T.param_specs(cfg)
    return TrainState(params=p_specs,
                      opt_state=opt_state_specs(p_specs, params, opt_config(cfg),
                                                pod_extend=cfg.opt_pod_sharded),
                      step=())


def abstract_train_state(cfg) -> Tuple[TrainState, TrainState]:
    """(the state on ``meta``: every leaf's shape and dtype, nothing
    allocated or drawn; its spec tree), for the dry run."""
    state = init_train_state(cfg, device="meta")
    return state, train_state_specs(cfg, state.params)


def _on(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays (numpy from the loader, or tensors) on ``device``."""
    return {k: torch.as_tensor(  # repro: noqa[RA203] — the step's input batch, uploaded first
        np.asarray(v) if not isinstance(v, torch.Tensor) else v, device=device)
        for k, v in batch.items()}


def _microbatch_grads(cfg, params, batch, accum_dtype):
    """``cfg.grad_accum`` microbatches of the batch's leading axis in turn,
    their gradients summed in ``accum_dtype`` and averaged (one microbatch:
    the gradients in the parameters' dtypes). Returns (grads, the mean loss,
    the last microbatch's metrics)."""
    accum = max(cfg.grad_accum, 1)
    gb = batch["tokens"].shape[0]
    assert gb % accum == 0, (gb, accum)
    mb = gb // accum
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)

    def grad_of(b):
        loss, metrics = T.loss_fn(tracked, cfg, b)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, leaves)]
        return gs, loss.detach(), {k: v.detach() for k, v in metrics.items()}

    if accum == 1:
        gs, loss, metrics = grad_of(batch)
    else:
        acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in leaves]
        loss = torch.zeros((), dtype=F32, device=leaves[0].device)
        for i in range(accum):
            g_i, loss_i, metrics = grad_of({k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
            for a, g in zip(acc, g_i):
                a.add_(g.to(accum_dtype))
            loss = loss + loss_i
        gs = [(a / accum).to(accum_dtype) for a in acc]
        loss = loss / accum
    it = iter(gs)
    return tree_map(lambda _: next(it), params), loss, metrics


def make_train_step(
    cfg,
    *,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    schedule: Callable = sched.warmup_cosine,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    opt_cfg = opt_config(cfg)
    accum_dtype = torch.bfloat16 if opt_cfg.quantized else F32

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        device = tree_leaves(state.params)[0].device
        grads, loss, metrics = _microbatch_grads(cfg, state.params, _on(batch, device),
                                                 accum_dtype)
        lr = schedule(state.step, peak_lr=peak_lr, warmup_steps=warmup_steps,
                      total_steps=total_steps)
        new_params, new_opt, opt_metrics = adamw_update(
            state.params, grads, state.opt_state, state.step, lr, opt_cfg)
        metrics = dict(metrics, loss=loss, lr=lr, **opt_metrics)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def make_eval_step(cfg):
    def eval_step(params, batch):
        with torch.no_grad():
            device = tree_leaves(params)[0].device
            loss, metrics = T.loss_fn(params, cfg, _on(batch, device))
        return dict(metrics, loss=loss)

    return eval_step
