"""Optimizers: AdamW and AdamW with 8-bit block-quantized moments (the port
of the reference's ``training/optimizer.py``).

The 8-bit variant quantizes m and v per last-axis row (absmax / 127, int8
values and float32 row scales), 2 bytes a parameter plus the scales in
place of 8. The state tree is the reference's: per parameter leaf
``{"m", "v"}`` float32, or under ``quantized`` (leaves whose last axis is
at least 8 wide) ``{"m": {"q", "scale"}, "v": {"q", "scale"}}``. The
update is functional, as the reference's: it returns new parameter and
state trees and leaves its inputs as they are.

The reference scans its stacked leaves layer by layer to bound the float32
working set on a TPU; here a leaf is updated whole (the per-row
quantization makes the two equal), one leaf at a time, so the float32
transients are one leaf's. ``opt_state_specs`` shards the moments like
their parameters (the 8-bit scales drop the last axis), and over ``pod``
too with ``pod_extend``. On ``meta`` ``init_opt_state`` gives shapes and
dtypes only.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

F32 = torch.float32


class AdamWConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantized: bool = False  # 8-bit moments


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of the nested dicts ``tree``, keeping its
    structure, with the matching subtrees of ``rest`` (a leaf of ``tree``
    may face a whole dict in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# 8-bit blockwise quantization (per last-axis row absmax)
# ---------------------------------------------------------------------------


def _quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(F32)}


def _dequantize(s: Dict[str, torch.Tensor]) -> torch.Tensor:
    return s["q"].to(F32) * s["scale"]


def _is_quantized(p: torch.Tensor, cfg: AdamWConfig) -> bool:
    return cfg.quantized and p.dim() >= 1 and p.shape[-1] >= 8


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def init_opt_state(params, cfg: AdamWConfig):
    def one(p):
        zeros = torch.zeros(p.shape, dtype=F32, device=p.device)
        if _is_quantized(p, cfg):
            return {"m": _quantize(zeros), "v": _quantize(zeros)}
        return {"m": zeros, "v": zeros.clone()}

    return tree_map(one, params)


def opt_state_specs(param_specs, params, cfg: AdamWConfig, pod_extend: bool = False):
    """The moments' spec tree: each moment sharded like its parameter, the
    8-bit scales without the last axis. ``pod_extend`` shards them over
    ``pod`` as well (``("pod", "data")`` for ``data``): cross-pod ZeRO-1,
    the moments touched once a step, so their per-chip bytes halve on two
    pods."""

    def one(spec, p):
        spec = tuple(spec) if spec is not None else (None,) * p.dim()
        if pod_extend:
            spec = tuple(("pod", "data") if e == "data" else e for e in spec)
        if _is_quantized(p, cfg):
            scale_spec = spec[:-1] + (None,)
            return {"m": {"q": spec, "scale": scale_spec}, "v": {"q": spec, "scale": scale_spec}}
        return {"m": spec, "v": spec}

    return tree_map(one, param_specs, params)


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``tree``."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(F32))) for leaf in leaves))


def adamw_update(params, grads, opt_state, step, lr, cfg: AdamWConfig
                 ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping to ``cfg.clip_norm`` and
    decoupled weight decay on the matrices (ndim >= 2; none on norms and
    biases). ``step`` counts the updates before this one (bias correction
    uses step + 1); ``lr`` is a float or a 0-d tensor. Returns (params,
    opt_state, {"grad_norm"})."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.clip_norm else 1.0)
    t = torch.as_tensor(step, dtype=F32) + 1.0
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def one(p, g, s):
        g = g.to(F32) * scale
        quant = isinstance(s["m"], dict)
        m = _dequantize(s["m"]) if quant else s["m"]
        v = _dequantize(s["v"]) if quant else s["v"]
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:  # no decay on norms/bias vectors
            update = update + cfg.weight_decay * p.to(F32)
        new_p = (p.to(F32) - lr * update).to(p.dtype)
        new_s = {"m": _quantize(m), "v": _quantize(v)} if quant else {"m": m, "v": v}
        return new_p, new_s

    # the structure follows params: each parameter's {"m", "v"} is one leaf here
    pairs = tree_map(lambda p, g, s: one(p.detach(), g, s), params, grads, opt_state)
    return tree_map(lambda o: o[0], pairs), tree_map(lambda o: o[1], pairs), {"grad_norm": gnorm}
