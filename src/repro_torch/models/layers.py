"""Shared model building blocks: norms, RoPE, MLPs, embeddings (the port of
the reference's ``models/layers.py``).

Parameters are plain dicts of tensors in the reference's layout (``x @ W``,
a leading layer axis for stacked layers). The casts sit where the
reference puts them: norms and RoPE compute in float32 and cast back, the
logits are float32, everything else runs in the parameters' dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Init helpers (seeded from a torch.Generator; the reference draws from
# jax.random, so the two packages' random weights differ — parity tests carry
# the reference's weights across with ``transformer.params_from_jax``)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, fan_in: Optional[int] = None,
               dtype=torch.bfloat16, stacked: int = 0, device=None) -> torch.Tensor:
    """Truncated-normal init with 1/sqrt(fan_in) scale; optional leading stack
    dim. A stack is drawn layer by layer, so the float32 scratch is one
    layer's (gemma2-27b's FFN stack would need 62 GB of it at once)."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(((stacked,) if stacked else ()) + tuple(shape), dtype=dtype,
                      device=device)
    for w in (out if stacked else (out,)):
        draw = torch.empty(tuple(shape), dtype=F32, device=device)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -3.0, 3.0, generator=gen)
        w.copy_(draw * std)
    return out


def zeros_init(shape, dtype=torch.bfloat16, stacked: int = 0, device=None) -> torch.Tensor:
    full = (stacked,) + tuple(shape) if stacked else tuple(shape)
    return torch.zeros(full, dtype=dtype, device=device)


def ones_init(shape, dtype=torch.bfloat16, stacked: int = 0, device=None) -> torch.Tensor:
    full = (stacked,) + tuple(shape) if stacked else tuple(shape)
    return torch.ones(full, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(F32)).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, theta: float, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [B, S, d/2] in float32 for ``positions`` [B, S]. Every
    layer with the same theta shares them, so a forward computes them once
    per theta (``transformer._run_stacks``)."""
    half = d // 2
    freq_exponents = torch.arange(half, dtype=F32, device=positions.device) / half
    inv_freq = torch.tensor(theta, dtype=F32, device=positions.device) ** -freq_exponents
    ang = positions.to(F32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply rotary angles from ``rope_angles`` to x [B, S, D] or [B, S, H, D]."""
    if x.dim() == 4:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]  # broadcast over heads
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [B, S, D] or [B, S, H, D]; positions: [B, S]."""
    return rotate(x, *rope_angles(positions, theta, x.shape[-1]))


# ---------------------------------------------------------------------------
# Activations / softcap
# ---------------------------------------------------------------------------


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, d_in: int, d_ff: int, cfg, stacked: int = 0, device=None) -> dict:
    dt = param_dtype(cfg)
    if cfg.mlp_gated:
        return {
            "wi_gate": dense_init(gen, (d_in, d_ff), dtype=dt, stacked=stacked, device=device),
            "wi_up": dense_init(gen, (d_in, d_ff), dtype=dt, stacked=stacked, device=device),
            "wo": dense_init(gen, (d_ff, d_in), fan_in=d_ff, dtype=dt, stacked=stacked,
                             device=device),
        }
    return {
        "wi": dense_init(gen, (d_in, d_ff), dtype=dt, stacked=stacked, device=device),
        "wo": dense_init(gen, (d_ff, d_in), fan_in=d_ff, dtype=dt, stacked=stacked,
                         device=device),
    }


def mlp(params, x, cfg):
    if "wi_gate" in params:
        h = activation(x @ params["wi_gate"], cfg.act) * (x @ params["wi_up"])
    else:
        h = activation(x @ params["wi"], cfg.act)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d_model: int, cfg, device=None) -> dict:
    return {"table": dense_init(gen, (vocab, d_model), fan_in=d_model,
                                dtype=param_dtype(cfg), device=device)}


def embed(params, tokens, cfg):
    x = params["table"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def unembed_logits(table: torch.Tensor, h: torch.Tensor, cfg) -> torch.Tensor:
    logits = h.to(F32) @ table.to(F32).T
    return softcap(logits, cfg.final_logit_softcap)
