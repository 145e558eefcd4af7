"""Shared model building blocks: norms, RoPE, MLPs, embeddings (the port of
the reference's ``models/layers.py``).

Parameters are plain dicts of tensors in the reference's layout (``x @ W``,
a leading layer axis for stacked layers). The casts sit where the
reference puts them: norms and RoPE compute in float32 and cast back, the
logits are float32, everything else runs in the parameters' dtype.
``chunked_ce_loss`` walks the sequence in ``cfg.loss_chunk`` slices, each
under ``torch.utils.checkpoint``, so neither the forward nor the backward
holds more than one slice's [B, chunk, V] float32 logits.

Each ``init_*`` has a ``*_specs`` twin giving the reference's spec tree
for the same parameters: logical-axis tuples (``FSDP``, ``TP``, None)
that ``distributed.sharding`` resolves against a mesh, with a replicated
layer axis in front for a stacked leaf (``stack_spec``). On
``device="meta"`` the initialisers draw nothing: they give each leaf its
shape and dtype only (the port's ``jax.eval_shape``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import FSDP, TP

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
    if out.is_meta:  # shapes only: nothing to draw
        return out
    for w in (out if stacked else (out,)):
        draw = torch.empty(tuple(shape), dtype=F32, device=device)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -3.0, 3.0, generator=gen)
        w.copy_(draw * std)
    return out


def stack_spec(spec: tuple, stacked: int) -> tuple:
    """Prepend a replicated layer axis to a spec for stacked params."""
    return ((None,) + tuple(spec)) if stacked else tuple(spec)


def init_generator(dev: torch.device, seed: int):
    """The initialisers' generator on ``dev``; None on ``meta``, where
    nothing is drawn."""
    return None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)


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
    inv_freq = torch.full((), theta, dtype=F32, device=positions.device) ** -freq_exponents
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


def mlp_specs(cfg, stacked: int = 0) -> dict:
    if cfg.mlp_gated:
        return {"wi_gate": stack_spec((FSDP, TP), stacked),
                "wi_up": stack_spec((FSDP, TP), stacked),
                "wo": stack_spec((TP, FSDP), stacked)}
    return {"wi": stack_spec((FSDP, TP), stacked), "wo": stack_spec((TP, FSDP), stacked)}


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


def embedding_specs(stacked: int = 0) -> dict:
    return {"table": stack_spec((TP, FSDP), stacked)}


def embed(params, tokens, cfg):
    x = params["table"][tokens]
    if cfg.embed_scale:
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def unembed_logits(table: torch.Tensor, h: torch.Tensor, cfg) -> torch.Tensor:
    logits = h.to(F32) @ table.to(F32).T
    return softcap(logits, cfg.final_logit_softcap)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over masked positions. logits [..., V] float32, labels int;
    returns (loss, the mask's sum floored at 1), as the reference does."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else mask.to(F32)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll * mask) / denom, denom


def _chunk_ce(table, h, labels, mask, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's (loss * denom, denom), the terms the reference's scan sums."""
    loss, d = cross_entropy(unembed_logits(table, h, cfg), labels, mask)
    return loss * d, d


def chunked_ce_loss(table, h, labels, cfg, mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-chunked unembed + CE: h [B, S, D], labels [B, S]. The
    [B, S, V] logits are never held whole: a Python loop over chunks of
    ``cfg.loss_chunk`` positions (the last padded, as the reference pads
    it), each chunk recomputed in backward (``torch.utils.checkpoint``)
    where autograd records it. ``loss_chunk = 0`` takes the logits whole."""
    B, S, _ = h.shape
    chunk = cfg.loss_chunk
    if not chunk:
        return cross_entropy(unembed_logits(table, h, cfg), labels, mask)
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask.to(F32) if mask is not None else h.new_ones((B, S), dtype=F32),
                     (0, pad))
    tot = den = torch.zeros((), dtype=F32, device=h.device)
    for s in range(0, S + pad, chunk):
        args = (table, h[:, s:s + chunk], labels[:, s:s + chunk],
                None if mask is None else mask[:, s:s + chunk], cfg)
        if torch.is_grad_enabled():
            t, d = checkpoint(_chunk_ce, *args, use_reentrant=False)
        else:
            t, d = _chunk_ce(*args)
        tot, den = tot + t, den + d
    return tot / torch.clamp(den, min=1.0), den
