"""Attention: GQA with sliding-window / softcap / qk-norm variants (the port of
the GQA part of the reference's ``models/attention.py``; MLA waits for
ROADMAP queue A item 10e).

Where the reference runs chunked jnp attention (``mha``), the port runs the
two attention kernels: prefill is ``flash_attention`` (causal, over the
prompt's own K/V) and decode is ``decode_attention`` over the cache with
``lengths = pos + 1``. Both compute what ``mha`` computes under the same
masks; their plain versions (the CPU path) are the port's one reference of
that step. They keep the softmax weights in float32 for PV, where ``mha``
casts them to ``v``'s dtype first.

The KV cache is ``{"k", "v"}: [B, S_max, KH, Dh]`` per layer, a view into the
stacked ``[layers, B, S_max, KH, Dh]`` cache, and is written IN PLACE:
prefill fills rows 0..S-1 and clears the rest, decode writes one row per
sequence. The reference returns new buffers instead.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (
    dense_init,
    ones_init,
    param_dtype,
    rms_norm,
    rope_angles,
    rotate,
    zeros_init,
)

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def init_attn(gen, cfg, d_in: Optional[int] = None, stacked: int = 0, device=None) -> dict:
    """wq/wk/wv [d_in, N, Dh] and wo [H, Dh, d_in]; ``d_in`` defaults to
    ``cfg.d_model`` (the hybrid's shared blocks run at 2 * d_model)."""
    d_in = d_in or cfg.d_model
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = param_dtype(cfg)
    kw = dict(dtype=dt, stacked=stacked, device=device)
    params = {
        "wq": dense_init(gen, (d_in, H, Dh), fan_in=d_in, **kw),
        "wk": dense_init(gen, (d_in, K, Dh), fan_in=d_in, **kw),
        "wv": dense_init(gen, (d_in, K, Dh), fan_in=d_in, **kw),
        "wo": dense_init(gen, (H, Dh, d_in), fan_in=H * Dh, **kw),
    }
    if cfg.qkv_bias:
        params["bq"] = zeros_init((H, Dh), **kw)
        params["bk"] = zeros_init((K, Dh), **kw)
        params["bv"] = zeros_init((K, Dh), **kw)
    if cfg.qk_norm:
        params["q_norm"] = ones_init((Dh,), **kw)
        params["k_norm"] = ones_init((Dh,), **kw)
    return params


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] @ w [d, N, Dh] -> [B, S, N, Dh]."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _project_qkv(params, cfg, x, positions, theta, use_rope, rope: Rope = None):
    """q [B, S, H, Dh], k/v [B, S, KH, Dh]. ``rope`` is the (cos, sin) pair
    from ``rope_angles`` when the caller shares it across layers."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if use_rope:
        cos, sin = rope if rope is not None else rope_angles(positions, theta, q.shape[-1])
        q = rotate(q, cos, sin)
        k = rotate(k, cos, sin)
    return q, k, v


def attention(params, cfg, x, positions, *, window: int, theta: float, use_rope: bool = True,
              cache: Optional[dict] = None, cache_positions: Optional[torch.Tensor] = None,
              rope: Rope = None) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full attention block body (no norms/residual — those live in the caller).

    Train/prefill: ``cache`` is None, or a layer cache to fill from position
    0 in place. Decode: x is [B, 1, d], ``cache`` holds k/v and
    ``cache_positions`` [B] the row each new token occupies; the row is
    written in place before attending."""
    q, k_new, v_new = _project_qkv(params, cfg, x, positions, theta, use_rope, rope)
    scale = cfg.query_scale or (1.0 / math.sqrt(cfg.head_dim))
    cap = cfg.attn_logit_softcap
    if cache_positions is None:
        out = flash_attention(q, k_new, v_new, causal=True, window=window, softcap=cap,
                              scale=scale)
        if cache is not None:
            S = x.shape[1]
            for name, new in (("k", k_new), ("v", v_new)):
                cache[name][:, :S] = new  # in place; rows past S are cleared
                cache[name][:, S:] = 0
    else:
        b_idx = torch.arange(x.shape[0], device=x.device)
        cache["k"][b_idx, cache_positions] = k_new[:, 0]  # in place
        cache["v"][b_idx, cache_positions] = v_new[:, 0]
        lengths = (cache_positions + 1).to(torch.int32)
        out = decode_attention(q[:, 0], cache["k"], cache["v"], lengths, window=window,
                               softcap=cap, scale=scale)[:, None]
    y = out.reshape(*out.shape[:2], -1) @ params["wo"].reshape(-1, params["wo"].shape[-1])
    return y, cache


def init_attn_cache(cfg, batch: int, max_seq: int, device=None) -> dict:
    dt = param_dtype(cfg)
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
