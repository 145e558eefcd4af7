"""Attention: GQA with sliding-window / softcap / qk-norm variants, and MLA
(the port of the reference's ``models/attention.py``).

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

MLA (DeepSeek-V3's multi-head latent attention) caches the normed latent
``ckv`` [B, S_max, kv_lora_rank] and the roped ``kr`` [B, S_max,
qk_rope_head_dim] per layer, in place as above. Prefill expands the latent
to per-head K (q/k width ``qk_head_dim``, the rope part shared by every
head) and V (``v_head_dim``) and attends through the flash_attention
kernel with its own value width (192 and 128 at full width). Decode is the
reference's "absorbed" form: the query is carried into the latent space,
scores are taken against ``ckv`` and ``kr`` in float32, the softmax weights
are cast to the cache's dtype and aggregate ``ckv``, and the context leaves
the latent space through the value half of ``wkv_b``. The reference has no
Pallas kernel for that step, and neither has the port: it is these plain
torch einsums on every device, as the reference leaves them to XLA, and
the decode_attention kernel is not launched for MLA.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (
    F32,
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------

NEG_INF = -2.3819763e38  # the reference's mask value for the absorbed scores


def init_mla(gen, cfg, stacked: int = 0, device=None) -> dict:
    """The query (wq_a, q_norm, wq_b) and latent (wkv_a, kv_norm, wkv_b)
    projections and wo [H, v_head_dim, d], in the reference's shapes."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    kw = dict(dtype=param_dtype(cfg), stacked=stacked, device=device)
    return {
        "wq_a": dense_init(gen, (D, m.q_lora_rank), **kw),
        "q_norm": ones_init((m.q_lora_rank,), **kw),
        "wq_b": dense_init(gen, (m.q_lora_rank, H, m.qk_head_dim), fan_in=m.q_lora_rank, **kw),
        "wkv_a": dense_init(gen, (D, m.kv_lora_rank + m.qk_rope_head_dim), **kw),
        "kv_norm": ones_init((m.kv_lora_rank,), **kw),
        "wkv_b": dense_init(gen, (m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim),
                            fan_in=m.kv_lora_rank, **kw),
        "wo": dense_init(gen, (H, m.v_head_dim, D), fan_in=H * m.v_head_dim, **kw),
    }


def mla_rope(cfg, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) for MLA's rope parts (``qk_rope_head_dim`` wide), shared by
    every layer of a forward."""
    return rope_angles(positions, cfg.rope_theta, cfg.mla.qk_rope_head_dim)


def _mla_q(params, cfg, x, rope):
    """q_nope [B, S, H, nope], q_rope [B, S, H, r] (roped)."""
    m = cfg.mla
    cq = rms_norm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
    q = _proj(cq, params["wq_b"])
    return q[..., :m.qk_nope_head_dim], rotate(q[..., m.qk_nope_head_dim:], *rope)


def _mla_kv_latent(params, cfg, x, rope):
    """c_kv [B, S, kv_lora_rank] (normed), k_rope [B, S, r] (roped)."""
    m = cfg.mla
    kvr = x @ params["wkv_a"]
    c_kv = rms_norm(kvr[..., :m.kv_lora_rank], params["kv_norm"], cfg.norm_eps)
    return c_kv, rotate(kvr[..., m.kv_lora_rank:], *rope)


def mla_attention(params, cfg, x, positions, *, cache: Optional[dict] = None,
                  cache_positions: Optional[torch.Tensor] = None,
                  rope: Rope = None) -> Tuple[torch.Tensor, Optional[dict]]:
    """MLA block body (no norms/residual). Prefill: ``cache`` is None or a
    layer's {"ckv", "kr"} to fill from position 0 in place (rows past S
    cleared). Decode: x [B, 1, d], ``cache_positions`` [B] the row each new
    token's latent is written to before attending. ``rope`` is
    ``mla_rope``'s pair when the caller shares it across layers."""
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.qk_head_dim)
    rope = rope if rope is not None else mla_rope(cfg, positions)
    q_nope, q_rope = _mla_q(params, cfg, x, rope)
    c_kv, k_rope = _mla_kv_latent(params, cfg, x, rope)
    B, S = x.shape[0], x.shape[1]

    if cache_positions is None:
        # expand the latent to per-head K and V; the rope part of K is shared
        kv = _proj(c_kv, params["wkv_b"])
        H, nope = cfg.num_heads, m.qk_nope_head_dim
        k = torch.cat([kv[..., :nope],
                       k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(q, k, kv[..., nope:].contiguous(), causal=True,
                              softcap=cfg.attn_logit_softcap, scale=scale)
        if cache is not None:
            for name, new in (("ckv", c_kv), ("kr", k_rope)):
                cache[name][:, :S] = new  # in place; rows past S are cleared
                cache[name][:, S:] = 0
    else:
        # absorbed decode: scores and context in the latent space
        b_idx = torch.arange(B, device=x.device)
        cache["ckv"][b_idx, cache_positions] = c_kv[:, 0]  # in place
        cache["kr"][b_idx, cache_positions] = k_rope[:, 0]
        ckv, kr = cache["ckv"], cache["kr"]
        w_uk = params["wkv_b"][..., :m.qk_nope_head_dim]  # [kvl, H, nope]
        w_uv = params["wkv_b"][..., m.qk_nope_head_dim:]  # [kvl, H, v]
        q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope, w_uk)
        s = torch.einsum("bqhl,bsl->bhqs", q_lat.to(F32), ckv.to(F32))
        s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.to(F32), kr.to(F32))
        s = s * scale
        valid = torch.arange(ckv.shape[1], device=x.device)[None] <= cache_positions[:, None]
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        w = torch.softmax(s, dim=-1).to(ckv.dtype)
        ctx_lat = torch.einsum("bhqs,bsl->bqhl", w, ckv)
        out = torch.einsum("bqhl,lhv->bqhv", ctx_lat, w_uv)

    y = out.reshape(*out.shape[:2], -1) @ params["wo"].reshape(-1, params["wo"].shape[-1])
    return y, cache


def init_mla_cache(cfg, batch: int, max_seq: int, device=None) -> dict:
    m = cfg.mla
    dt = param_dtype(cfg)
    return {"ckv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dt, device=device),
            "kr": torch.zeros((batch, max_seq, m.qk_rope_head_dim), dtype=dt, device=device)}
