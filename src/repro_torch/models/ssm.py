"""Mamba2 / SSD (state-space duality) blocks (the port of the reference's
``models/ssm.py``).

Prefill runs the chunked SSD scan through ``kernels.ssd_scan`` (the Hopper
kernel on a CUDA tensor, its plain version on the CPU), with the B/C groups
passed unrepeated. Decode is the single-token recurrent update on the carried
state in plain torch, as in the reference, which has no kernel there.

The rounding points are the reference's: the prefill's depthwise conv runs
in the parameters' dtype, tap by tap, then SiLU; the decode conv runs in
float32 and is cast to the input dtype; softplus, the scan and the state are
float32; ``y`` is cast to the input dtype before the gate. The cache is
updated in place: prefill overwrites the conv tail and the state, decode
advances both.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import FSDP, TP
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import (
    dense_init,
    ones_init,
    param_dtype,
    rms_norm,
    stack_spec,
    zeros_init,
)

F32 = torch.float32
FLOAT32_PARAMS = ("A_log", "dt_bias", "D")  # kept in float32 whatever the model's dtype


def _conv_dim(cfg) -> int:
    s = cfg.ssm
    return cfg.d_inner + 2 * s.ngroups * s.d_state


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it on the CPU:
    x * 1 / (1 + exp(-x)), each step rounded to x's dtype (in bfloat16 this
    differs from ``torch.sigmoid``'s single rounding in a third of the
    values)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def init_ssm(gen: torch.Generator, cfg, stacked: int = 0, device=None) -> dict:
    """Random weights from ``gen``: ``dt_bias`` is the inverse softplus of a
    log-uniform draw in [1e-3, 0.1], ``A_log = log U[1, 16]``, ``D = 1``
    (all three float32, as in the reference)."""
    s = cfg.ssm
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    cdim = _conv_dim(cfg)
    dt = param_dtype(cfg)
    lead = (stacked,) if stacked else ()
    d_in_proj = 2 * di + 2 * s.ngroups * s.d_state + H
    u = torch.rand(lead + (H,), generator=gen, dtype=F32, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a = 1.0 + 15.0 * torch.rand(lead + (H,), generator=gen, dtype=F32, device=device)
    return {
        "in_proj": dense_init(gen, (d, d_in_proj), dtype=dt, stacked=stacked, device=device),
        "conv_w": dense_init(gen, (cdim, s.d_conv), fan_in=s.d_conv, dtype=dt, stacked=stacked,
                             device=device),
        "conv_b": zeros_init((cdim,), dt, stacked, device),
        "A_log": torch.log(a),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),  # inverse softplus
        "D": ones_init((H,), F32, stacked, device),
        "norm_w": ones_init((di,), dt, stacked, device),
        "out_proj": dense_init(gen, (di, d), dtype=dt, stacked=stacked, device=device),
    }


def ssm_specs(stacked: int = 0) -> dict:
    """``init_ssm``'s spec tree: the inner width over ``TP``, the model
    width over ``FSDP``, the per-head scalars replicated."""
    return {
        "in_proj": stack_spec((FSDP, TP), stacked),
        "conv_w": stack_spec((TP, None), stacked),
        "conv_b": stack_spec((TP,), stacked),
        "A_log": stack_spec((None,), stacked),
        "dt_bias": stack_spec((None,), stacked),
        "D": stack_spec((None,), stacked),
        "norm_w": stack_spec((TP,), stacked),
        "out_proj": stack_spec((TP, FSDP), stacked),
    }


def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    di = cfg.d_inner
    gn = s.ngroups * s.d_state
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn], zxbcdt[..., 2 * di + 2 * gn:]


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d in xBC's dtype, summed tap by tap, then SiLU.
    xBC [B, S, C], w [C, W], b [C]."""
    W = w.shape[-1]
    S = xBC.shape[1]
    xp = F.pad(xBC, (0, 0, W - 1, 0))
    out = xp[:, 0:S] * w[:, 0]
    for j in range(1, W):
        out = out + xp[:, j:j + S] * w[:, j]
    return _silu(out + b)


def _split_xbc(cfg, xBC):
    """x [B, S, H, P] and the groups' Bm/Cm [B, S, G, N], unrepeated (the
    reference repeats them to H heads; the scan reads group h // (H // G))."""
    s = cfg.ssm
    di, H, P, G, N = cfg.d_inner, cfg.ssm_heads, s.headdim, s.ngroups, s.d_state
    B_, S_ = xBC.shape[0], xBC.shape[1]
    x = xBC[..., :di].reshape(B_, S_, H, P)
    Bm = xBC[..., di:di + G * N].reshape(B_, S_, G, N)
    Cm = xBC[..., di + G * N:].reshape(B_, S_, G, N)
    return x, Bm, Cm


def ssm_block(params, cfg, xin: torch.Tensor, *, cache: Optional[dict] = None,
              decode: bool = False) -> torch.Tensor:
    """One Mamba2 mixer. xin [B, S, d_model] (S = 1 with ``decode``);
    ``cache`` is this layer's {"conv": [B, W-1, C], "ssm": [B, H, P, N]},
    written in place. Returns [B, S, d_model]."""
    s = cfg.ssm
    H = cfg.ssm_heads
    zxbcdt = xin @ params["in_proj"]
    z, xBC, dt_raw = _split_proj(cfg, zxbcdt)
    A = -torch.exp(params["A_log"].to(F32))  # [H]
    D = params["D"].to(F32)
    dt_bias = params["dt_bias"].to(F32)

    if not decode:
        x, Bm, Cm = _split_xbc(cfg, _causal_conv(xBC, params["conv_w"], params["conv_b"]))
        dt = F.softplus(dt_raw.to(F32) + dt_bias)
        y, h_final = ssd_scan(x.contiguous(), Bm.contiguous(), Cm.contiguous(), dt, A, D,
                              chunk=s.chunk_size)
        if cache is not None:
            # the pre-conv tail becomes the decode conv state, left-padded
            # with zeros when the prompt is shorter than W - 1
            W = s.d_conv
            tail = xBC[:, -(W - 1):]
            cache["conv"].copy_(F.pad(tail, (0, 0, (W - 1) - tail.shape[1], 0)))
            cache["ssm"].copy_(h_final)
    else:
        window = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)  # [B, W, C] pre-conv
        conv_out = torch.einsum("bwc,cw->bc", window.to(F32), params["conv_w"].to(F32))
        xBC_t = _silu(conv_out + params["conv_b"].to(F32)).to(xin.dtype)
        x, Bm, Cm = _split_xbc(cfg, xBC_t[:, None])
        rep = H // s.ngroups
        x = x[:, 0].to(F32)  # [B, H, P]
        Bm = Bm[:, 0].repeat_interleave(rep, dim=1, output_size=H).to(F32)  # [B, H, N]
        Cm = Cm[:, 0].repeat_interleave(rep, dim=1, output_size=H).to(F32)
        dt = F.softplus(dt_raw[:, 0].to(F32) + dt_bias)  # [B, H]
        h = cache["ssm"].to(F32) * torch.exp(dt * A)[:, :, None, None] + torch.einsum(
            "bhn,bhp,bh->bhpn", Bm, x, dt)
        y = torch.einsum("bhn,bhpn->bhp", Cm, h) + D[None, :, None] * x
        y = y[:, None].to(xin.dtype)  # [B, 1, H, P]
        cache["conv"].copy_(window[:, 1:])
        cache["ssm"].copy_(h)

    Bsz, S = xin.shape[0], xin.shape[1]
    y = y.reshape(Bsz, S, cfg.d_inner)
    y = rms_norm(y * _silu(z.to(F32)).to(y.dtype), params["norm_w"], cfg.norm_eps)
    return y @ params["out_proj"]


def init_ssm_cache(cfg, batch: int, device=None) -> dict:
    """{"conv": [B, W-1, C] in the parameters' dtype, "ssm": [B, H, P, N]
    float32}, zeros."""
    s = cfg.ssm
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, _conv_dim(cfg)), dtype=param_dtype(cfg),
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, s.headdim, s.d_state), dtype=F32,
                           device=device),
    }


def ssm_cache_specs() -> dict:
    return {"conv": (("pod", "data"), None, TP), "ssm": (("pod", "data"), TP, None, None)}
