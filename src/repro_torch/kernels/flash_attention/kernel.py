"""Prefill attention: the CUDA launch wrapper and its plain version.

The kernel computes softmax(q k^T * scale) v
for q [B, S, H, Dh] against k [B, S, KH, Dh] and v [B, S, KH, Dv] (query
head h reads KV head h // G) under an optional causal mask, sliding window
and tanh softcap, with float32 scores and accumulation; the output [B, S,
H, Dv] has q's dtype and a row with no valid key is zeros (the TPU kernel's
rule). The value width Dv is Dh (``HEAD_DIMS``) or, for MLA's prefill, one
of ``WIDTH_PAIRS`` (q/k 192, v 128), as the reference's ``mha`` takes
``v.shape[-1]`` apart from q's.

``ops.flash_attention`` picks by the tensor's device: a CUDA tensor
launches ``flash_attention_cuda`` (the Hopper kernels built from
``csrc/flash_attention.cu``: bfloat16 on the tensor cores, by wgmma at
head widths 64, 128, 224 (tiles padded to 256) and 256 and by mma.sync at
16 and 32; float32 on scalar FP32 FMAs, so float32 callers keep float32
exactness; the pair (192, 128) on both, wgmma with 192-wide Q/K tiles and
128-wide V tiles), a CPU tensor takes ``flash_attention_plain``. The
tensor-core kernels round P to bfloat16 for PV, as FlashAttention does;
the reference and the plain version keep P in float32.
The source is compiled on first use by
``repro_torch.kernels.build``; nothing is built when the module is imported.

The gradient. ``FlashAttentionFn`` is the kernel under autograd: its
forward launches the kernel and keeps each row's log-sum-exp (``lse``
[B, H, S] float32, which the kernel writes when asked), its backward
launches ``flash_attention_bwd_cuda``: the three kernels of
``csrc/flash_attention_bwd.cu`` (rowsum(dO o), then dK/dV and dQ apart,
without atomics, so a gradient is the same bits every run; bfloat16 on
the tensor cores, by wgmma over a ring of cp.async tiles at widths 64 to
256 and (192, 128) and by mma.sync at 16 and 32; float32 on scalar FP32
FMAs), at every width the forward takes. ``flash_attention_bwd_plain`` is
their plain version, the explicit formula in float32. The reference has
no such kernel: it trains through jnp attention that XLA differentiates.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, require_sm90

HEAD_DIMS = (16, 32, 64, 128, 224, 256)  # the head widths the CUDA kernel is built for
WIDTH_PAIRS = ((192, 128),)  # (q/k, v) widths it is built for where they differ (MLA)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # CUDA launches of the forward kernel (one per wrapper call on a CUDA tensor)
bwd_launches = 0  # CUDA launches of the backward kernels (three per backward call)


def reset_launches() -> None:
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _declare_bwd(lib: ctypes.CDLL) -> None:
    lib.flash_attention_bwd_dot.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.flash_attention_bwd_dkdv.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                                             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.flash_attention_bwd_dq.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                                           + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    for fn in (lib.flash_attention_bwd_dot, lib.flash_attention_bwd_dkdv,
               lib.flash_attention_bwd_dq):
        fn.restype = ctypes.c_int


_CSRC = Path(__file__).resolve().parent / "csrc"
LIB = CudaLibrary(_CSRC / "flash_attention.cu", _declare)
LIB_BWD = CudaLibrary(_CSRC / "flash_attention_bwd.cu", _declare_bwd)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, Dh = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != Dh or H % k.shape[2]:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes: q {q.dtype}, k {k.dtype}, v {v.dtype} (float32 or bfloat16)")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")


def _check_widths(Dh: int, Dv: int) -> None:
    """Raise on a width the kernels (forward and backward) are not built for:
    a head width outside ``HEAD_DIMS`` or, where v's width differs from q's,
    a pair outside ``WIDTH_PAIRS``."""
    if Dv == Dh and Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {HEAD_DIMS}")
    if Dv != Dh and (Dh, Dv) not in WIDTH_PAIRS:
        raise ValueError(f"head_dim pair (q/k {Dh}, v {Dv}) not in {WIDTH_PAIRS}")


def _masked_scores(q, k, *, causal, window, softcap, scale, row0=0):
    """The plain versions' float32 scores [B, KH, G, n, S] of q's n rows
    (at sequence positions row0.., against all S keys) after the scale and
    softcap, tanh(scaled / softcap) (None without a softcap) and the
    [n, S] mask of visible keys."""
    B, n, H, Dh = q.shape
    S, KH = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(B, n, KH, H // KH, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32)) * scale
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = softcap * t
    keys = torch.arange(S, device=q.device)[None, :]
    rows = torch.arange(row0, row0 + n, device=q.device)[:, None]
    mask = torch.ones((n, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= keys <= rows
    if window:
        mask &= keys > rows - window
    return s, t, mask


PLAIN_BLOCK_Q = 1024  # the reference's attn_chunk


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
                          return_lse=False):
    """Plain PyTorch version of the kernel: over blocks of
    ``PLAIN_BLOCK_Q`` query rows (each row's softmax is its own, so the
    blocks give the same rows; the live scores are one block's
    [B, KH, G, block, S]), the float32 scores, masks, softmax, PV in
    float32, zeros for a row with no valid key. Same signature and result
    as the CUDA kernel; with ``return_lse`` also each row's log-sum-exp
    [B, H, S] float32 (-inf for a row with no valid key). The dry run's
    attention on ``meta``; autograd differentiates it."""
    _check(q, k, v)
    B, S, H, Dh = q.shape
    scale = scale if scale is not None else Dh ** -0.5
    kf, vf = k.to(torch.float32), v.to(torch.float32)  # once, not per block
    outs, lses = [], []
    for i in range(0, S, PLAIN_BLOCK_Q):
        qb = q[:, i:i + PLAIN_BLOCK_Q]
        s, _, mask = _masked_scores(qb, kf, causal=causal, window=window, softcap=softcap,
                                    scale=scale, row0=i)
        s = s.masked_fill(~mask, float("-inf"))
        w = torch.softmax(s, dim=-1)
        w = torch.where(mask.any(-1, keepdim=True), w, 0.0)  # no valid key: zeros
        o = torch.einsum("bkgqs,bskd->bqkgd", w, vf)
        outs.append(o.reshape(B, qb.shape[1], H, v.shape[3]))
        if return_lse:
            lses.append(torch.logsumexp(s, dim=-1))
    o = (outs[0] if len(outs) == 1 else torch.cat(outs, 1)).to(q.dtype)
    if not return_lse:
        return o
    lse = lses[0] if len(lses) == 1 else torch.cat(lses, -1)
    return o, lse.reshape(B, H, S)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True, window=0, softcap=0.0,
                              scale=None):
    """Plain PyTorch version of the backward kernels, the explicit formula
    in float32: P = exp(x - lse) over the visible keys (x the scaled,
    softcapped scores), D = rowsum(dO o), dS = P (dP - D) dx/ds with
    dP = dO v^T and dx/ds = scale (times 1 - tanh^2 under a softcap);
    dq = dS k, dk = dS^T q and dv = P^T dO, summed over each KV head's
    query heads. Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    _check(q, k, v)
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = scale if scale is not None else Dh ** -0.5
    s, t, mask = _masked_scores(q, k, causal=causal, window=window, softcap=softcap,
                                scale=scale)
    lse_g = lse.to(torch.float32).reshape(B, KH, G, S)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dof = do.to(torch.float32).reshape(B, S, KH, G, -1)
    dd = (dof * o.to(torch.float32).reshape(B, S, KH, G, -1)).sum(-1)  # [B, S, KH, G]
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.to(torch.float32))
    ds = p * (dp - dd.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(torch.float32)).reshape(B, S, H, Dh)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.to(torch.float32).reshape(B, S, KH, G, Dh))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# repro: device-region static[causal, window, softcap, scale, return_lse]
def flash_attention_cuda(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
                         return_lse=False):
    """Launch the Hopper kernel on the current stream (no synchronisation);
    with ``return_lse`` the kernel also writes each row's log-sum-exp and
    (o, lse) is returned.
    Raises, launching nothing, on what it does not take: another device
    than an sm_90 card, a dtype other than float32/bfloat16 (one for all
    three), non-contiguous tensors, bfloat16 tensors not aligned to 16 bytes
    (the tensor-core kernel's 16-byte copies), a head width outside
    ``HEAD_DIMS`` or, where v's width differs from q's, a pair outside
    ``WIDTH_PAIRS``."""
    global launches
    _check(q, k, v)
    require_sm90(q, "flash_attention")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the tensor-core kernel")
    B, S, H, Dh = q.shape
    Dv = v.shape[3]
    _check_widths(Dh, Dv)
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    scale = scale if scale is not None else Dh ** -0.5
    lib = LIB.load()
    o = q.new_empty((B, S, H, Dv))
    lse = q.new_empty((B, H, S), dtype=torch.float32) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if return_lse else None, B, S, H, k.shape[2], Dh, Dv,
        DTYPES[q.dtype], int(bool(causal)), int(window), float(softcap), float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return (o, lse) if return_lse else o


def _launched(name: str, err: int) -> None:
    """Raise on a backward kernel's refused launch, else count it."""
    global bwd_launches
    if err != 0:
        raise RuntimeError(f"flash_attention backward ({name}) launch failed: cudaError {err}")
    bwd_launches += 1


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal=True, window=0, softcap=0.0,
                             scale=None):
    """Launch the three backward kernels on the current stream: rowsum(dO o)
    into a float32 [B, H, S] scratch, then dK/dV, then dQ. Takes what
    ``flash_attention_cuda`` takes, with o and do [B, S, H, Dv] and lse
    [B, H, S] float32, all contiguous; raises, launching nothing, on
    anything else. Returns (dq, dk, dv)."""
    _check(q, k, v)
    require_sm90(q, "flash_attention backward")
    B, S, H, Dh = q.shape
    KH, Dv = k.shape[2], v.shape[3]
    _check_widths(Dh, Dv)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do), ("lse", lse)):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if q.dtype == torch.bfloat16 and name != "lse" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the tensor-core kernels")
    if (o.shape != (B, S, H, Dv) or do.shape != o.shape or o.dtype != q.dtype
            or do.dtype != q.dtype):
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} {do.dtype} "
                         f"must be [{B}, {S}, {H}, {Dv}] {q.dtype}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{B}, {H}, {S}], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    scale = scale if scale is not None else Dh ** -0.5
    lib = LIB_BWD.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dt = DTYPES[q.dtype]
    dd = q.new_empty((B, H, S), dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    mask = (int(bool(causal)), int(window), float(softcap), float(scale), stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr())
    _launched("rowsum", lib.flash_attention_bwd_dot(o.data_ptr(), do.data_ptr(), dd.data_ptr(),
                                                    B, S, H, Dv, dt, stream))
    _launched("dK/dV", lib.flash_attention_bwd_dkdv(*ptrs, dk.data_ptr(), dv.data_ptr(), B, S,
                                                     H, KH, Dh, Dv, dt, *mask))
    _launched("dQ", lib.flash_attention_bwd_dq(*ptrs, dq.data_ptr(), B, S, H, KH, Dh, Dv, dt,
                                               *mask))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The kernel under autograd on CUDA tensors: the forward launches
    ``flash_attention_cuda`` with the row log-sum-exp and saves q, k, v, o
    and lse; the backward launches ``flash_attention_bwd_cuda``."""

    # repro: device-region static[causal, window, softcap, scale]
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                      scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None
