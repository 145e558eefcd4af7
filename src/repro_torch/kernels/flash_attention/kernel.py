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
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, require_sm90

HEAD_DIMS = (16, 32, 64, 128, 224, 256)  # the head widths the CUDA kernel is built for
WIDTH_PAIRS = ((192, 128),)  # (q/k, v) widths it is built for where they differ (MLA)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # CUDA launches of this kernel (one per wrapper call on a CUDA tensor)


def reset_launches() -> None:
    global launches
    launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIB = CudaLibrary(Path(__file__).resolve().parent / "csrc" / "flash_attention.cu", _declare)


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


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """Plain PyTorch version of the kernel: the [B, KH, G, S, S] score
    matrix in float32, masks, softmax, PV in float32, zeros for a row with
    no valid key. Same signature and result as the CUDA kernel."""
    _check(q, k, v)
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    scale = scale if scale is not None else Dh ** -0.5
    qf = q.to(torch.float32).reshape(B, S, KH, H // KH, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    w = torch.where(mask.any(-1, keepdim=True), w, 0.0)  # no valid key: zeros
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(torch.float32))
    return o.reshape(B, S, H, v.shape[3]).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """Launch the Hopper kernel on the current stream (no synchronisation).
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
    if Dv == Dh and Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {HEAD_DIMS}")
    if Dv != Dh and (Dh, Dv) not in WIDTH_PAIRS:
        raise ValueError(f"head_dim pair (q/k {Dh}, v {Dv}) not in {WIDTH_PAIRS}")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    scale = scale if scale is not None else Dh ** -0.5
    lib = LIB.load()
    o = q.new_empty((B, S, H, Dv))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, k.shape[2], Dh, Dv,
        DTYPES[q.dtype], int(bool(causal)), int(window), float(softcap), float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return o
