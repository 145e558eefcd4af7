"""Decode attention: the CUDA launch wrapper and its plain version.

The kernel attends one new token per
sequence, q [B, H, Dh], over its KV cache k/v [B, S, KH, Dh]: rows
pos < lengths[b] (the current slot included), with a window only
pos > lengths[b] - 1 - window, an optional tanh softcap, float32 scores and
accumulation. The output has q's dtype; a sequence with no valid row gives
zeros (the TPU kernel's rule).

``ops.decode_attention`` picks by the tensor's device: a CUDA tensor
launches ``decode_attention_cuda`` (the Hopper kernel built from
``csrc/decode_attention.cu``), a CPU tensor takes ``decode_attention_plain``.
The source is compiled on first use by
``repro_torch.kernels.build``; nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, require_sm90

HEAD_DIMS = (16, 32, 64, 128)  # the head widths the CUDA kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_S = 64  # cache rows per tile (``BS`` in the CUDA source)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100

launches = 0  # CUDA launches of this kernel (one per wrapper call on a CUDA tensor)


def reset_launches() -> None:
    global launches
    launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIB = CudaLibrary(Path(__file__).resolve().parent / "csrc" / "decode_attention.cu", _declare)


def _check(q, k, v, lengths) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape or lengths.dim() != 1:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, lengths {tuple(lengths.shape)}")
    B, H, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or H % k.shape[2] or lengths.shape[0] != B:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k/v {tuple(k.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes: q {q.dtype}, k {k.dtype}, v {v.dtype} (float32 or bfloat16)")
    if len({q.device, k.device, v.device, lengths.device}) != 1:
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}, {lengths.device}")


def decode_attention_plain(q, k, v, lengths, *, window=0, softcap=0.0, scale=None):
    """Plain PyTorch version of the kernel: [B, KH, G, S] scores in float32,
    the length and window masks, softmax, PV in float32, zeros for a
    sequence with no valid row. Same signature and result as the kernel."""
    _check(q, k, v, lengths)
    B, H, Dh = q.shape
    S, KH = k.shape[1], k.shape[2]
    scale = scale if scale is not None else Dh ** -0.5
    qf = q.to(torch.float32).reshape(B, KH, H // KH, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.to(torch.float32)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)[None]
    lens = lengths.to(torch.int64)[:, None]
    mask = pos < lens
    if window:
        mask &= pos > lens - 1 - window
    mask = mask[:, None, None, :]
    w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    w = torch.where(mask.any(-1, keepdim=True), w, 0.0)  # no valid row: zeros
    o = torch.einsum("bkgs,bskd->bkgd", w, v.to(torch.float32))
    return o.reshape(B, H, Dh).to(q.dtype)


def decode_attention_cuda(q, k, v, lengths, *, window=0, softcap=0.0, scale=None):
    """Launch the Hopper kernel on the current stream (no synchronisation).
    Raises, launching nothing, on what it does not take: another device
    than an sm_90 card, a dtype other than float32/bfloat16 (one for q, k
    and v; int32 lengths), non-contiguous tensors, a head width outside
    ``HEAD_DIMS``, a head group too large for shared memory."""
    global launches
    _check(q, k, v, lengths)
    require_sm90(q, "decode_attention")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, Dh = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {HEAD_DIMS}")
    smem = (2 * G * Dh + 2 * BLOCK_S * (Dh + 1) + G * BLOCK_S + 3 * G) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"{G} query heads per KV head need {smem} bytes of shared memory")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    scale = scale if scale is not None else Dh ** -0.5
    lib = LIB.load()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        B, S, H, KH, Dh, DTYPES[q.dtype], int(window), float(softcap), float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    launches += 1
    return o

