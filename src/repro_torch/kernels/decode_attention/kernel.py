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

The kernel splits the cache rows over ``split_plan``'s NS blocks per
(b, KV head), chosen from the shapes alone (never from ``lengths``, which
lies on the card), and merges the splits' partial softmax states in the
same launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, require_sm90

HEAD_DIMS = (16, 32, 64, 128, 224, 256)  # the head widths the CUDA kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_S = 64  # cache rows per split tile (``TILE`` in the CUDA source)
THREADS = 256  # threads per block (``THREADS`` in the CUDA source)
MAX_SPLITS = 64  # most splits per (b, KV head) (``MAX_SPLITS`` in the CUDA source)
SMS = 132  # streaming multiprocessors of an H100 SXM
WAVES = 2  # long caches fill the card about this many times over
MIN_SPLIT_BYTES = 128 * 1024  # K and V bytes a split reads at least

launches = 0  # CUDA launches of this kernel (one per wrapper call on a CUDA tensor)


def reset_launches() -> None:
    global launches
    launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIB = CudaLibrary(Path(__file__).resolve().parent / "csrc" / "decode_attention.cu", _declare)


def split_plan(B: int, KH: int, S: int, Dh: int, dtype: torch.dtype) -> tuple:
    """(NS, rows per split) for a [B, S, KH, Dh] cache, from the shapes
    alone. Splits are runs of whole ``BLOCK_S``-row tiles that cover [0, S),
    none of them empty: NS = ceil(tiles / tiles per split). A split reads at
    least ``MIN_SPLIT_BYTES`` of K and V when the cache is full, so short
    caches (the engine's S = 256) stay one pass; long ones get enough splits
    for B * KH * NS blocks to fill the card ``WAVES`` times over."""
    tiles = -(-S // BLOCK_S)
    tile_bytes = 2 * BLOCK_S * Dh * dtype.itemsize
    most = max(1, min(MAX_SPLITS, tiles * tile_bytes // MIN_SPLIT_BYTES))
    want = max(1, min(most, -(-WAVES * SMS // max(B * KH, 1))))
    per = -(-tiles // want)
    return -(-tiles // per), per * BLOCK_S


def num_splits(B: int, KH: int, S: int, Dh: int, dtype: torch.dtype) -> int:
    """NS of ``split_plan``: the blocks per (b, KV head) the kernel runs."""
    return split_plan(B, KH, S, Dh, dtype)[0]


def max_heads(Dh: int) -> int:
    """Query heads one block serves at most: 8, and 4 above Dh 128, where
    the block's [8 warps, heads, Dh] float32 merge buffer must stay within
    48 KB of shared memory (``dispatch_g`` in the CUDA source)."""
    return 8 if Dh <= 128 else 4


def launch_grid(B: int, H: int, KH: int, S: int, Dh: int, dtype: torch.dtype) -> tuple:
    """The kernel's grid (B * KH * head chunks, NS) and threads per block.
    A block serves up to ``max_heads(Dh)`` query heads of its KV head (the
    launcher rounds the group G up to 1, 2, 4 or 8, at most that), so larger
    groups take ceil(G / max_heads) chunks."""
    G = H // KH
    chunks = -(-G // max_heads(Dh))
    return (B * KH * chunks, num_splits(B, KH, S, Dh, dtype)), THREADS


_scratch = {}  # device index -> (float32 workspace, int32 counters), grown on demand


def _workspace(dev: torch.device, n_ws: int, n_counters: int):
    """The split merge's float32 workspace and its zeroed counters, cached
    per device and grown when a call needs more. The kernel leaves every
    counter at 0, so the buffers serve every later launch on the stream."""
    ws, cnt = _scratch.get(dev.index, (None, None))
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros(n_counters, dtype=torch.int32, device=dev)
    _scratch[dev.index] = (ws, cnt)
    return ws, cnt


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
    and v; int32 lengths), non-contiguous tensors or tensors not aligned to
    16 bytes (the kernel's vector loads), a head width outside
    ``HEAD_DIMS``."""
    global launches
    _check(q, k, v, lengths)
    require_sm90(q, "decode_attention")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel's vector loads")
    B, H, Dh = q.shape
    S, KH = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {HEAD_DIMS}")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    scale = scale if scale is not None else Dh ** -0.5
    ns, rows = split_plan(B, KH, S, Dh, q.dtype)
    lib = LIB.load()
    o = torch.empty_like(q)
    ws_ptr = cnt_ptr = None
    if ns > 1:
        ws, cnt = _workspace(q.device, B * H * ns * (Dh + 2), B * H)
        ws_ptr, cnt_ptr = ws.data_ptr(), cnt.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        ws_ptr, cnt_ptr, B, S, H, KH, Dh, DTYPES[q.dtype], ns, rows, int(window),
        float(softcap), float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    launches += 1
    return o

