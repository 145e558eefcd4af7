"""The lanes top-k kernel: the CUDA launch wrapper and its plain version.

``similarity_topk_lanes_blocks(db, valid, q, k, lane_rows=None)`` scores
db [L, N, D] f32 against q [Q, D] f32 and returns, per lane and query, the
k best raw dot scores over the valid rows and their lane-local int32
indices, [L, Q, k] each. Invalid rows score ``NEG`` (-3e38), the TPU
kernel's sentinel; the caller (``ops._similarity_topk_lanes``) maps it to
-inf. Candidates are ordered by (score desc, index asc), so ties break to the
lower index. ``lane_rows`` (one count per lane, N for every lane by default)
says how many rows each lane holds: rows at or past ``lane_rows[l]`` count as
invalid, and the CUDA kernel never reads them.

The tensor's device decides what runs: a CUDA tensor launches the Hopper
kernel built from ``csrc/similarity_topk_lanes.cu`` (or raises), a CPU
tensor takes ``similarity_topk_lanes_plain``. The CUDA source is compiled
on first use by ``repro_torch.kernels.build``; nothing is built when the
module is imported.

``route`` picks the kernel from the shapes alone: the small-Q streaming
kernel (one launch, over ``split_plan``'s blocks) for Q <= ``SMALL_Q`` and
k <= ``KMAX`` where its shared memory fits, the tile kernel otherwise.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.build import CudaLibrary, require_sm90

NEG = -3.0e38  # invalid-row sentinel, as in the TPU kernel

# mirrors of the CUDA source's constants
SMALL_Q = 16  # most queries the streaming kernel takes (``SMALL_Q``)
KMAX = 32  # largest k the streaming kernel takes (``KMAX``)
MARGIN = 2  # candidates kept past k for the exact re-scoring (``MARGIN``)
STREAM_WARPS = 8  # warps per streaming block (``SW``)
MAX_LANES = 64  # lanes one launch takes (``MAX_LANES``)
SMEM_LIMIT = 231424  # dynamic shared memory of a streaming block (``SMEM_LIMIT``)
STAGES = (4, 3, 2)  # ring depths tried, deepest first
SMS = 132  # streaming multiprocessors of an H100 SXM
WAVES = 1  # the streaming grid fills the card once: a block's ring fills its SM
ROW_ALIGN = 32  # a block's rows are whole warp stages (8 warps x 4 rows)
MIN_BLOCK_ROWS = 128  # rows a streaming block reads at least

_CSRC = Path(__file__).resolve().parent / "csrc" / "similarity_topk_lanes.cu"

launches = 0  # CUDA launches of this kernel (one per wrapper call on a CUDA tensor)


def reset_launches() -> None:
    global launches
    launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.similarity_topk_lanes_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.similarity_topk_lanes_tile_rows.argtypes = []
    lib.similarity_topk_lanes_tile_rows.restype = ctypes.c_int
    lib.similarity_topk_lanes_stream_smem.argtypes = [ctypes.c_int] * 4
    lib.similarity_topk_lanes_stream_smem.restype = ctypes.c_int


LIB = CudaLibrary(_CSRC, _declare)


def tile_rows() -> int:
    """Bank rows per tile of the tile kernel (its ``block_n``)."""
    return int(LIB.load().similarity_topk_lanes_tile_rows())


def stream_rows(Q: int) -> int:
    """Rows of a warp's ring stage in the streaming kernel (``stream_rows``)."""
    return 4 if Q <= 8 else 2


def list_len(k: int) -> int:
    """Candidates a streaming list keeps (``list_len``): k and a margin of
    ``MARGIN``, up to ``KMAX``; the k best by exact score are taken from
    them."""
    return min(k + MARGIN, KMAX)


def stream_smem(Q: int, D: int, k: int, ns: int) -> int:
    """Dynamic shared memory of one streaming block (``stream_layout``): the
    warps' mbarriers, (score, idx) lists and rings, and the queries."""
    a128 = lambda x: (x + 127) // 128 * 128  # noqa: E731
    kl = list_len(k)
    ls = a128(STREAM_WARPS * ns * 8)
    li = a128(ls + STREAM_WARPS * Q * kl * 4)
    qs = a128(li + STREAM_WARPS * Q * kl * 4)
    ring = a128(qs + Q * D * 4)
    return ring + STREAM_WARPS * ns * stream_rows(Q) * D * 4


def stream_stages(Q: int, D: int, k: int) -> int:
    """The deepest ring (stages per warp) whose shared memory fits, 0 if
    none does."""
    return next((ns for ns in STAGES if stream_smem(Q, D, k, ns) <= SMEM_LIMIT), 0)


def route(Q: int, D: int, k: int) -> str:
    """``"stream"`` (the small-Q streaming kernel) or ``"tile"``."""
    if Q <= SMALL_Q and k <= KMAX and stream_stages(Q, D, k):
        return "stream"
    return "tile"


@functools.lru_cache(maxsize=64)
def split_plan(lane_rows: Tuple[int, ...]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(rows per block of each lane, first block of each lane + the grid)
    for the streaming kernel, from the shapes alone. Lane l's rows
    [0, lane_rows[l]) split into contiguous runs of ``per[l]`` rows (whole
    ``ROW_ALIGN`` groups, at least ``MIN_BLOCK_ROWS``): blocks
    first[l] .. first[l + 1] - 1, none of them empty. Each lane's share of
    the ``WAVES`` x ``SMS`` blocks follows the rows it holds, so a lane that
    holds few rows takes few blocks."""
    def cdiv(a: int, b: int) -> int:
        return -(-a // b)

    total = sum(lane_rows)
    per, first = [], [0]
    for rows in lane_rows:
        want = max(1, min(round(WAVES * SMS * rows / total), cdiv(rows, MIN_BLOCK_ROWS)))
        p = cdiv(cdiv(rows, want), ROW_ALIGN) * ROW_ALIGN
        per.append(p)
        first.append(first[-1] + cdiv(rows, p))
    return tuple(per), tuple(first)


def _lane_rows(lane_rows: Optional[Sequence[int]], L: int, N: int) -> Tuple[int, ...]:
    rows = (N,) * L if lane_rows is None else tuple(int(r) for r in lane_rows)
    if len(rows) != L or not all(1 <= r <= N for r in rows):
        raise ValueError(f"lane_rows {rows} must hold one count in [1, N={N}] per lane (L={L})")
    return rows


def _check(db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor, k: int,
           lane_rows: Optional[Sequence[int]]) -> Tuple[int, ...]:
    if db.dim() != 3 or valid.shape != db.shape[:2] or q.dim() != 2 or q.shape[1] != db.shape[2]:
        raise ValueError(
            f"shapes: db {tuple(db.shape)}, valid {tuple(valid.shape)}, q {tuple(q.shape)}"
        )
    if db.dtype != torch.float32 or q.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"dtypes: db {db.dtype}, q {q.dtype}, valid {valid.dtype}")
    if not 1 <= k <= db.shape[1]:
        raise ValueError(f"k={k} must be in [1, N={db.shape[1]}]")
    if len({db.device, valid.device, q.device}) != 1:
        raise ValueError(f"devices differ: {db.device}, {valid.device}, {q.device}")
    return _lane_rows(lane_rows, db.shape[0], db.shape[1])


def similarity_topk_lanes_plain(
    db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor, k: int,
    lane_rows: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: f32 matmul scores, invalid rows
    (and rows at or past ``lane_rows``) at ``NEG``, the top k by a stable
    descending sort (ties keep the lower index). Same signature and result
    as the CUDA kernel."""
    rows = _check(db, valid, q, k, lane_rows)
    if lane_rows is not None:
        held = torch.arange(db.shape[1], device=db.device)[None, :] < torch.tensor(
            rows, device=db.device)[:, None]
        valid = valid & held
    s = torch.matmul(q.unsqueeze(0), db.transpose(1, 2))  # [L, Q, N]
    s = s.masked_fill(~valid[:, None, :], NEG)
    top_s, top_i = torch.sort(s, dim=-1, descending=True, stable=True)
    return top_s[..., :k].contiguous(), top_i[..., :k].to(torch.int32).contiguous()


_scratch = {}  # device index -> (float32 workspace, int32 workspace, int32 counters)


def _workspace(dev: torch.device, n: int):
    """The candidates' workspace (n scores, n indices) and the streaming
    kernel's per-lane counters, cached per device and grown on demand. The
    kernel leaves every counter at 0, so the buffers serve every later
    launch on the stream."""
    ws_s, ws_i, cnt = _scratch.get(dev.index, (None, None, None))
    if ws_s is None or ws_s.numel() < n:
        ws_s = torch.empty(n, dtype=torch.float32, device=dev)
        ws_i = torch.empty(n, dtype=torch.int32, device=dev)
    if cnt is None:
        cnt = torch.zeros(MAX_LANES, dtype=torch.int32, device=dev)
    _scratch[dev.index] = (ws_s, ws_i, cnt)
    return ws_s, ws_i, cnt


@functools.lru_cache(maxsize=64)
def _c_ints(vals: Tuple[int, ...]):
    return (ctypes.c_int * len(vals))(*vals)


def similarity_topk_lanes_cuda(
    db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor, k: int,
    lane_rows: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on the current stream (no synchronisation).
    Raises, launching nothing, on anything it does not take: another device
    than an sm_90 card, a dtype other than f32/bool, non-contiguous tensors,
    db or q not 16-byte aligned (the kernel's vector loads and bulk copies),
    D % 4 != 0, more than ``MAX_LANES`` lanes, ``lane_rows`` outside
    [1, N], k above the tile kernel's ``tile_rows()`` (128)."""
    global launches
    rows = _check(db, valid, q, k, lane_rows)
    require_sm90(db, "similarity_topk")
    for name, t in (("db", db), ("valid", valid), ("q", q)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    L, N, D = db.shape
    Q = q.shape[0]
    if D % 4 or db.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("db and q need D % 4 == 0 and 16-byte aligned storage")
    if L > MAX_LANES or Q < 1:
        raise ValueError(f"the kernel takes 1..{MAX_LANES} lanes and Q >= 1, got L={L} Q={Q}")
    lib = LIB.load()
    path = route(Q, D, k)
    if path == "stream":
        per, first = split_plan(rows)
        ns = stream_stages(Q, D, k)
        n_ws = first[-1] * Q * list_len(k)
    else:
        tn = int(lib.similarity_topk_lanes_tile_rows())
        if k > tn:
            raise ValueError(f"k={k} exceeds the tile kernel's {tn} rows")
        per = first = None
        ns = 0
        n_ws = L * Q * -(-N // tn) * k
    ws_s, ws_i, cnt = _workspace(db.device, n_ws)
    out = torch.empty((2, L, Q, k), dtype=torch.int32, device=db.device)
    out_s, out_i = out[0].view(torch.float32), out[1]
    stream = torch.cuda.current_stream(db.device).cuda_stream
    err = lib.similarity_topk_lanes_launch(
        db.data_ptr(), valid.data_ptr(), q.data_ptr(), ws_s.data_ptr(), ws_i.data_ptr(),
        cnt.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), L, N, D, Q, k, _c_ints(rows),
        None if per is None else _c_ints(per), None if first is None else _c_ints(first),
        0 if path == "stream" else 1, ns, stream,
    )
    if err != 0:
        raise RuntimeError(f"similarity_topk_lanes launch failed: cudaError {err}")
    launches += 1
    return out_s, out_i


def similarity_topk_lanes_blocks(
    db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor, k: int,
    lane_rows: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """db [L, N, D] f32, valid [L, N] bool, q [Q, D] f32 -> per-lane top-k
    (scores [L, Q, k] f32 with invalid rows at ``NEG``, lane-local idx
    [L, Q, k] int32), rows at or past ``lane_rows[l]`` invalid. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    if db.device.type == "cpu":
        return similarity_topk_lanes_plain(db, valid, q, k, lane_rows)
    return similarity_topk_lanes_cuda(db, valid, q, k, lane_rows)
