"""The lanes top-k kernel: the CUDA launch wrapper and its plain version.

``similarity_topk_lanes_blocks(db, valid, q, k)`` scores db [L, N, D] f32
against q [Q, D] f32 and returns, per lane and query, the k best raw dot
scores over the valid rows and their lane-local int32 indices, [L, Q, k]
each. Invalid rows score ``NEG`` (-3e38), the TPU kernel's sentinel; the
caller (``ops._similarity_topk_lanes``) maps it to -inf. Candidates are
ordered by (score desc, index asc), so ties break to the lower index.

The tensor's device decides what runs: a CUDA tensor launches the Hopper
kernel built from ``csrc/similarity_topk_lanes.cu`` (or raises), a CPU
tensor takes ``similarity_topk_lanes_plain``. The CUDA source is compiled
with ``nvcc`` on first use into ``build/`` beside this file and loaded with
``ctypes``; nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

NEG = -3.0e38  # invalid-row sentinel, as in the TPU kernel

_CSRC = Path(__file__).resolve().parent / "csrc" / "similarity_topk_lanes.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

launches = 0  # CUDA launches of this kernel (one per wrapper call on a CUDA tensor)
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the similarity_topk CUDA kernel cannot be built")
    return path


def build() -> Path:
    """Compile the CUDA source into a shared library (once per source
    version; the file name carries the source hash) and return its path."""
    src = _CSRC.read_bytes()
    digest = hashlib.sha1(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _BUILD_DIR / f"libsimilarity_topk_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.similarity_topk_lanes_launch
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.similarity_topk_lanes_tile_rows.argtypes = []
            lib.similarity_topk_lanes_tile_rows.restype = ctypes.c_int
            _lib = lib
        return _lib


def tile_rows() -> int:
    """Bank rows per tile of the CUDA kernel (its ``block_n``)."""
    return int(_load().similarity_topk_lanes_tile_rows())


def _check(db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor, k: int) -> None:
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


def similarity_topk_lanes_plain(
    db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: f32 matmul scores, invalid rows
    at ``NEG``, the top k by a stable descending sort (ties keep the lower
    index). Same signature and result as the CUDA kernel."""
    _check(db, valid, q, k)
    s = torch.matmul(q.unsqueeze(0), db.transpose(1, 2))  # [L, Q, N]
    s = s.masked_fill(~valid[:, None, :], NEG)
    top_s, top_i = torch.sort(s, dim=-1, descending=True, stable=True)
    return top_s[..., :k].contiguous(), top_i[..., :k].to(torch.int32).contiguous()


def similarity_topk_lanes_cuda(
    db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on the current stream (no synchronisation).
    Raises on anything it does not take: another device than an sm_90 card,
    a dtype other than f32/bool, non-contiguous or misaligned tensors."""
    global launches
    _check(db, valid, q, k)
    if db.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {db.device}")
    cap = torch.cuda.get_device_capability(db.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"similarity_topk kernel is built for sm_90a; "
            f"{torch.cuda.get_device_name(db.device)} is sm_{cap[0]}{cap[1]}"
        )
    for name, t in (("db", db), ("valid", valid), ("q", q)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    L, N, D = db.shape
    Q = q.shape[0]
    if D % 4 or db.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("db and q need D % 4 == 0 and 16-byte aligned storage")
    lib = _load()
    tn = int(lib.similarity_topk_lanes_tile_rows())
    if k > tn:
        raise ValueError(f"k={k} exceeds the kernel's tile of {tn} rows")
    nb = (N + tn - 1) // tn
    cand_s = torch.empty((L, Q, nb * k), dtype=torch.float32, device=db.device)
    cand_i = torch.empty((L, Q, nb * k), dtype=torch.int32, device=db.device)
    out_s = torch.empty((L, Q, k), dtype=torch.float32, device=db.device)
    out_i = torch.empty((L, Q, k), dtype=torch.int32, device=db.device)
    stream = torch.cuda.current_stream(db.device).cuda_stream
    err = lib.similarity_topk_lanes_launch(
        db.data_ptr(), valid.data_ptr(), q.data_ptr(), cand_s.data_ptr(),
        cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        L, N, D, Q, k, stream,
    )
    if err != 0:
        raise RuntimeError(f"similarity_topk_lanes launch failed: cudaError {err}")
    launches += 1
    return out_s, out_i


def similarity_topk_lanes_blocks(
    db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """db [L, N, D] f32, valid [L, N] bool, q [Q, D] f32 -> per-lane top-k
    (scores [L, Q, k] f32 with invalid rows at ``NEG``, lane-local idx
    [L, Q, k] int32). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if db.device.type == "cpu":
        return similarity_topk_lanes_plain(db, valid, q, k)
    return similarity_topk_lanes_cuda(db, valid, q, k)
