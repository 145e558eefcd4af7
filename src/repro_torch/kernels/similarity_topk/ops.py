"""Public wrappers for the fused multi-lane similarity + top-k lookup and
its single-store form.

``similarity_topk_lanes`` scores a whole StoreBank, db [L, N, D], against
q [Q, D] and returns (scores [Q, L, k], lane-local idx [Q, L, k]): every
hierarchy level / lane in ONE kernel launch. The tensor's device picks the
Hopper kernel (CUDA) or its plain version (CPU) — see ``kernel.py``.

The wrapper keeps the reference's semantics: per-lane metric tags (cosine /
dot), with cosine handled by unit-normalizing both sides, and mixed
cosine/dot banks scored as raw dots against unit cosine rows and then
rescaled by 1/|q| on the cosine lanes (a positive per-query scale, so
rankings and indices are exact); the invalid-row sentinel maps to -inf.
The kernel masks the ragged N edge itself, so nothing is padded here.

Each call counts a host-level dispatch (``dispatch_count`` /
``reset_dispatch_count``); the CUDA launches are counted separately by
``kernel.launches``, and those made through the single-store form by
``single_store_launches`` as well.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels.similarity_topk import kernel as _kernel

_dispatches = 0  # host-level wrapper calls (fused reads + lane searches)
single_store_launches = 0  # lanes-kernel launches made by ``similarity_topk`` (B2)

TopK = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def record_dispatch(n: int = 1) -> None:
    """Count a dispatch issued outside the public wrappers (the read path
    calls the semantics wrapper below)."""
    global _dispatches
    _dispatches += n


def dispatch_count() -> int:
    return _dispatches


def reset_dispatch_count() -> None:
    global _dispatches
    _dispatches = 0


def reset_single_store_launches() -> None:
    global single_store_launches
    single_store_launches = 0


def default_block_n() -> int:
    """The tile kernel's row tile: ``TN`` in the CUDA source, read without
    building anything (``kernel.tile_rows()`` reports the built library's
    value). It is a compile-time constant of the kernel, so unlike the TPU
    wrapper there is no environment override; the kernel masks the ragged
    edge of a lane whose N is not a multiple of it. The streaming kernel
    (small Q) splits rows by ``kernel.split_plan`` instead."""
    for line in _kernel._CSRC.read_text().splitlines():
        if line.startswith("constexpr int TN ="):
            return int(line.split("=")[1].split(";")[0])
    raise RuntimeError("TN not found in the similarity_topk CUDA source")


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-9)


def _similarity_topk_lanes(db, valid, q, *, k: int, metric: Tuple[str, ...],
                           prenormalized: bool, topk: TopK = None,
                           lane_rows: Optional[Sequence[int]] = None):
    """db [L, N, D] f32, valid [L, N] bool, q [Q, D] -> ([Q, L, k], [Q, L, k]).

    Lane indices are lane-local (0..N); candidates are never merged across
    lanes. ``metric`` is a per-lane tuple (a 1-tuple broadcasts). Uniform
    cosine banks normalize q (and db unless ``prenormalized``); mixed
    cosine/dot banks need ``prenormalized=True`` (unit cosine rows, the
    StoreBank insert invariant) and rescale cosine lanes by 1/|q| after the
    kernel. ``topk`` is the per-lane top-k core, by default
    ``kernel.similarity_topk_lanes_blocks`` (device-dispatched); a caller
    may pass ``kernel.similarity_topk_lanes_plain`` to recompute a result
    with the plain version on the same tensors. ``lane_rows`` (one count per
    lane, like ``prenormalized`` an argument the reference lacks) says how
    many rows each lane holds: rows at or past it count as invalid and the
    kernel never reads them. Callers pass the bank's capacities, past which
    no row is ever valid, so results do not change."""
    L = db.shape[0]
    metrics = tuple(metric) if len(metric) > 1 else tuple(metric) * L
    bad = [m for m in metrics if m not in ("cosine", "dot")]
    if bad:
        raise ValueError(f"kernel path supports cosine/dot; got {bad!r}")
    mixed = len(set(metrics)) > 1
    q = q.to(torch.float32)
    cos_scale = None
    if mixed:
        if not prenormalized:
            raise ValueError("mixed-metric lanes require prenormalized (unit) cosine rows")
        # raw q against unit cosine rows: dot / |q| == cosine; dot lanes raw
        cos_scale = 1.0 / torch.clamp(torch.linalg.vector_norm(q, dim=-1), min=1e-9)
    elif metrics[0] == "cosine":
        if not prenormalized:
            db = _normalize(db.to(torch.float32))
        q = _normalize(q)
    topk = _kernel.similarity_topk_lanes_blocks if topk is None else topk
    s, i = topk(db.contiguous(), valid.contiguous(), q.contiguous(), k,
                lane_rows=lane_rows)  # [L, Q, k]
    s = torch.where(s <= -1.0e38, torch.full_like(s, float("-inf")), s)
    s = s.transpose(0, 1)  # [Q, L, k]
    i = i.transpose(0, 1)
    if cos_scale is not None:
        is_cos = torch.tensor([m == "cosine" for m in metrics], device=s.device)
        s = torch.where(is_cos[None, :, None], s * cos_scale[:, None, None], s)
    return s, i


def similarity_topk_lanes(db, valid, q, *, k: int,
                          metric: Union[str, Tuple[str, ...]] = "cosine",
                          prenormalized: bool = False,
                          lane_rows: Optional[Sequence[int]] = None):
    """Fused multi-lane lookup: db [L, N, D], valid [L, N], q [Q, D] ->
    (scores [Q, L, k], lane-local idx [Q, L, k]) in ONE kernel launch.
    ``metric`` may be one name for every lane or a per-lane tuple;
    ``lane_rows`` as in ``_similarity_topk_lanes``."""
    record_dispatch()
    metrics = (metric,) if isinstance(metric, str) else tuple(metric)
    return _similarity_topk_lanes(db, valid, q, k=k, metric=metrics,
                                  prenormalized=prenormalized, lane_rows=lane_rows)


def similarity_topk(db, valid, q, *, k: int, metric: str = "cosine",
                    prenormalized: bool = False):
    """Single-store lookup (the reference's ``similarity_topk``, kernel B2):
    db [N, D], valid [N] bool, q [Q, D] -> (scores [Q, k], idx [Q, k]),
    invalid rows at -inf. The store is one lane of the lanes kernel: a CUDA
    tensor launches it with L = 1. ``prenormalized=True`` (unit cosine rows,
    the StoreBank insert invariant) skips normalizing ``db``; the reference
    has no such argument. ``StoreBank.search_lane`` reads a store this way."""
    global single_store_launches
    record_dispatch()
    s, i = _similarity_topk_lanes(db.to(torch.float32)[None], valid[None], q, k=k,
                                  metric=(metric,), prenormalized=prenormalized)
    if db.is_cuda:
        single_store_launches += 1
    return s[:, 0], i[:, 0]
