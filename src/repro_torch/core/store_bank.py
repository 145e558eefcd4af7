"""StoreBank: one device-resident [L, cap, D] buffer for many vector stores.

Every *lane* — a hierarchy level (private L1 / shared L2 / peers) — is a
row of a single [L, cap, D] float32 tensor with a [L, cap] validity mask,
so a B-query lookup across the whole hierarchy is ONE fused top-k launch:

    [L, cap, D] x [B, D] -> scores [B, L, k], lane-local idx [B, L, k]

``InMemoryVectorStore`` is a thin lane view over a bank: it keeps its
public add/search/remove API and host-side entry metadata, while the
device tensors, the per-lane recency/frequency/insertion counters and the
search live here. A standalone store is a 1-lane bank; ``StoreBank.adopt``
stacks live stores into a shared bank (repointing each store's lane view).

All tensors of a bank live on one explicit device. The eviction counters
``d_last_access`` (a logical event tick), ``d_access_count`` and
``d_insert_seq`` are [L, cap] int32 device tensors; touches and insert-time
resets update them IN PLACE (the reference donates its buffers to a jitted
scatter; here the same effect is a direct in-place write). Host code reads
them through a lazily-synced numpy mirror (``last_access`` /
``access_count`` / ``insert_seq``), which only pays a device->host copy
after a fused read touched counters on device.

Cosine lanes keep unit rows (normalized at insert), so searches never
re-normalize the bank. Search backends: plain torch scores (``_dots``) + a stable sort,
or the ``similarity_topk`` lanes kernel (``use_pallas=True``, the name kept
from the reference: "search through the kernel wrapper"). The kernel path is
opt-in and off by default, as in the reference; the serving test and
``chip_smoke.py`` turn it on.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import (
    DeviceLike, fetch, resolve_device, stage_pinned, to_device,
)

_KERNEL_METRICS = ("cosine", "dot")  # metrics the kernel path covers
_INT32_MIN = np.iinfo(np.int32).min
# device dtype of each pending-insert column (``StoreBank._pending_columns``)
_COLUMN_DTYPES = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
                  np.dtype(np.float32): torch.float32}
# renumber the logical event clock well before int32 saturates (headroom for
# one batch worth of ticks past the check)
_TICK_COMPACT_AT = np.iinfo(np.int32).max - (1 << 20)
# lifecycle epoch: created/expires stamps are float seconds RELATIVE to this
# process-wide origin, so every bank in the process shares one time base
# (adoption copies stamps verbatim) and the device float32 copies keep
# sub-second precision over any realistic process lifetime. Snapshots persist
# absolute times and re-base on load.
_EPOCH = time.time()


def bucket_len(n: int) -> int:
    """The next power-of-two length >= n (>= 1): the query-batch bucket of
    the read path (the kernel sees power-of-two Q, as in the reference)."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


def pad_to_bucket(rows: np.ndarray) -> Tuple[np.ndarray, int]:
    """Zero-pad a [N, D] block to the next power-of-two row bucket; returns
    the padded block and the original N."""
    n = rows.shape[0]
    bucket = bucket_len(n)
    if bucket > n:
        rows = np.concatenate(
            [rows, np.zeros((bucket - n, *rows.shape[1:]), rows.dtype)]
        )
    return rows, n


def prepare_scatter(
    idxs: List[int], rows: np.ndarray, *extras: np.ndarray
) -> Tuple[np.ndarray, ...]:
    """Build the (rows, idxs, *extras) update for a multi-row scatter.

    Deduplicates repeated slots last-write-wins (a batch that wraps capacity
    may pick the same victim twice; the order in which a device scatter
    applies conflicting writes is not defined, the sequential loop's is).
    ``extras`` are per-row arrays deduped in lockstep. Eager torch compiles
    nothing per shape, so unlike the reference the result is not padded to
    a bucket."""
    slot_to_row: Dict[int, int] = {}
    for j, idx in enumerate(idxs):
        slot_to_row[idx] = j
    out_idx = np.fromiter(slot_to_row.keys(), np.int64, len(slot_to_row))
    keep = np.fromiter(slot_to_row.values(), np.int64, len(slot_to_row))
    return (rows[keep], out_idx, *[np.asarray(e)[keep] for e in extras])


def select_victim(
    eviction: str,
    last_access: np.ndarray,
    access_count: np.ndarray,
    insert_seq: np.ndarray,
) -> int:
    """Pick the slot an lru/lfu/fifo policy evicts (flat index into the
    given counter views)."""
    if eviction == "fifo":
        return int(np.argmin(insert_seq))
    if eviction == "lfu":
        return int(np.argmin(access_count))
    return int(np.argmin(last_access))


def _normalize_rows(rows: torch.Tensor) -> torch.Tensor:
    return rows / torch.clamp(torch.linalg.vector_norm(rows, dim=-1, keepdim=True), min=1e-9)


# -- in-place device updates (the reference's donated scatters) --------------


# repro: device-region static[lane, normalize]
def _bank_scatter(bank: "StoreBank", lane: int, idxs: torch.Tensor, rows: torch.Tensor,
                  counters: tuple, *, normalize: bool) -> None:
    """Row scatter with the insert-time counter AND lifecycle resets, all in
    place: rows, masks, last_access/access_count/insert_seq and
    created/expires for the claimed slots (slots deduped host-side).
    ``c_cnts`` is 0 for a fresh insert and the preserved count for a tier-1
    promotion restoring a demoted entry."""
    if normalize:
        rows = _normalize_rows(rows)
    bank.buf[lane, idxs] = rows
    bank.valid[lane, idxs] = True
    _bank_counter_set(bank, *counters)


def upload_columns(cols: Tuple[np.ndarray, ...], device: torch.device) -> tuple:
    """Host pending-insert columns (``StoreBank._pending_columns``) as
    device scatter tensors."""
    return tuple(to_device(a, device, _COLUMN_DTYPES[a.dtype]) for a in cols)


def _bank_counter_set(bank: "StoreBank", c_lanes, c_idxs, c_ticks, c_seqs, c_cnts,
                      c_created, c_expires) -> None:  # repro: device-region
    if c_lanes.numel() == 0:
        return
    at = (c_lanes, c_idxs)
    bank.d_last_access.index_put_(at, c_ticks)
    bank.d_access_count.index_put_(at, c_cnts)
    bank.d_insert_seq.index_put_(at, c_seqs)
    bank.d_created.index_put_(at, c_created)
    bank.d_expires.index_put_(at, c_expires)


# repro: device-region
def _bank_free(bank: "StoreBank", lanes: torch.Tensor, idxs: torch.Tensor) -> None:
    """Freed-slot hygiene in one in-place update: validity AND the slot's
    whole metadata row reset, so a recycled slot is indistinguishable from
    a never-used one."""
    at = (lanes, idxs)
    bank.valid[at] = False
    bank.d_last_access[at] = 0
    bank.d_access_count[at] = 0
    bank.d_insert_seq[at] = 0
    bank.d_created[at] = 0.0
    bank.d_expires[at] = float("inf")


# repro: device-region static[tick]
def _bank_touch(last: torch.Tensor, cnt: torch.Tensor, lanes: torch.Tensor,
                idxs: torch.Tensor, weights: torch.Tensor, tick: int) -> None:
    """Batched recency/frequency bump for N (lane, idx) touches, in place.
    Duplicate pairs ADD in ``access_count`` (``index_put_`` with
    accumulate) and take the MAX in ``last_access`` (``scatter_reduce_``
    amax on the flat ``lane * cap + idx``) — one stamp per touch event.
    ``weights`` is 1 per real touch and 0 for a masked one."""
    cnt.index_put_((lanes, idxs), weights, accumulate=True)
    stamp = torch.full_like(weights, _INT32_MIN).masked_fill_(weights > 0, tick)
    flat = lanes.to(torch.int64) * last.shape[1] + idxs.to(torch.int64)
    last.view(-1).scatter_reduce_(0, flat, stamp, "amax", include_self=True)


# floats of one chunk's [.., Q, n, D] product in the CPU's row-wise scoring
_CPU_SCORE_CHUNK = 1 << 22


def _dots(db: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """db [.., N, D] . q [Q, D] -> [.., Q, N]. On the CPU each score is the
    sum of one row-wise product, taken in the same order whatever Q and
    chunked over N: a CPU matmul's summation order depends on Q, so one
    query alone (``lookup``) and in a batch (``lookup_batch``) could score
    an ulp apart and decide apart on a threshold. On the card it is
    ``torch.matmul``, whose order the kernel's finalist re-score keeps."""
    if db.device.type != "cpu":
        return torch.matmul(q, db.transpose(-1, -2))
    rows = int(np.prod(db.shape[:-2], dtype=np.int64)) * q.shape[0] * db.shape[-1]
    n = max(1, _CPU_SCORE_CHUNK // max(rows, 1))
    parts = [(db[..., None, s:s + n, :] * q[:, None, :]).sum(-1)
             for s in range(0, db.shape[-2], n)]
    return torch.cat(parts, -1) if parts else db.new_zeros(db.shape[:-2] + (q.shape[0], 0))


def _lane_scores(db, q, metric: str, prenormalized: bool):
    """db [.., N, D] x q [Q, D] -> scores [.., Q, N] (higher = more similar)."""
    q = q.to(torch.float32)
    db = db.to(torch.float32)
    if metric == "cosine":
        if not prenormalized:
            db = _normalize_rows(db)
        return _dots(db, _normalize_rows(q))
    if metric == "dot":
        return _dots(db, q)
    if metric == "euclidean":
        d2 = (
            (q * q).sum(-1)[:, None]
            - 2 * _dots(db, q)
            + (db * db).sum(-1)[..., None, :]
        )
        return -torch.sqrt(torch.clamp(d2, min=0.0))
    raise ValueError(f"unknown metric {metric!r}")


def _topk_desc(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis by a stable descending sort (ties keep the
    lower index, as ``lax.top_k`` does; ``torch.topk`` promises no tie
    order)."""
    ts, ti = torch.sort(s, dim=-1, descending=True, stable=True)
    return ts[..., :k], ti[..., :k]


# repro: device-region static[k, metrics, prenorm]
def fused_search_body(buf, valid, q, k: int, metrics: tuple, prenorm: tuple):
    """The plain fused all-lanes search, shared by ``search_lanes`` and the
    read path (repro_torch.core.read_path): buf [L, cap, D], valid [L, cap],
    q [Q, D] -> ([Q, L, k], [Q, L, k]). Uniform-metric banks score all lanes
    in one batched matmul; mixed-metric banks score each lane under its own
    metric tag."""
    if len(set(metrics)) == 1:
        s = _lane_scores(buf, q, metrics[0], all(prenorm))  # [L, Q, cap]
    else:
        s = torch.stack([
            _lane_scores(buf[li], q, metrics[li], prenorm[li])
            for li in range(len(metrics))
        ])
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    ts, ti = _topk_desc(s, k)  # [L, Q, k]
    return ts.transpose(0, 1), ti.transpose(0, 1)


class StoreBank:
    """Device-resident multi-lane store: stacked [L, cap, D] rows + masks +
    per-lane device eviction counters + the fused search.

    The kernel search path is opt-in (``use_pallas=False`` by default, as in
    the reference); ``chip_smoke.py`` and the serving parity test run it on.
    """

    def __init__(
        self,
        dim: int,
        capacities: Sequence[int],
        *,
        metric="cosine",  # one metric for every lane, or a per-lane sequence
        use_pallas: bool = False,
        device: DeviceLike = None,
    ):
        self.dim = dim
        self.use_pallas = use_pallas
        self.device = resolve_device(device)
        self.capacities = list(capacities)
        self.L = len(self.capacities)
        self.cap = max(self.capacities)
        if isinstance(metric, str):
            self.metrics: Tuple[str, ...] = (metric,) * self.L
        else:
            self.metrics = tuple(metric)
            if len(self.metrics) != self.L:
                raise ValueError(f"{len(self.metrics)} metrics for {self.L} lanes")
        # cosine lanes hold unit rows: normalize once at insert, never at search
        self.prenorm: Tuple[bool, ...] = tuple(m == "cosine" for m in self.metrics)
        shape = (self.L, self.cap)
        self._alloc_device(shape)
        self._mirror: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = (
            np.zeros(shape, np.int32), np.zeros(shape, np.int32), np.zeros(shape, np.int32),
        )
        # entry lifecycle: the float64 host arrays of the created/expires
        # stamps are the source of truth (lifecycle only changes on
        # host-initiated paths); their device float32 copies are d_created
        # and d_expires
        self.h_created = np.zeros(shape, np.float64)
        self.h_expires = np.full(shape, np.inf, np.float64)
        # per-lane staleness weight: an aging entry's effective score drops by
        # w * age_fraction (0 at insert -> w at expiry). 0 = scoring unchanged.
        self.staleness_w = np.zeros(self.L, np.float32)
        self._d_stale: Optional[torch.Tensor] = None  # device cache of staleness_w
        self._ttl_live = False  # any finite expiry ever installed
        self._tick = 1  # 0 = never touched/inserted
        # insert-time counter updates awaiting the next row scatter
        self._pending: List[Tuple[int, int, int, int, int, float, float]] = []
        self.dispatches = 0  # fused/device search dispatches issued by this bank
        self.counter_scatters = 0  # standalone counter scatters (non-fused paths)
        self.free_scatters = 0  # slot-free updates (remove/clear; off the read path)
        self.host_hops = 0  # host<->device data hops on the search path

    def _alloc_device(self, shape: Tuple[int, int]) -> None:
        """The device tensors: rows, masks, counters and lifecycle stamps."""
        dev = self.device
        self.buf = torch.zeros((*shape, self.dim), dtype=torch.float32, device=dev)
        self.valid = torch.zeros(shape, dtype=torch.bool, device=dev)
        # per-lane recency/frequency/insertion counters: DEVICE tensors.
        # last_access holds logical event ticks, one tick per touch event
        self.d_last_access = torch.zeros(shape, dtype=torch.int32, device=dev)
        self.d_access_count = torch.zeros(shape, dtype=torch.int32, device=dev)
        self.d_insert_seq = torch.zeros(shape, dtype=torch.int32, device=dev)
        # created/expires stamps (seconds relative to the process _EPOCH),
        # for the fused read's expiry mask + staleness penalty
        self.d_created = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.d_expires = torch.full(shape, float("inf"), dtype=torch.float32, device=dev)

    # -- metric helpers --------------------------------------------------------

    @property
    def metric(self) -> str:
        """Uniform metric name, or "mixed" for per-lane-tagged banks."""
        return self.metrics[0] if len(set(self.metrics)) == 1 else "mixed"

    @property
    def prenormalized(self) -> bool:
        return all(self.prenorm)

    def _kernel_ok(self) -> bool:
        return all(m in _KERNEL_METRICS for m in self.metrics)

    def _to_dev(self, a, dtype: torch.dtype) -> torch.Tensor:
        return to_device(a, self.device, dtype)

    # -- entry lifecycle (TTL/expiry + staleness) ------------------------------

    @staticmethod
    def rel_now() -> float:
        """Current time on the bank's relative clock (seconds since _EPOCH)."""
        return time.time() - _EPOCH

    @staticmethod
    def to_rel(abs_time: float) -> float:
        return abs_time - _EPOCH if np.isfinite(abs_time) else float("inf")

    @staticmethod
    def to_abs(rel_time: float) -> float:
        return rel_time + _EPOCH if np.isfinite(rel_time) else float("inf")

    def lifecycle_active(self) -> bool:
        """True once any entry carries a finite TTL or any lane scores with a
        staleness penalty — the read paths skip all lifecycle math until
        then, so TTL-free deployments pay nothing."""
        return self._ttl_live or bool((self.staleness_w != 0).any())

    def set_staleness(self, lane: int, weight: float) -> None:
        self.staleness_w[lane] = np.float32(weight)
        self._d_stale = None

    def d_staleness(self) -> torch.Tensor:
        if self._d_stale is None:
            self._d_stale = self._to_dev(self.staleness_w, torch.float32)
        return self._d_stale

    def set_lifecycle(self, created_rel: np.ndarray, expires_rel: np.ndarray) -> None:
        """Install full lifecycle arrays (adoption / snapshot load), in the
        relative-seconds representation."""
        self.h_created = np.asarray(created_rel, np.float64).copy()
        self.h_expires = np.asarray(expires_rel, np.float64).copy()
        self.d_created = self._to_dev(self.h_created.astype(np.float32), torch.float32)
        self.d_expires = self._to_dev(self.h_expires.astype(np.float32), torch.float32)
        if np.isfinite(self.h_expires).any():
            self._ttl_live = True

    def lifecycle_rescore(
        self, scores: np.ndarray, lanes, idx: np.ndarray, now: Optional[float] = None
    ) -> Optional[np.ndarray]:
        """Host-side expiry mask + staleness penalty for the non-fused search
        paths (the fused read applies the same rule on device): expired
        candidates drop to -inf, live TTL'd candidates lose
        ``w[lane] * clip(age / ttl, 0, 1)``. Returns the effective scores
        (same shape; the caller re-sorts), or None when no lifecycle state
        is active."""
        if not self.lifecycle_active():
            return None
        now = self.rel_now() if now is None else now
        lanes = np.broadcast_to(np.asarray(lanes, np.int64), idx.shape)
        c = self.h_created[lanes, idx]
        e = self.h_expires[lanes, idx]
        s = np.asarray(scores, np.float32).copy()
        finite = np.isfinite(s)
        expired = finite & (e <= now)
        aging = finite & ~expired & np.isfinite(e)
        if aging.any():
            frac = np.clip(
                (now - c[aging]) / np.maximum(e[aging] - c[aging], 1e-6), 0.0, 1.0
            )
            s[aging] -= (self.staleness_w[lanes[aging]] * frac).astype(np.float32)
        s[expired] = -np.inf
        return s

    @staticmethod
    def resort_desc(s: np.ndarray, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Re-establish descending score order after lifecycle rescoring;
        stable, so untouched rows keep their original top-k order."""
        order = np.argsort(-s, axis=-1, kind="stable")
        return np.take_along_axis(s, order, -1), np.take_along_axis(idx, order, -1)

    # -- counters: device truth + lazily-synced host mirror --------------------

    def next_tick(self) -> int:
        if self._tick >= _TICK_COMPACT_AT:
            self._compact_ticks()
        t = self._tick
        self._tick += 1
        return t

    def _compact_ticks(self) -> None:
        """Renumber last_access ticks densely (order- and tie-preserving
        rank transform) before the int32 event clock saturates."""
        self.flush_pending()
        last, cnt, seq = self.counters_host()
        ranks = np.unique(last, return_inverse=True)[1]
        self.set_counters(ranks.reshape(last.shape).astype(np.int32), cnt, seq)
        self._tick = int(ranks.max(initial=0)) + 1

    def counters_host(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host view of the device counters (synced on demand; only a fused
        read invalidates it). A clean mirror already reflects pending insert
        claims, so no flush happens here; only a dirty mirror forces the
        pending flush + device copy."""
        if self._mirror is None:
            self.flush_pending()
            last, cnt, seq = fetch(self.d_last_access, self.d_access_count, self.d_insert_seq)
            # copies: the mirror takes in-place updates from note_insert/touch_slots
            self._mirror = (last.copy(), cnt.copy(), seq.copy())
        return self._mirror

    @property
    def last_access(self) -> np.ndarray:
        return self.counters_host()[0]

    @property
    def access_count(self) -> np.ndarray:
        return self.counters_host()[1]

    @property
    def insert_seq(self) -> np.ndarray:
        return self.counters_host()[2]

    def mark_counters_dirty(self) -> None:
        """A fused read updated the device counters in place; the host
        mirror goes stale."""
        self._mirror = None

    def set_counters(self, last: np.ndarray, cnt: np.ndarray, seq: np.ndarray) -> None:
        """Install full counter arrays (adoption / snapshot load)."""
        last = np.asarray(last, np.int32)
        cnt = np.asarray(cnt, np.int32)
        seq = np.asarray(seq, np.int32)
        self.d_last_access = self._to_dev(last, torch.int32)
        self.d_access_count = self._to_dev(cnt, torch.int32)
        self.d_insert_seq = self._to_dev(seq, torch.int32)
        self._mirror = (last.copy(), cnt.copy(), seq.copy())
        self._tick = max(self._tick, int(last.max(initial=0)) + 1)

    def note_insert(
        self,
        lane: int,
        idx: int,
        seq: int,
        *,
        created: Optional[float] = None,
        expires: Optional[float] = None,
        count: int = 0,
    ) -> None:
        """Counter + lifecycle bookkeeping for one claimed slot. The device
        update is deferred into the next row scatter; the host mirror (when
        clean) and the host lifecycle arrays update immediately so victim
        selection inside the same add_batch sees earlier claims."""
        tick = self.next_tick()
        created = self.rel_now() if created is None else float(created)
        expires = float("inf") if expires is None else float(expires)
        if np.isfinite(expires):
            self._ttl_live = True
        if self._mirror is not None:
            ml, mc, ms = self._mirror
            ml[lane, idx] = tick
            mc[lane, idx] = count
            ms[lane, idx] = seq
        self.h_created[lane, idx] = created
        self.h_expires[lane, idx] = expires
        self._pending.append((lane, idx, tick, seq, count, created, expires))

    def _pending_columns(self) -> Tuple[np.ndarray, ...]:
        """Pending insert-counter updates as host columns (lanes, idxs,
        ticks, seqs, counts, created, expires), last-wins dedupe per slot;
        the pending list is emptied."""
        last_wins: Dict[Tuple[int, int], Tuple[int, int, int, float, float]] = {}
        for lane, idx, tick, seq, count, created, expires in self._pending:
            last_wins[(lane, idx)] = (tick, seq, count, created, expires)
        self._pending.clear()
        n = len(last_wins)
        keys = list(last_wins)
        vals = list(last_wins.values())
        return (
            np.fromiter((k[0] for k in keys), np.int64, n),
            np.fromiter((k[1] for k in keys), np.int64, n),
            np.fromiter((v[0] for v in vals), np.int32, n),
            np.fromiter((v[1] for v in vals), np.int32, n),
            np.fromiter((v[2] for v in vals), np.int32, n),
            np.fromiter((v[3] for v in vals), np.float32, n),
            np.fromiter((v[4] for v in vals), np.float32, n),
        )

    def _drain_pending(self) -> tuple:
        """Pending insert-counter updates as device scatter tensors
        (last-wins dedupe per slot)."""
        return upload_columns(self._pending_columns(), self.device)

    def flush_pending(self) -> None:
        """Push deferred insert-counter updates to device (normally they ride
        the row scatter; this standalone path is a safety net for callers
        that read counters between a claim and its ``set_rows``)."""
        if not self._pending:
            return
        cols = self._pending_columns()
        self.counter_scatters += 1
        self._device_counter_set(cols)

    # -- device hooks (a sharded bank splits each update by position) ----------

    def _device_counter_set(self, cols: Tuple[np.ndarray, ...]) -> None:
        _bank_counter_set(self, *upload_columns(cols, self.device))

    def _device_touch(self, lanes: np.ndarray, idxs: np.ndarray, tick: int) -> None:
        _bank_touch(
            self.d_last_access, self.d_access_count,
            self._to_dev(lanes, torch.int64), self._to_dev(idxs, torch.int64),
            torch.ones(lanes.size, dtype=torch.int32, device=self.device), tick,
        )

    def _device_free(self, lanes: np.ndarray, idxs: np.ndarray) -> None:
        _bank_free(self, self._to_dev(lanes, torch.int64), self._to_dev(idxs, torch.int64))

    def touch_slots(self, lanes, idxs) -> None:
        """Bump recency/frequency for N (lane, idx) pairs in ONE in-place
        device update (one shared tick per call). Duplicate pairs accumulate
        one count each. Keeps the host mirror in sync when it is clean."""
        lanes = np.asarray(lanes, np.int64).reshape(-1)
        idxs = np.asarray(idxs, np.int64).reshape(-1)
        if lanes.size == 0:
            return
        tick = self.next_tick()
        if self._mirror is not None:
            ml, mc, _ = self._mirror
            ml[lanes, idxs] = tick
            np.add.at(mc, (lanes, idxs), 1)
        self.counter_scatters += 1
        self._device_touch(lanes, idxs, tick)

    # -- device updates --------------------------------------------------------

    def set_rows(self, lane: int, idxs: List[int], rows: np.ndarray,
                 *, pinned: bool = False) -> None:
        """Scatter N raw rows into one lane (ONE in-place device update that
        also applies the pending insert-counter/lifecycle resets; rows are
        unit-normalized on device for cosine lanes). ``pinned=True`` stages
        the row block through pinned host memory on a CUDA bank (tier-1
        promotions overlap their copy with the read they ride beside)."""
        sel, scatter_idx = prepare_scatter(idxs, np.asarray(rows, np.float32))
        if pinned:
            rows_d = stage_pinned(sel, self.device).to(self.device, non_blocking=True)
        else:
            rows_d = self._to_dev(sel, torch.float32)
        _bank_scatter(
            self, lane, self._to_dev(scatter_idx, torch.int64), rows_d,
            self._drain_pending(), normalize=self.prenorm[lane],
        )

    def invalidate(self, lane: int, idx: int) -> None:
        self.free_slots([lane], [idx])

    def free_slots(self, lanes, idxs) -> None:
        """Free N (lane, idx) slots in ONE in-place update, resetting the
        whole metadata row (validity, recency/frequency/insertion counters,
        created/expires)."""
        lanes = np.asarray(lanes, np.int64).reshape(-1)
        idxs = np.asarray(idxs, np.int64).reshape(-1)
        if lanes.size == 0:
            return
        # drop any pending insert for a slot freed before its row scatter
        if self._pending:
            freed = set(zip(lanes.tolist(), idxs.tolist()))
            self._pending = [p for p in self._pending if (p[0], p[1]) not in freed]
        if self._mirror is not None:
            ml, mc, ms = self._mirror
            ml[lanes, idxs] = 0
            mc[lanes, idxs] = 0
            ms[lanes, idxs] = 0
        self.h_created[lanes, idxs] = 0.0
        self.h_expires[lanes, idxs] = np.inf
        self.free_scatters += 1
        self._device_free(lanes, idxs)

    def compact_seqs(self) -> int:
        """Rank-rebase the insert_seq counters before the int32 insertion
        clock saturates (order- and tie-preserving, applied bank-wide).
        Returns the next free sequence number for the calling store."""
        self.flush_pending()
        last, cnt, seq = self.counters_host()
        ranks = np.unique(seq, return_inverse=True)[1].reshape(seq.shape)
        self.set_counters(last, cnt, ranks.astype(np.int32))
        return int(ranks.max(initial=0)) + 1

    # -- search ----------------------------------------------------------------

    def search_lane(
        self, lane: int, q_vecs: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k of ONE lane for Q queries in one device dispatch ->
        (scores [Q, k], lane-local idx [Q, k])."""
        self.flush_pending()
        q = self._to_dev(np.atleast_2d(np.asarray(q_vecs, np.float32)), torch.float32)
        self.dispatches += 1
        self.host_hops += 2  # query upload + score download around the dispatch
        metric = self.metrics[lane]
        if self.use_pallas and metric in _KERNEL_METRICS:
            from repro_torch.kernels.similarity_topk.ops import similarity_topk

            # one lane is one store: the single-store form (B2), [Q, k], over
            # the lane's own rows (contiguous views; no row past its
            # capacity is ever valid, so none is read)
            s, i = similarity_topk(
                self.lane_buf(lane), self.lane_valid(lane), q, k=k, metric=metric,
                prenormalized=self.prenorm[lane],
            )
        else:
            s, i = fused_search_body(
                self.buf[lane : lane + 1], self.valid[lane : lane + 1], q, k,
                (metric,), (self.prenorm[lane],),
            )
            s, i = s[:, 0], i[:, 0]
        s, i = fetch(s, i)
        i = i.astype(np.int32)
        s_eff = self.lifecycle_rescore(s, lane, i)
        if s_eff is not None:
            s, i = self.resort_desc(s_eff, i)
        return s, i

    def search_lanes(
        self, q_vecs: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused all-lanes top-k for Q queries in ONE device dispatch ->
        (scores [Q, L, k], lane-local idx [Q, L, k]). Candidates are never
        merged across lanes."""
        self.flush_pending()
        q = self._to_dev(np.atleast_2d(np.asarray(q_vecs, np.float32)), torch.float32)
        self.dispatches += 1
        self.host_hops += 2
        if self.use_pallas and self._kernel_ok():
            from repro_torch.kernels.similarity_topk.ops import similarity_topk_lanes

            # mixed cosine/dot banks satisfy the kernel's unit-cosine-rows
            # requirement by construction (insert normalizes cosine lanes)
            mixed = len(set(self.metrics)) > 1
            s, i = similarity_topk_lanes(
                self.buf, self.valid, q, k=k, metric=self.metrics,
                prenormalized=True if mixed else self.prenormalized,
                lane_rows=tuple(self.capacities),
            )
        else:
            s, i = fused_search_body(self.buf, self.valid, q, k, self.metrics, self.prenorm)
        s, i = fetch(s, i)
        i = i.astype(np.int32)
        s_eff = self.lifecycle_rescore(s, np.arange(self.L)[None, :, None], i)
        if s_eff is not None:
            s, i = self.resort_desc(s_eff, i)
        return s, i

    # -- lane views ------------------------------------------------------------

    def lane_buf(self, lane: int, capacity: Optional[int] = None) -> torch.Tensor:
        cap = self.capacities[lane] if capacity is None else capacity
        return self.buf[lane, :cap]

    def lane_valid(self, lane: int, capacity: Optional[int] = None) -> torch.Tensor:
        cap = self.capacities[lane] if capacity is None else capacity
        return self.valid[lane, :cap]

    # -- composition -----------------------------------------------------------

    @classmethod
    def adopt(cls, stores: Sequence, device: DeviceLike = None) -> "StoreBank":
        """Stack live lane-view stores into ONE shared bank on their common
        device (or on ``device``, when given) and repoint each store at its
        row. Contents (rows, masks, counters, lifecycle stamps) are copied
        from each store's current bank lane (device to device), so adoption
        is transparent to the stores' own add/search/remove paths."""
        dims = {s.dim for s in stores}
        if len(dims) != 1:
            raise ValueError(f"cannot stack stores with mixed dim: {dims}")
        devices = {s._bank.device for s in stores} if device is None else {resolve_device(device)}
        if len(devices) != 1:
            raise ValueError(f"cannot stack stores on different devices: {devices}")
        for s in stores:
            s._bank.flush_pending()
        bank = cls(
            dims.pop(),
            [s.capacity for s in stores],
            metric=[s.metric for s in stores],
            # conservative: the kernel path only when every lane opted in
            use_pallas=all(getattr(s, "use_pallas", False) for s in stores),
            device=devices.pop(),
        )
        last = np.zeros((bank.L, bank.cap), np.int32)
        cnt = np.zeros((bank.L, bank.cap), np.int32)
        seq = np.zeros((bank.L, bank.cap), np.int32)
        created = np.zeros((bank.L, bank.cap), np.float64)
        expires = np.full((bank.L, bank.cap), np.inf, np.float64)
        for li, s in enumerate(stores):
            ob, ol, cap = s._bank, s._lane, s.capacity
            src_last, src_cnt, src_seq = ob.counters_host()
            bank.buf[li, :cap] = ob.buf[ol, :cap]
            bank.valid[li, :cap] = ob.valid[ol, :cap]
            last[li, :cap] = src_last[ol, :cap]
            cnt[li, :cap] = src_cnt[ol, :cap]
            seq[li, :cap] = src_seq[ol, :cap]
            # lifecycle stamps share the process-wide epoch, so they copy
            # verbatim across banks; per-lane staleness follows the store
            created[li, :cap] = ob.h_created[ol, :cap]
            expires[li, :cap] = ob.h_expires[ol, :cap]
            bank.staleness_w[li] = ob.staleness_w[ol]
        bank.set_counters(last, cnt, seq)
        bank.set_lifecycle(created, expires)
        bank._d_stale = None
        bank._tick = max(bank._tick, *(s._bank._tick for s in stores))
        for li, s in enumerate(stores):
            s._bank = bank
            s._lane = li
        return bank
