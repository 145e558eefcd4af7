"""Mesh-sharded vector store: the cache's distributed data path.

The DB is a bank of *shard lanes*: ``n_shards`` lanes of ``cap_local``
rows, the lane axis split over the mesh's shard axes (``pod``, then
``data``; row-major). Each mesh position holds its own lanes in a
``StoreBank`` on that position's device, with their recency/frequency/
insertion counters and lifecycle stamps. ``ShardedBank`` is the global
[n_shards, cap_local] view of those banks that host code reads and
updates; every device update it makes is split by position.

A lookup runs per position and then merges:

    per position: dot [Q, cap_shard] -> local top-k   (on its device)
    the tiny [Q, k] candidate sets gathered onto the first position's
    device, innermost axis first (or all at once), and merged by a stable
    descending sort: ties go to the lower gathered position

Only k candidates per position cross devices — never the [Q, N] score
matrix. The store has a real eviction *policy*: once every slot is live,
adds evict by lru/lfu/fifo with the same victim rule as
``InMemoryVectorStore`` (``search_batch(touch=...)`` and ``touch_keys``
feed the counters).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.store_bank import (
    _TICK_COMPACT_AT,
    StoreBank,
    _bank_counter_set,
    _bank_free,
    _bank_touch,
    _normalize_rows as _norm_rows,
    _topk_desc,
    pad_to_bucket,
    prepare_scatter,
    select_victim,
    upload_columns,
)
from repro_torch.kernels.backend import fetch, stage_pinned, to_device


def _shard_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def shard_id(mesh, axes: Tuple[str, ...], coords) -> int:
    """The linear shard index of the mesh position at ``coords`` (axis ->
    index) over ``axes``: row-major over the axis order, the layout of the
    lane axis."""
    sid, mul = 0, 1
    for a in reversed(axes):
        sid += int(coords[a]) * mul
        mul *= mesh.shape[a]
    return sid


def shard_devices(mesh, axes: Tuple[str, ...]) -> List[torch.device]:
    """The device of each shard position, by shard id. Positions along the
    mesh's other axes hold replicas; the first of them (index 0) serves."""
    n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    out: List[Optional[torch.device]] = [None] * n
    for idx in np.ndindex(*mesh.devices.shape):
        coords = dict(zip(mesh.axis_names, idx))
        if any(coords[a] for a in mesh.axis_names if a not in axes):
            continue
        out[shard_id(mesh, axes, coords)] = mesh.devices[idx]
    return out


def _merge(ss: Sequence[torch.Tensor], ii: Sequence[torch.Tensor], k: int):
    """Concatenate [Q, k'] candidate sets in order and keep the k best by a
    stable descending sort (ties to the earlier set, as ``lax.top_k``)."""
    flat_s = torch.cat(list(ss), 1)
    flat_i = torch.cat(list(ii), 1)
    top_s, pos = _topk_desc(flat_s, min(k, flat_s.shape[1]))
    return top_s, torch.gather(flat_i, 1, pos)


def all_gather_merge_topk(mesh, axes, gs: Sequence[torch.Tensor], gi: Sequence[torch.Tensor],
                          k: int, *, hierarchical: bool = True):
    """Merge per-position [Q, k'] candidate (score, idx) sets, given by shard
    id, into the global top-k on the first position's device — the ONE
    merge shared by the lookups and the fused sharded read.

    ``hierarchical=True`` merges along the innermost (in-pod) axis first,
    back down to k, and only then across ``pod``: the paper's L1 (pod-local)
    / L2 (cross-pod) hierarchy as a merge schedule. ``hierarchical=False``
    is the flat form: every position's candidates in one merge, gathered in
    the reference's all-gather order (the last axis outermost)."""
    dev = gs[0].device
    gs = [t.to(dev) for t in gs]
    gi = [t.to(dev) for t in gi]
    if not axes:
        return _merge(gs, gi, k)
    sizes = [mesh.shape[a] for a in axes]
    if hierarchical:
        # row-major over the remaining axes: the innermost axis's groups are
        # consecutive runs; each merge removes that axis
        for n in reversed(sizes):
            merged = [_merge(gs[j:j + n], gi[j:j + n], k) for j in range(0, len(gs), n)]
            gs = [m[0] for m in merged]
            gi = [m[1] for m in merged]
        return gs[0], gi[0]
    order = [
        shard_id(mesh, axes, dict(zip(axes, reversed(rev))))
        for rev in np.ndindex(*reversed(sizes))
    ]
    return _merge([gs[s] for s in order], [gi[s] for s in order], k)


def _split(x, n: int) -> List[torch.Tensor]:
    """Per-position blocks of a lane-major global tensor (or the list itself)."""
    if isinstance(x, (list, tuple)):
        return list(x)
    x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    return list(torch.chunk(x, n, dim=0))


def position_topk(db, valid, q, k: int, metric: str, prenormalized: bool, penalty=None):
    """One position's plain top-k over its lanes flattened into [cap_shard]
    slots: (db [lanes_loc, cap_local, D], valid [lanes_loc, cap_local],
    q [Q, D]) -> (scores [Q, k'], shard-local flat idx [Q, k']), k' =
    min(k, cap_shard), by a stable descending sort. ``penalty`` [cap_shard]
    is subtracted before the top-k (the sharded read's lifecycle)."""
    lanes_loc, cap_local, dim = db.shape
    cap_shard = lanes_loc * cap_local
    db2 = db.to(torch.float32).reshape(cap_shard, dim)
    dbn = db2 if (metric != "cosine" or prenormalized) else _norm_rows(db2)
    q = q.to(torch.float32)
    qn = _norm_rows(q) if metric == "cosine" else q
    s = torch.matmul(qn, dbn.T)  # [Q, cap_shard]
    if penalty is not None:
        s = s - penalty[None, :]
    s = s.masked_fill(~valid.reshape(cap_shard)[None, :], float("-inf"))
    return _topk_desc(s, min(k, cap_shard))


def make_banked_lookup(mesh, *, k: int, metric: str = "cosine", hierarchical: bool = True,
                       prenormalized: bool = False):
    """Lookup over a bank of shard lanes: (db [L, cap_local, D], valid
    [L, cap_local], q [Q, D]) -> (scores [Q, k], flat global idx [Q, k]
    where idx = lane * cap_local + within). ``db`` and ``valid`` are global
    tensors, split lane-major by position, or lists of each position's
    block. Each position flattens its lanes into one [cap_shard, D] block,
    takes its local top-k on its device, and the candidates merge.
    ``prenormalized`` skips the db normalization (the bank keeps unit rows
    for cosine lanes)."""
    axes = _shard_axes(mesh)
    devs = shard_devices(mesh, axes)

    def lookup(db, valid, q):
        dbs, valids = _split(db, len(devs)), _split(valid, len(devs))
        q = q if isinstance(q, torch.Tensor) else torch.as_tensor(np.asarray(q, np.float32))
        ts, ti = [], []
        for sid, (db_l, v_l) in enumerate(zip(dbs, valids)):
            dev = devs[sid]
            top_s, top_i = position_topk(db_l.to(dev), v_l.to(dev), q.to(dev), k, metric,
                                         prenormalized)  # shard-local flat idx
            ts.append(top_s)
            ti.append(top_i + sid * db_l.shape[0] * db_l.shape[1])  # -> bank-global flat idx
        s, i = all_gather_merge_topk(mesh, axes, ts, ti, k, hierarchical=hierarchical)
        return s, i.to(torch.int32)

    return lookup


def make_sharded_lookup(mesh, *, k: int, metric: str = "cosine", hierarchical: bool = True):
    """Lookup over a flat sharded buffer: (db [N, D], valid [N], q [Q, D])
    -> (scores [Q, k], global idx [Q, k]); position sid holds rows
    [sid * N / n, (sid + 1) * N / n). (The flat-buffer form; the store
    itself uses ``make_banked_lookup``.)"""
    axes = _shard_axes(mesh)
    n = len(shard_devices(mesh, axes))
    banked = make_banked_lookup(mesh, k=k, metric=metric, hierarchical=hierarchical)

    def lookup(db, valid, q):
        db = db if isinstance(db, torch.Tensor) else torch.as_tensor(np.asarray(db, np.float32))
        valid = valid if isinstance(valid, torch.Tensor) else torch.as_tensor(np.asarray(valid))
        return banked(db.reshape(n, -1, db.shape[-1]), valid.reshape(n, -1), q)

    return lookup


class ShardedBank(StoreBank):
    """The global [n_shards * lanes_loc, cap_local] view of a sharded store:
    host mirrors, lifecycle arrays, the tick clock and the pending inserts
    are global, as in one ``StoreBank``; the device tensors live in
    ``parts``, one ``StoreBank`` of ``lanes_loc`` lanes per position, on
    that position's device. Every device update is split by position.
    ``buf``, ``valid`` and the ``d_*`` counters read as global tensors on
    the first position's device (a gather: host code and tests read them,
    the read path uses ``parts``); an in-place write through one raises
    instead of landing in the gathered copy."""

    def __init__(self, dim: int, n_lanes: int, cap_local: int, devices: Sequence[torch.device],
                 *, metric: str = "cosine", use_pallas: bool = False):
        if n_lanes % len(devices):
            raise ValueError(f"{n_lanes} lanes do not split over {len(devices)} positions")
        self.lanes_loc = n_lanes // len(devices)
        self._devices = list(devices)
        super().__init__(dim, [cap_local] * n_lanes, metric=metric, use_pallas=use_pallas,
                         device=devices[0])

    def _alloc_device(self, shape: Tuple[int, int]) -> None:
        self.parts = [
            StoreBank(self.dim, [self.cap] * self.lanes_loc, metric=self.metrics[0],
                      use_pallas=self.use_pallas, device=d)
            for d in self._devices
        ]

    @classmethod
    def adopt(cls, stores: Sequence, device=None):
        raise TypeError("a sharded bank is built by its ShardedVectorStore, not adopted")

    # -- the global view ---------------------------------------------------------

    def _gather(self, name: str) -> torch.Tensor:
        # an inference tensor: an in-place write to it raises outside
        # inference mode, so no update can be lost in the gathered copy
        with torch.inference_mode():
            return torch.cat([getattr(p, name).to(self.device) for p in self.parts])

    buf = property(lambda self: self._gather("buf"))
    valid = property(lambda self: self._gather("valid"))
    d_last_access = property(lambda self: self._gather("d_last_access"))
    d_access_count = property(lambda self: self._gather("d_access_count"))
    d_insert_seq = property(lambda self: self._gather("d_insert_seq"))
    d_created = property(lambda self: self._gather("d_created"))
    d_expires = property(lambda self: self._gather("d_expires"))

    def _positions(self, lanes: np.ndarray):
        """(position, mask over ``lanes``, position-local lanes) for every
        position that the global ``lanes`` touch."""
        pos = lanes // self.lanes_loc
        for p in np.unique(pos):
            m = pos == p
            yield int(p), m, lanes[m] - p * self.lanes_loc

    def _split_rows(self, a: np.ndarray) -> List[np.ndarray]:
        return np.split(np.asarray(a), len(self.parts))

    # -- state installs, split by position ---------------------------------------

    def set_staleness(self, lane: int, weight: float) -> None:
        super().set_staleness(lane, weight)
        self.parts[lane // self.lanes_loc].set_staleness(lane % self.lanes_loc, weight)

    def set_lifecycle(self, created_rel: np.ndarray, expires_rel: np.ndarray) -> None:
        self.h_created = np.asarray(created_rel, np.float64).copy()
        self.h_expires = np.asarray(expires_rel, np.float64).copy()
        for p, c, e in zip(self.parts, self._split_rows(self.h_created),
                           self._split_rows(self.h_expires)):
            p.d_created = to_device(c.astype(np.float32), p.device, torch.float32)
            p.d_expires = to_device(e.astype(np.float32), p.device, torch.float32)
        if np.isfinite(self.h_expires).any():
            self._ttl_live = True

    def set_counters(self, last: np.ndarray, cnt: np.ndarray, seq: np.ndarray) -> None:
        last = np.asarray(last, np.int32)
        cnt = np.asarray(cnt, np.int32)
        seq = np.asarray(seq, np.int32)
        for p, l_, c_, s_ in zip(self.parts, self._split_rows(last), self._split_rows(cnt),
                                 self._split_rows(seq)):
            p.d_last_access = to_device(l_, p.device, torch.int32)
            p.d_access_count = to_device(c_, p.device, torch.int32)
            p.d_insert_seq = to_device(s_, p.device, torch.int32)
        self._mirror = (last.copy(), cnt.copy(), seq.copy())
        self._tick = max(self._tick, int(last.max(initial=0)) + 1)

    def counters_host(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._mirror is None:
            self.flush_pending()
            per = [fetch(p.d_last_access, p.d_access_count, p.d_insert_seq) for p in self.parts]
            self._mirror = tuple(np.concatenate([x[j] for x in per]).copy() for j in range(3))
        return self._mirror

    # -- device updates, split by position ---------------------------------------

    def _device_counter_set(self, cols: Tuple[np.ndarray, ...]) -> None:
        for pi, m, local in self._positions(cols[0]):
            part = self.parts[pi]
            sub = (local,) + tuple(c[m] for c in cols[1:])
            _bank_counter_set(part, *upload_columns(sub, part.device))

    def _device_touch(self, lanes: np.ndarray, idxs: np.ndarray, tick: int) -> None:
        for pi, m, local in self._positions(lanes):
            part = self.parts[pi]
            _bank_touch(
                part.d_last_access, part.d_access_count,
                to_device(local, part.device, torch.int64),
                to_device(idxs[m], part.device, torch.int64),
                torch.ones(int(m.sum()), dtype=torch.int32, device=part.device), tick,
            )

    def _device_free(self, lanes: np.ndarray, idxs: np.ndarray) -> None:
        for pi, m, local in self._positions(lanes):
            part = self.parts[pi]
            _bank_free(part, to_device(local, part.device, torch.int64),
                       to_device(idxs[m], part.device, torch.int64))

    def set_rows(self, lane: int, idxs: List[int], rows: np.ndarray,
                 *, pinned: bool = False) -> None:
        self.scatter_rows([lane * self.cap + int(i) for i in idxs], rows, pinned=pinned)

    def scatter_rows(self, idxs: List[int], rows: np.ndarray, *, pinned: bool = False) -> None:
        """Scatter rows into global flat slots (lane-major: lane * cap_local
        + within) together with the pending insert-time counter and
        lifecycle resets: per position, one in-place update of its part.
        Cosine lanes are unit-normalized on device. ``pinned=True`` stages
        the rows through pinned host memory on a CUDA position."""
        sel_rows, sel_idx = prepare_scatter(idxs, np.asarray(rows, np.float32))
        cols = self._pending_columns()
        lanes = sel_idx // self.cap
        withins = sel_idx % self.cap
        for pi, m, local in self._positions(lanes):
            part = self.parts[pi]
            if pinned:
                rows_d = stage_pinned(sel_rows[m], part.device).to(part.device, non_blocking=True)
            else:
                rows_d = to_device(sel_rows[m], part.device, torch.float32)
            if self.prenorm[0]:
                rows_d = _norm_rows(rows_d)
            at = (to_device(local, part.device, torch.int64),
                  to_device(withins[m], part.device, torch.int64))
            part.buf[at] = rows_d
            part.valid[at] = True
        self._device_counter_set(cols)


class ShardedVectorStore:
    """Host-facing lane view over a mesh-sharded bank (one lane per shard
    position): adds, the fused sharded lookup, and a real eviction policy
    backed by the bank's per-lane counters. ``use_pallas=True`` searches
    each position through the similarity top-k kernel wrapper on the fused
    read; it is opt-in, as for ``InMemoryVectorStore``."""

    def __init__(
        self, mesh, dim: int, capacity: int, *, k: int = 4, metric: str = "cosine",
        eviction: str = "lru",  # lru | lfu | fifo
        default_ttl_s: Optional[float] = None,
        staleness_weight: float = 0.0,
        tier1=None,  # HostRamTier: eviction victims demote here, keyed by home shard
        fused: bool = True,  # serve reads through the fused sharded read
        use_pallas: bool = False,
    ):
        assert eviction in ("lru", "lfu", "fifo")
        self.mesh = mesh
        self.dim = dim
        axes = _shard_axes(mesh)
        n_shards = 1
        for a in axes:
            n_shards *= mesh.shape[a]
        self.capacity = capacity - (capacity % max(n_shards, 1)) or n_shards
        self.n_shards = n_shards
        self.cap_local = self.capacity // n_shards
        self.metric = metric
        self.eviction = eviction
        self.k = k
        self.use_pallas = use_pallas
        # the bank owns rows/masks/counters, each position's on its device
        self.bank = ShardedBank(dim, n_shards, self.cap_local, shard_devices(mesh, axes),
                                metric=metric, use_pallas=use_pallas)
        self._lookup = make_banked_lookup(
            mesh, k=k, metric=metric, prenormalized=self.bank.prenormalized
        )
        self.fused = bool(fused) and bool(axes)
        self._srb = None  # lazy single-member ShardedReadBank (fused reads)
        self.default_ttl_s = default_ttl_s
        self.staleness_weight = float(staleness_weight)
        for lane in range(n_shards):
            self.bank.set_staleness(lane, staleness_weight)
        self.size = 0
        self.payloads: List[Optional[tuple]] = [None] * self.capacity
        # per-slot meta dicts (hierarchy promotion flags etc.) — payloads stay
        # bare (query, response) tuples for the search_batch contract
        self._metas: List[Optional[dict]] = [None] * self.capacity
        self._rr = 0  # round-robin placement cursor for the first fill
        self._seq = 0  # insertion counter feeding the fifo policy
        # key -> slot map + freed-slot reuse (the InMemoryVectorStore scheme):
        # remove() frees the slot, the next add reclaims it before the
        # round-robin cursor advances
        self._next_key = 0
        self._key_to_slot: Dict[int, int] = {}
        self._slot_key: List[Optional[int]] = [None] * self.capacity
        self._free: List[int] = []
        # tier-1 demotion target + raw-row host mirror: eviction victims
        # demote instead of vanishing, remembering their home shard lane in
        # TierEntry.meta
        self.tier1 = None
        self._host_rows: Optional[np.ndarray] = None
        if tier1 is not None:
            self.attach_tier1(tier1)

    # -- tiering -------------------------------------------------------------

    def attach_tier1(self, tier) -> None:
        """Attach a host-RAM demotion tier (``repro_torch.core.tiers.HostRamTier``).
        Eviction victims demote into it instead of vanishing — matching the
        in-memory lane view — with their home shard lane recorded in
        ``TierEntry.meta['home_shard']`` so promotions can land back on the
        shard whose counters/lifecycle they rode. A raw-row host mirror makes
        demotion a numpy copy instead of a device pull on the eviction path."""
        self.tier1 = tier
        self._host_rows = self._db.cpu().numpy().astype(np.float32)

    def _demote(self, idx: int) -> None:
        """Hand the (still-live) entry in flat slot ``idx`` to tier 1."""
        if self.tier1 is None:
            return
        payload = self.payloads[idx]
        key = self._slot_key[idx]
        if payload is None or key is None:
            return
        lane, within = self._lane_within(idx)
        expires_rel = float(self.bank.h_expires[lane, within])
        if expires_rel <= self.bank.rel_now():
            return  # dead entries are dropped, never demoted
        from repro_torch.core.tiers import TierEntry

        row = (
            self._host_rows[idx]
            if self._host_rows is not None
            else self._db[idx].cpu().numpy()
        )
        self.tier1.put(
            TierEntry(
                key=key,
                query=payload[0],
                response=payload[1],
                meta={**(self._metas[idx] or {}), "home_shard": lane},
                created_at=self.bank.to_abs(float(self.bank.h_created[lane, within])),
                expires_at=self.bank.to_abs(expires_rel),
                access_count=int(self.bank.access_count[lane, within]),
            ),
            np.array(row, np.float32),
        )

    def _free_slot_in_lane(self, lane) -> Optional[int]:
        """A reusable freed slot on the given lane, if any — the home-shard
        preference promotions use before falling back to global placement."""
        if not isinstance(lane, int) or not 0 <= lane < self.n_shards:
            return None
        lo = lane * self.cap_local
        hi = lo + self.cap_local
        for pos in range(len(self._free) - 1, -1, -1):
            if lo <= self._free[pos] < hi:
                return self._free.pop(pos)
        return None

    def _restore_batch(self, rows: np.ndarray, tier_entries: List) -> None:
        """Promote tier-1 entries back into the sharded bank through the SAME
        batched scatter inserts ride. Keys, created/expires stamps, and
        access counts are preserved (a promoted hit is byte-identical to its
        pre-demotion self); each entry prefers a freed slot on its home
        shard lane and falls back to the global cursor/eviction policy."""
        n = len(tier_entries)
        if n == 0:
            return
        rows = np.asarray(rows, np.float32).reshape(n, self.dim)
        idxs: List[int] = []
        for j, te in enumerate(tier_entries):
            if self._seq >= _TICK_COMPACT_AT:
                self._seq = self.bank.compact_seqs()
            home = te.meta.get("home_shard") if isinstance(te.meta, dict) else None
            idx = self._free_slot_in_lane(home)
            if idx is None:
                idx = self._next_index()
            old = self._slot_key[idx]
            if old is not None:  # promotion displaced a live entry: demote it
                self._demote(idx)
                self._key_to_slot.pop(old, None)
            else:
                self.size += 1
            self.payloads[idx] = (te.query, te.response)
            # home_shard is placement routing, not entry state — strip it so a
            # later demotion records the slot's CURRENT lane, not a stale one
            meta = {k: v for k, v in dict(te.meta or {}).items() if k != "home_shard"}
            self._metas[idx] = meta or None
            self._slot_key[idx] = te.key
            self._key_to_slot[te.key] = idx
            self._next_key = max(self._next_key, te.key + 1)
            lane, within = self._lane_within(idx)
            self.bank.note_insert(
                lane, within, self._seq,
                created=self.bank.to_rel(te.created_at),
                expires=(
                    self.bank.to_rel(te.expires_at)
                    if np.isfinite(te.expires_at)
                    else None
                ),
                count=int(te.access_count),
            )
            self._seq += 1
            idxs.append(idx)
            if self._host_rows is not None:
                # mirror immediately (not after the loop): a later placement
                # in this same batch may evict this row and demote its vector
                self._host_rows[idx] = rows[j]
        # promotions stage through pinned host memory on a CUDA position, so
        # the restore copy can overlap the read it rides beside
        self.bank.scatter_rows(idxs, rows, pinned=True)

    # flat views of the banked buffers (lane-major flattening: global flat
    # slot = lane * cap_local + within)
    @property
    def _db(self) -> torch.Tensor:
        return self.bank.buf.reshape(self.capacity, self.dim)

    @property
    def _valid(self) -> torch.Tensor:
        return self.bank.valid.reshape(self.capacity)

    def _lane_within(self, idx: int) -> Tuple[int, int]:
        return idx // self.cap_local, idx % self.cap_local

    def _next_index(self) -> int:
        if self._free:
            return self._free.pop()
        if self._rr < self.capacity:
            # first fill: balanced round-robin placement across shard lanes
            shard = self._rr % self.n_shards
            within = (self._rr // self.n_shards) % self.cap_local
            self._rr += 1
            return shard * self.cap_local + within
        # every slot is live: already-expired entries are free capacity — the
        # most-expired slot goes first, before any live entry is evicted
        if self.bank.lifecycle_active():
            exp = self.bank.h_expires.reshape(-1)
            dead = exp <= self.bank.rel_now()
            if dead.any():
                return int(np.argmin(np.where(dead, exp, np.inf)))
        # evict per policy over the bank's flat counter view (host mirror of
        # the device counters, synced on demand)
        last, cnt, seq = self.bank.counters_host()
        return select_victim(
            self.eviction, last.reshape(-1), cnt.reshape(-1), seq.reshape(-1)
        )

    def _claim_slot(
        self, idx: int, query: str, response: str,
        meta: Optional[dict] = None, ttl_s: Optional[float] = None,
    ) -> int:
        """Host-side bookkeeping for one placement (shared by add/add_batch)."""
        old = self._slot_key[idx]
        if old is not None:  # policy eviction overwrote a live entry
            self._demote(idx)  # still-live victims move to tier 1
            self._key_to_slot.pop(old, None)
        else:
            self.size += 1
        key = self._next_key
        self._next_key += 1
        self.payloads[idx] = (query, response)
        self._metas[idx] = dict(meta) if meta else None
        self._slot_key[idx] = key
        self._key_to_slot[key] = idx
        lane, within = self._lane_within(idx)
        if self._seq >= _TICK_COMPACT_AT:  # int32 insertion clock: rank-rebase
            self._seq = self.bank.compact_seqs()
        ttl_s = self.default_ttl_s if ttl_s is None else ttl_s
        created = self.bank.rel_now()
        expires = created + ttl_s if ttl_s is not None else None
        self.bank.note_insert(lane, within, self._seq, created=created, expires=expires)
        self._seq += 1
        return key

    def add(self, vec: np.ndarray, query: str, response: str,
            meta: Optional[dict] = None, ttl_s: Optional[float] = None) -> int:
        idx = self._next_index()
        key = self._claim_slot(idx, query, response, meta, ttl_s)
        row = np.asarray(vec, np.float32).reshape(1, self.dim)
        if self._host_rows is not None:
            self._host_rows[idx] = row[0]
        self.bank.scatter_rows([idx], row)
        return key

    def add_batch(self, vecs: np.ndarray, queries, responses,
                  metas: Optional[List[Optional[dict]]] = None,
                  ttls: Optional[List[Optional[float]]] = None) -> List[int]:
        """N placements in ONE scatter per position into the sharded bank.

        Placement order (and therefore the shard lane each entry lands on)
        matches N sequential ``add`` calls, freed-slot reuse and policy
        eviction included; if the batch overwrites one slot twice, the last
        write wins — exactly what the sequential loop would leave behind.
        ``metas``/``ttls`` carry optional per-entry meta dicts and TTLs
        (None = no meta / default_ttl_s) — the ``InMemoryVectorStore``
        signature, so ``SemanticCache`` levels can sit on a sharded store.
        """
        n = len(queries)
        if n == 0:
            return []
        rows = np.asarray(vecs, np.float32).reshape(n, self.dim)
        metas = list(metas) if metas is not None else [None] * n
        ttls = list(ttls) if ttls is not None else [None] * n
        idxs: List[int] = []
        keys: List[int] = []
        for j in range(n):
            idx = self._next_index()
            keys.append(self._claim_slot(idx, queries[j], responses[j], metas[j], ttls[j]))
            idxs.append(idx)
            if self._host_rows is not None:
                # mirror immediately (not after the loop): a later claim in
                # this same batch may evict this row and demote its vector
                self._host_rows[idx] = rows[j]
        self.bank.scatter_rows(idxs, rows)
        return keys

    def remove(self, key: int) -> bool:
        """Evict one entry: clears its validity AND the slot's counter/
        lifecycle metadata on its position's device, then frees the slot for
        reuse by the next add (before the cursor advances)."""
        idx = self._key_to_slot.pop(key, None)
        if idx is None:
            return False
        self.payloads[idx] = None
        self._metas[idx] = None
        self._slot_key[idx] = None
        lane, within = self._lane_within(idx)
        self.bank.free_slots([lane], [within])
        self._free.append(idx)
        self.size -= 1
        return True

    def clear(self, older_than: Optional[float] = None) -> int:
        """Drop entries older than ``older_than`` seconds (None = everything);
        already-expired entries always qualify. One batched free update."""
        cutoff = self.bank.rel_now() - (older_than if older_than is not None else 0)
        rel_now = self.bank.rel_now()
        lanes: List[int] = []
        withins: List[int] = []
        for idx, key in enumerate(self._slot_key):
            if key is None:
                continue
            lane, within = self._lane_within(idx)
            created = self.bank.h_created[lane, within]
            expired = self.bank.h_expires[lane, within] <= rel_now
            if older_than is None or created <= cutoff or expired:
                self._key_to_slot.pop(key, None)
                self.payloads[idx] = None
                self._metas[idx] = None
                self._slot_key[idx] = None
                self._free.append(idx)
                self.size -= 1
                lanes.append(lane)
                withins.append(within)
        if lanes:
            self.bank.free_slots(lanes, withins)
        dropped = len(lanes)
        if self.tier1 is not None:  # age-based clears prune the tiers together
            dropped += self.tier1.clear(older_than=older_than)
        return dropped

    def __len__(self) -> int:
        return self.size

    def touch_keys(self, keys) -> None:
        """Deferred recency/frequency bookkeeping (same contract as
        ``InMemoryVectorStore.touch_keys``): one bump per occurrence, one
        counter update for the whole key list; keys overwritten since the
        search are skipped."""
        pairs = [
            self._lane_within(idx)
            for idx in (self._key_to_slot.get(key) for key in keys)
            if idx is not None
        ]
        if pairs:
            self.bank.touch_slots([p[0] for p in pairs], [p[1] for p in pairs])

    # -- fused read path (1 dispatch / 0 host hops) ------------------------------

    def _fused_decision(self, q: np.ndarray, thr, k_eff: int, touch: bool):
        """One fused read over this store's lanes via a single-member
        ``ShardedReadBank``: local top-k per position, candidate merge,
        pre-top-k lifecycle, threshold decide, and the counter touches —
        with zero host hops in between."""
        from repro_torch.core.read_path import LevelSpec
        from repro_torch.distributed.sharded_read import ShardedReadBank

        if self._srb is None or not self._srb.intact([self]):
            self._srb = ShardedReadBank(self.mesh, [("sh", self)])
        spec = LevelSpec(False, True, 0.0, float("inf"), 0, int(k_eff))
        n = q.shape[0]
        if thr is None:
            thr_arr = np.full((n, 1), -np.inf, np.float32)
        else:
            thr_arr = np.broadcast_to(np.asarray(thr, np.float32), (n,)).reshape(n, 1)
        self.bank.dispatches += 1  # this store's share of the ONE dispatch
        return self._srb.fused_read(None, [None] * n, thr_arr, (spec,), vecs=q, touch=touch)

    def search(self, q_vecs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over every shard: (scores [Q, k], global flat idx [Q, k]).
        Served by the fused read (lifecycle applied pre-top-k, on device);
        ``fused=False`` stores take the host walk."""
        if not self.fused:
            return self.search_host(q_vecs)
        q = np.atleast_2d(np.asarray(q_vecs, np.float32))
        dec = self._fused_decision(q, None, self.k, touch=False)
        return dec.scores[:, 0], dec.idx[:, 0]

    def search_host(self, q_vecs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The host walk — device search, HOST-side lifecycle rescore (2 host
        hops) — kept as the parity-test / benchmark reference and the
        ``fused=False`` path."""
        self.bank.flush_pending()
        q, n_q = pad_to_bucket(np.atleast_2d(np.asarray(q_vecs, np.float32)))
        self.bank.dispatches += 1
        self.bank.host_hops += 2
        parts = self.bank.parts
        s, i = self._lookup([p.buf for p in parts], [p.valid for p in parts],
                            torch.as_tensor(q))
        s, i = fetch(s, i)
        s, i = s[:n_q], i[:n_q]
        # entry lifecycle: expired candidates drop out, TTL'd ones pay the
        # staleness penalty (host-side on the tiny [Q, k] candidate sets —
        # the global flat idx decomposes into the bank's (lane, within))
        s_eff = self.bank.lifecycle_rescore(s, i // self.cap_local, i % self.cap_local)
        if s_eff is not None:
            s, i = self.bank.resort_desc(s_eff, i)
        return s, i

    def _join_payloads(
        self, scores: np.ndarray, idx: np.ndarray, k_eff: int,
    ) -> List[List[Tuple[float, tuple]]]:
        out: List[List[Tuple[float, tuple]]] = []
        for srow, irow in zip(scores, idx):
            row = []
            for sc, i in zip(srow, irow):
                payload = self.payloads[int(i)] if 0 <= int(i) < self.capacity else None
                if np.isfinite(sc) and payload is not None:
                    row.append((float(sc), payload))
            out.append(row[:k_eff])
        return out

    def search_batch(
        self, q_vecs: np.ndarray, k: Optional[int] = None, touch: bool = True
    ) -> List[List[Tuple[float, tuple]]]:
        """Batched payload-joined lookup for Q queries in ONE fused read —
        including the LRU/LFU touches (each position bumps the counters of
        the slots it owns). Returns, per query, the finite (score, (query,
        response)) candidates in score order. ``k`` caps the candidates per
        query (at most the configured search k); ``touch=False`` defers the
        counter bumps to ``touch_keys``."""
        q = np.atleast_2d(np.asarray(q_vecs, np.float32))
        k_eff = self.k if k is None else min(k, self.k)
        if not self.fused:
            return self.search_batch_host(q, k=k_eff, touch=touch)
        dec = self._fused_decision(q, None, k_eff, touch=touch)
        return self._join_payloads(dec.scores[:, 0], dec.idx[:, 0], k_eff)

    def search_batch_host(
        self, q_vecs: np.ndarray, k: Optional[int] = None, touch: bool = True
    ) -> List[List[Tuple[float, tuple]]]:
        """Host-walk reference twin of ``search_batch``: device search, then
        join + touch decided in host Python (one extra counter update)."""
        q = np.atleast_2d(np.asarray(q_vecs, np.float32))
        s, idx = self.search_host(q)
        k_eff = self.k if k is None else min(k, self.k)
        out: List[List[Tuple[float, tuple]]] = []
        touched: List[Tuple[int, int]] = []
        for srow, irow in zip(s, idx):
            row = []
            for sc, i in zip(srow, irow):
                payload = self.payloads[int(i)] if 0 <= int(i) < self.capacity else None
                if np.isfinite(sc) and payload is not None:
                    if len(row) < k_eff and touch:
                        touched.append(self._lane_within(int(i)))
                    row.append((float(sc), payload))
            out.append(row[:k_eff])
        if touched:
            # one update (one shared tick) for the whole batch's bumps
            self.bank.touch_slots([p[0] for p in touched], [p[1] for p in touched])
        return out

    def lookup_batch(
        self, q_vecs: np.ndarray, thresholds
    ) -> List[Optional[Tuple[float, tuple]]]:
        """Apply per-query thresholds over the batched search: the best
        (score, payload) when score > threshold, else None. On the fused
        path the threshold compare happens in the read (the decide stage's
        hit mask) — the host only joins payloads for the winning rows."""
        q = np.atleast_2d(np.asarray(q_vecs, np.float32))
        thr = np.broadcast_to(np.asarray(thresholds, np.float32), (q.shape[0],))
        if not self.fused:
            return self.lookup_batch_host(q, thr)
        dec = self._fused_decision(q, thr, self.k, touch=True)
        out: List[Optional[Tuple[float, tuple]]] = []
        for qi in range(q.shape[0]):
            if not dec.hit[qi, 0]:
                out.append(None)
                continue
            i = int(dec.idx[qi, 0, 0])
            payload = self.payloads[i] if 0 <= i < self.capacity else None
            out.append((float(dec.scores[qi, 0, 0]), payload) if payload is not None else None)
        return out

    def lookup_batch_host(
        self, q_vecs: np.ndarray, thresholds
    ) -> List[Optional[Tuple[float, tuple]]]:
        """Host-walk reference twin of ``lookup_batch`` (threshold compare
        in host numpy over the host-joined candidate rows)."""
        q = np.atleast_2d(np.asarray(q_vecs, np.float32))
        thr = np.broadcast_to(np.asarray(thresholds, np.float32), (q.shape[0],))
        rows = self.search_batch_host(q)
        best = np.asarray([r[0][0] if r else -np.inf for r in rows])
        hit = best > thr
        return [rows[i][0] if hit[i] else None for i in range(q.shape[0])]

    def join_candidates(
        self, scores: np.ndarray, idx: np.ndarray, touch: bool = True
    ) -> List[List[Tuple[float, "object"]]]:
        """Join raw (scores [Q, k], GLOBAL flat idx [Q, k]) search output
        into (score, ``Entry``) rows — the hierarchy-facing twin of
        ``InMemoryVectorStore.join_candidates``, reconstructing Entries from
        the host payload/meta/lifecycle state the sharded store keeps.
        ``touch=True`` bumps the joined slots' counters in one update (the
        fused read passes ``touch=False`` — its bumps already happened
        inside the read)."""
        from repro_torch.core.vector_store import Entry

        out: List[List[Tuple[float, Entry]]] = []
        touched: List[Tuple[int, int]] = []
        for srow, irow in zip(scores, idx):
            row = []
            for sc, i in zip(srow, irow):
                i = int(i)
                if not 0 <= i < self.capacity:
                    continue
                payload = self.payloads[i]
                key = self._slot_key[i]
                if not np.isfinite(sc) or payload is None or key is None:
                    continue
                lane, within = self._lane_within(i)
                if touch:
                    touched.append((lane, within))
                row.append((
                    float(sc),
                    Entry(
                        key, payload[0], payload[1],
                        dict(self._metas[i] or {}),
                        self.bank.to_abs(float(self.bank.h_created[lane, within])),
                        self.bank.to_abs(float(self.bank.h_expires[lane, within])),
                    ),
                ))
            out.append(row)
        if touched:
            self.bank.touch_slots([p[0] for p in touched], [p[1] for p in touched])
        return out
