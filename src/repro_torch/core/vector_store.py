"""Vector stores for the cache.

``InMemoryVectorStore`` is the paper's "lighter weight ... single process"
option (§5.3): a preallocated device-resident [capacity, D] lane searched
by one fused top-k dispatch (exact brute-force search). The store is a thin
*lane view*: device rows, validity masks, and eviction counters live in a
``repro_torch.core.store_bank.StoreBank`` on an explicit device (a
standalone store owns a 1-lane bank; a hierarchy stacks its levels into one
shared [L, cap, D] bank via ``StoreBank.adopt`` so the whole hierarchy is
searched in ONE dispatch). The store keeps the host-side entry metadata,
victim selection, and the public add/search/remove/save/load API.

Adds are in-place device updates. Contents can be persisted to disk and
warm-started (§4 "bring a cache to a warm state"); the snapshot format
(``vectors.npz`` + ``manifest.json``) is the reference package's, byte for
byte, so snapshots cross between the two packages both ways.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.store_bank import (  # noqa: F401 — re-exported for back-compat
    _TICK_COMPACT_AT,
    StoreBank,
    pad_to_bucket,
    prepare_scatter,
    select_victim,
)


@dataclass
class Entry:
    key: int
    query: str
    response: str
    meta: Dict[str, Any] = field(default_factory=dict)
    created_at: float = 0.0  # absolute unix seconds
    expires_at: float = float("inf")  # absolute; inf = never expires

    def expired(self, now: Optional[float] = None) -> bool:
        return self.expires_at <= (time.time() if now is None else now)


class InMemoryVectorStore:
    def __init__(
        self,
        dim: int,
        capacity: int = 4096,
        metric: str = "cosine",
        eviction: str = "lru",  # lru | lfu | fifo
        use_pallas: bool = False,
        default_ttl_s: Optional[float] = None,
        staleness_weight: float = 0.0,
        tier1=None,  # HostRamTier: eviction victims demote here (repro_torch.core.tiers)
        device=None,  # None = CUDA (raises without one); "cpu" runs on the host
    ):
        assert eviction in ("lru", "lfu", "fifo")
        self.dim = dim
        self.capacity = capacity
        self.metric = metric
        self.eviction = eviction
        self.use_pallas = use_pallas
        # entry lifecycle knobs: default TTL stamped on inserts that don't
        # carry their own, and the staleness penalty weight for this lane
        self.default_ttl_s = default_ttl_s
        self.staleness_weight = float(staleness_weight)
        # lane view: device rows/masks/counters live in the bank; a fresh
        # store owns a private 1-lane bank until a hierarchy adopts it
        self._bank = StoreBank(
            dim, [capacity], metric=metric, use_pallas=use_pallas, device=device
        )
        self._lane = 0
        self._bank.set_staleness(self._lane, staleness_weight)
        self._entries: List[Optional[Entry]] = [None] * capacity
        self._seq = 0
        self.size = 0  # live entries
        self._next_key = 0
        self._key_to_slot: Dict[int, int] = {}
        self._free: List[int] = []  # slots freed by remove(), reused before eviction
        self._tail = 0  # slots ever occupied; grows monotonically to capacity
        # tier-1 demotion target + the raw-row host mirror that feeds it
        # (rows arrive on host at add time anyway; the mirror makes demotion
        # a numpy copy instead of a device pull on the eviction path)
        self.tier1 = None
        self._host_rows: Optional[np.ndarray] = None
        if tier1 is not None:
            self.attach_tier1(tier1)

    # -- lane views (device rows + counters live in the bank) -------------------

    @property
    def _buf(self) -> torch.Tensor:
        return self._bank.lane_buf(self._lane, self.capacity)

    @property
    def _valid(self) -> torch.Tensor:
        return self._bank.lane_valid(self._lane, self.capacity)

    @property
    def _last_access(self) -> np.ndarray:  # host view of the bank's device counters
        return self._bank.last_access[self._lane][: self.capacity]

    @property
    def _access_count(self) -> np.ndarray:
        return self._bank.access_count[self._lane][: self.capacity]

    @property
    def _insert_seq(self) -> np.ndarray:
        return self._bank.insert_seq[self._lane][: self.capacity]

    # -- tiering -------------------------------------------------------------

    def attach_tier1(self, tier) -> None:
        """Attach a host-RAM demotion tier (``repro_torch.core.tiers.HostRamTier``).
        From now on eviction victims demote into it instead of vanishing, and
        a raw-row host mirror is kept so demotion is a numpy copy rather than
        a device pull on the eviction path."""
        self.tier1 = tier
        self._host_rows = self._buf.cpu().numpy().astype(np.float32)

    def _demote(self, idx: int, entry: Entry) -> None:
        if self.tier1 is None or entry.expired():
            return  # dead entries are dropped, never demoted
        from repro_torch.core.tiers import TierEntry

        row = (
            self._host_rows[idx]
            if self._host_rows is not None
            else self._buf[idx].cpu().numpy()
        )
        self.tier1.put(
            TierEntry(
                key=entry.key,
                query=entry.query,
                response=entry.response,
                meta=dict(entry.meta),
                created_at=entry.created_at,
                expires_at=entry.expires_at,
                access_count=int(self._access_count[idx]),
            ),
            np.array(row, np.float32),
        )

    # -- internals ----------------------------------------------------------

    def _victim(self) -> int:
        if self._free:
            return self._free.pop()
        if self._tail < self.capacity:
            return self._tail
        # every slot holds a live entry: prefer reclaiming an expired one
        # (most-expired first) before evicting anything still alive
        if self._bank.lifecycle_active():
            exp = self._bank.h_expires[self._lane][: self.capacity]
            dead = exp <= self._bank.rel_now()
            if dead.any():
                return int(np.argmin(np.where(dead, exp, np.inf)))
        return select_victim(
            self.eviction, self._last_access, self._access_count, self._insert_seq
        )

    def _claim(
        self,
        idx: int,
        query: str,
        response: str,
        meta: Optional[dict],
        ttl_s: Optional[float] = None,
    ) -> int:
        """Host-side bookkeeping for one placement (shared by add/add_batch)."""
        if self._seq >= _TICK_COMPACT_AT:
            self._seq = self._bank.compact_seqs()
        evicted = self._entries[idx]
        if evicted is not None:
            self._demote(idx, evicted)
            self._key_to_slot.pop(evicted.key, None)
            self.size -= 1
        if idx == self._tail:
            self._tail += 1
        key = self._next_key
        self._next_key += 1
        ttl_s = self.default_ttl_s if ttl_s is None else ttl_s
        created = time.time()
        expires = created + ttl_s if ttl_s is not None else float("inf")
        self._entries[idx] = Entry(
            key, query, response, dict(meta or {}), created, expires
        )
        self._key_to_slot[key] = idx
        self._bank.note_insert(
            self._lane,
            idx,
            self._seq,
            created=self._bank.to_rel(created),
            expires=self._bank.to_rel(expires) if np.isfinite(expires) else None,
        )
        self._seq += 1
        self.size += 1
        return key

    # -- API -----------------------------------------------------------------

    def add(
        self,
        vec: np.ndarray,
        query: str,
        response: str,
        meta: Optional[dict] = None,
        ttl_s: Optional[float] = None,
    ) -> int:
        idx = self._victim()
        key = self._claim(idx, query, response, meta, ttl_s)
        row = np.asarray(vec, np.float32).reshape(1, self.dim)
        if self._host_rows is not None:
            self._host_rows[idx] = row[0]
        self._bank.set_rows(self._lane, [idx], row)
        return key

    def add_batch(
        self,
        vecs: np.ndarray,
        queries: List[str],
        responses: List[str],
        metas: Optional[List[Optional[dict]]] = None,
        ttls: Optional[List[Optional[float]]] = None,
    ) -> List[int]:
        """Insert N rows with ONE in-place scatter instead of N device updates.

        Victim selection, eviction bookkeeping, and key assignment run
        host-side in insertion order, so the result is entry-for-entry
        identical to N sequential ``add`` calls (freed-slot reuse, tail
        growth, and policy eviction included); only the device work is fused
        into a single in-place scatter into the bank lane.
        """
        n = len(queries)
        if n == 0:
            return []
        metas = list(metas) if metas is not None else [None] * n
        ttls = list(ttls) if ttls is not None else [None] * n
        rows = np.asarray(vecs, np.float32).reshape(n, self.dim)
        keys: List[int] = []
        idxs: List[int] = []
        for j in range(n):
            idx = self._victim()
            keys.append(self._claim(idx, queries[j], responses[j], metas[j], ttls[j]))
            idxs.append(idx)
            if self._host_rows is not None:
                # mirror immediately (not after the loop): a later claim in
                # this same batch may evict this row and demote its vector
                self._host_rows[idx] = rows[j]
        self._bank.set_rows(self._lane, idxs, rows)
        return keys

    def _restore_batch(self, rows: np.ndarray, tier_entries: List) -> None:
        """Promote tier-1 entries back into the device lane via the SAME
        batched row-scatter path inserts use (one in-place scatter). Original
        keys, created/expires stamps, and access counts are preserved, so a
        promoted hit is byte-identical to its pre-demotion self."""
        n = len(tier_entries)
        if n == 0:
            return
        rows = np.asarray(rows, np.float32).reshape(n, self.dim)
        idxs: List[int] = []
        for j, te in enumerate(tier_entries):
            if self._seq >= _TICK_COMPACT_AT:
                self._seq = self._bank.compact_seqs()
            idx = self._victim()
            evicted = self._entries[idx]
            if evicted is not None:
                self._demote(idx, evicted)
                self._key_to_slot.pop(evicted.key, None)
                self.size -= 1
            if idx == self._tail:
                self._tail += 1
            self._entries[idx] = Entry(
                te.key, te.query, te.response, dict(te.meta),
                te.created_at, te.expires_at,
            )
            self._key_to_slot[te.key] = idx
            self._next_key = max(self._next_key, te.key + 1)
            self._bank.note_insert(
                self._lane,
                idx,
                self._seq,
                created=self._bank.to_rel(te.created_at),
                expires=(
                    self._bank.to_rel(te.expires_at)
                    if np.isfinite(te.expires_at)
                    else None
                ),
                count=int(te.access_count),
            )
            self._seq += 1
            self.size += 1
            idxs.append(idx)
            if self._host_rows is not None:
                self._host_rows[idx] = rows[j]
        # promotions stage through pinned host memory where available so the
        # restore scatter's H2D copy overlaps the read dispatch (CPU: pageable)
        self._bank.set_rows(self._lane, idxs, rows, pinned=True)

    def search(self, q_vec: np.ndarray, k: int = 4) -> List[Tuple[float, Entry]]:
        return self.search_batch(np.asarray(q_vec)[None], k)[0]

    def search_batch(
        self, q_vecs: np.ndarray, k: int = 4, touch: bool = True
    ) -> List[List[Tuple[float, Entry]]]:
        """Top-k candidates for Q queries in one device dispatch.

        ``touch=False`` returns candidates without bumping LRU/LFU
        recency/frequency counters — callers that search speculatively (the
        hierarchy probes every level up front) apply ``touch_keys`` later,
        only on the levels a sequential walk would actually have probed.
        """
        if self.size == 0:
            return [[] for _ in range(len(q_vecs))]
        k_eff = min(k, self.capacity)
        s, idx = self._bank.search_lane(
            self._lane, np.asarray(q_vecs, np.float32), k_eff
        )
        return self.join_candidates(s, idx, touch=touch)

    def join_candidates(
        self, scores: np.ndarray, idx: np.ndarray, touch: bool = True
    ) -> List[List[Tuple[float, Entry]]]:
        """Join raw (scores [Q, k], slot idx [Q, k]) search output against the
        host-side entries — the step shared by this store's ``search_batch``
        and the hierarchy's fused all-lanes lookup, which searches the whole
        bank in one dispatch and joins each lane's slice here. (The fully
        fused read path never comes through here for touches — its bumps are
        a scatter-add inside the read program itself.)"""
        out: List[List[Tuple[float, Entry]]] = []
        touched: List[int] = []
        for srow, irow in zip(scores, idx):
            row = []
            for sc, i in zip(srow, irow):
                if int(i) >= self.capacity:
                    continue  # shared-bank padding lane rows beyond our capacity
                e = self._entries[int(i)]
                if not np.isfinite(sc) or e is None:
                    continue
                # same recency/frequency bookkeeping as the single-query path,
                # so eviction behaves identically under batched lookups — now
                # ONE device scatter for the whole join instead of a host loop
                if touch:
                    touched.append(int(i))
                row.append((float(sc), e))
            out.append(row)
        if touched:
            self._bank.touch_slots([self._lane] * len(touched), touched)
        return out

    def touch_keys(self, keys) -> None:
        """Deferred LRU/LFU bookkeeping: one bump per occurrence (one device
        scatter for the whole key list), matching what per-query sequential
        probes would have recorded. Keys evicted since the search are
        skipped."""
        idxs = [
            idx for idx in (self._key_to_slot.get(key) for key in keys)
            if idx is not None
        ]
        if idxs:
            self._bank.touch_slots([self._lane] * len(idxs), idxs)

    def remove(self, key: int) -> bool:
        idx = self._key_to_slot.pop(key, None)
        if idx is None:
            return False
        self._entries[idx] = None
        # free_slots resets the ENTIRE metadata row (validity + recency/
        # frequency/insertion counters + created/expires), so a reused slot
        # is indistinguishable from a fresh one
        self._bank.free_slots([self._lane], [idx])
        self._free.append(idx)
        self.size -= 1
        return True

    def clear(self, older_than: Optional[float] = None) -> int:
        """Drop entries: all of them, or — with ``older_than`` (seconds) —
        entries created more than that long ago plus anything already
        expired. One batched free scatter; cascades into the attached
        tier-1 ring. Returns the number of entries dropped across tiers."""
        now = time.time()
        cutoff = None if older_than is None else now - float(older_than)
        drop: List[int] = []
        for idx, e in enumerate(self._entries):
            if e is None:
                continue
            if cutoff is None or e.created_at <= cutoff or e.expires_at <= now:
                drop.append(idx)
        for idx in drop:
            self._key_to_slot.pop(self._entries[idx].key, None)
            self._entries[idx] = None
            self._free.append(idx)
            self.size -= 1
        if drop:
            self._bank.free_slots([self._lane] * len(drop), drop)
        dropped = len(drop)
        if self.tier1 is not None:
            dropped += self.tier1.clear(older_than=older_than)
        return dropped

    def __len__(self) -> int:
        return self.size

    # -- persistence (fault tolerance / warm start) ---------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(
            os.path.join(path, "vectors.npz"),
            buf=self._buf.cpu().numpy(),
            valid=self._valid.cpu().numpy(),
            last_access=np.asarray(self._last_access),
            access_count=np.asarray(self._access_count),
            insert_seq=np.asarray(self._insert_seq),
            # absolute unix stamps (f64): snapshots survive process restarts,
            # so the bank-relative clock cannot be persisted directly
            created_at=np.array(
                [0.0 if e is None else e.created_at for e in self._entries],
                np.float64,
            ),
            expires_at=np.array(
                [np.inf if e is None else e.expires_at for e in self._entries],
                np.float64,
            ),
        )
        manifest = {
            "dim": self.dim,
            "capacity": self.capacity,
            "metric": self.metric,
            "eviction": self.eviction,
            "size": self.size,
            "tail": self._tail,
            "next_key": self._next_key,
            "seq": self._seq,
            # cosine banks persist unit rows; loaders skip re-normalization
            "normalized": self._bank.prenorm[self._lane],
            # device counters persist as logical int32 ticks (order-preserving);
            # loaders rank-transform legacy wall-clock float stamps
            "counter_rep": "tick",
            "default_ttl_s": self.default_ttl_s,
            "staleness_weight": self.staleness_weight,
            "entries": [
                None if e is None else {"key": e.key, "query": e.query, "response": e.response, "meta": e.meta}
                for e in self._entries
            ],
        }
        tmp = os.path.join(path, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(path, "manifest.json"))  # atomic commit

    @classmethod
    def load(cls, path: str, **kwargs) -> "InMemoryVectorStore":
        with open(os.path.join(path, "manifest.json")) as f:
            m = json.load(f)
        kwargs.setdefault("default_ttl_s", m.get("default_ttl_s"))
        kwargs.setdefault("staleness_weight", m.get("staleness_weight", 0.0) or 0.0)
        store = cls(m["dim"], m["capacity"], m["metric"], m["eviction"], **kwargs)
        z = np.load(os.path.join(path, "vectors.npz"))
        buf = np.asarray(z["buf"], np.float32)
        if store._bank.prenormalized and not m.get("normalized", False):
            # pre-bank snapshot: raw rows on disk, the bank expects unit rows
            norms = np.maximum(np.linalg.norm(buf, axis=-1, keepdims=True), 1e-9)
            buf = buf / norms
        store._bank.buf = torch.as_tensor(buf, device=store._bank.device)[None].contiguous()
        store._bank.valid = torch.as_tensor(
            np.asarray(z["valid"], bool), device=store._bank.device
        )[None].contiguous()
        last = np.asarray(z["last_access"])
        if m.get("counter_rep") != "tick":
            # pre-device-counter snapshot: float wall-clock stamps on disk.
            # Rank-transform into the tick representation — order (and ties)
            # preserved, which is all lru/fifo argmin victim selection uses.
            last = np.unique(last, return_inverse=True)[1].astype(np.int64)
        store._bank.set_counters(
            last[None], np.asarray(z["access_count"])[None],
            np.asarray(z["insert_seq"])[None],
        )
        store.size = m["size"]
        store._next_key = m["next_key"]
        store._seq = m["seq"]
        # lifecycle stamps ride in the npz as absolute f64 (legacy snapshots
        # lack them: created 0 / expires inf, i.e. immortal)
        cap = m["capacity"]
        created = np.asarray(z["created_at"], np.float64) if "created_at" in z else np.zeros(cap)
        expires = np.asarray(z["expires_at"], np.float64) if "expires_at" in z else np.full(cap, np.inf)
        store._entries = [
            None
            if e is None
            else Entry(
                e["key"], e["query"], e["response"], e.get("meta", {}),
                float(created[i]), float(expires[i]),
            )
            for i, e in enumerate(m["entries"])
        ]
        rel_c = np.array([StoreBank.to_rel(c) for c in created], np.float64)
        rel_e = np.array([StoreBank.to_rel(x) for x in expires], np.float64)
        store._bank.set_lifecycle(rel_c[None], rel_e[None])
        store._tail = m.get("tail", m["size"])
        store._key_to_slot = {
            e.key: i for i, e in enumerate(store._entries) if e is not None
        }
        store._free = [i for i in range(store._tail) if store._entries[i] is None]
        return store
