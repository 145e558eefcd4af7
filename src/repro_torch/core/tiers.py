"""Capacity tiers behind the device bank.

The device ``StoreBank`` is tier 0: fast, searched by the fused read
program, but capped at HBM. This module adds the two layers behind it:

- ``HostRamTier`` (tier 1): a host-RAM ring per lane (numpy, optionally
  mmap-backed). Eviction victims demote here instead of vanishing; the
  read path consults it host-side only after a tier-0 miss, so the fused
  hot path stays one dispatch / zero host hops. Tier-1 hits promote back
  into the device lane through the same batched row-scatter inserts use.
- ``SnapshotTier`` (tier 2): a persistent export/import of a store's full
  contents (tier 0 + tier 1) for warm-starts and cross-deployment cache
  sharing (§4 "bring a cache to a warm state").

Entries keep their identity across tiers: ``TierEntry`` carries the key,
texts, lifecycle stamps, and access count, so a demote -> promote
roundtrip is byte-identical to never having left the device.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class TierEntry:
    """A cache entry in transit between tiers — everything needed to
    reconstruct it exactly where it lands."""

    key: int
    query: str
    response: str
    meta: Dict[str, Any] = field(default_factory=dict)
    created_at: float = 0.0  # absolute unix seconds
    expires_at: float = float("inf")
    access_count: int = 0

    def expired(self, now: Optional[float] = None) -> bool:
        return self.expires_at <= (time.time() if now is None else now)


def _normalize(rows: np.ndarray) -> np.ndarray:
    norms = np.maximum(np.linalg.norm(rows, axis=-1, keepdims=True), 1e-9)
    return rows / norms


def _host_scores(db: np.ndarray, q: np.ndarray, metric: str) -> np.ndarray:
    """Numpy twin of store_bank._lane_scores: [N, D] x [Q, D] -> [Q, N],
    higher = more similar. Cosine rows are stored unit-norm (mirroring the
    prenormalized device bank), so only the query needs normalizing."""
    q = np.asarray(q, np.float32)
    if metric == "cosine":
        return _normalize(q) @ db.T
    if metric == "dot":
        return q @ db.T
    if metric == "euclidean":
        d2 = (
            np.sum(q * q, -1)[:, None]
            - 2.0 * (q @ db.T)
            + np.sum(db * db, -1)[None, :]
        )
        return -np.sqrt(np.maximum(d2, 0.0))
    raise ValueError(f"unknown metric {metric!r}")


class HostRamTier:
    """Fixed-capacity host-RAM ring holding demoted entries.

    Off the hot path by construction: ``put`` is a numpy row copy at
    eviction time, ``search`` is a host matmul run only for queries that
    already missed tier 0. ``mmap_path`` backs the vector block with a
    file-mapped array so a large tier 1 doesn't compete with the host
    working set for RAM.
    """

    def __init__(
        self,
        dim: int,
        capacity: int = 65536,
        metric: str = "cosine",
        staleness_weight: float = 0.0,
        mmap_path: Optional[str] = None,
    ):
        assert capacity > 0
        self.dim = dim
        self.capacity = capacity
        self.metric = metric
        self.staleness_weight = float(staleness_weight)
        if mmap_path is not None:
            os.makedirs(os.path.dirname(mmap_path) or ".", exist_ok=True)
            self._vecs = np.lib.format.open_memmap(
                mmap_path, mode="w+", dtype=np.float32, shape=(capacity, dim)
            )
        else:
            self._vecs = np.zeros((capacity, dim), np.float32)
        self._entries: List[Optional[TierEntry]] = [None] * capacity
        self._key_to_slot: Dict[int, int] = {}
        self._ptr = 0  # ring head: oldest demotion is overwritten first
        self.size = 0
        self.demotions = 0
        self.promotions = 0

    def __len__(self) -> int:
        return self.size

    # -- demote ------------------------------------------------------------

    def put(self, entry: TierEntry, vec: np.ndarray) -> int:
        """Accept a demoted entry (ring-overwrite of the oldest demotion
        once full; a re-demoted key overwrites its stale tier copy)."""
        row = np.asarray(vec, np.float32).reshape(self.dim)
        if self.metric == "cosine":
            row = _normalize(row[None])[0]
        slot = self._key_to_slot.get(entry.key)
        if slot is None:
            slot = self._ptr
            self._ptr = (self._ptr + 1) % self.capacity
            old = self._entries[slot]
            if old is not None:
                self._key_to_slot.pop(old.key, None)
                self.size -= 1
            self.size += 1
        self._entries[slot] = entry
        self._key_to_slot[entry.key] = slot
        self._vecs[slot] = row
        self.demotions += 1
        return slot

    # -- consult (tier-0 miss only) -----------------------------------------

    def search(
        self, q_vecs: np.ndarray, k: int = 1, now: Optional[float] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the ring with the SAME lifecycle rules as tier 0:
        expired entries score -inf (never served), TTL'd live entries lose
        ``staleness_weight * clip(age/ttl, 0, 1)``. Returns (effective
        scores [Q, k], slots [Q, k])."""
        q = np.atleast_2d(np.asarray(q_vecs, np.float32))
        nq = q.shape[0]
        k = max(1, min(k, self.capacity))
        if self.size == 0:
            return (
                np.full((nq, k), -np.inf, np.float32),
                np.zeros((nq, k), np.int64),
            )
        now = time.time() if now is None else now
        s = _host_scores(self._vecs, q, self.metric).astype(np.float32)
        dead = np.array(
            [e is None or e.expires_at <= now for e in self._entries], bool
        )
        s[:, dead] = -np.inf
        if self.staleness_weight != 0.0:
            pen = np.zeros(self.capacity, np.float32)
            for i, e in enumerate(self._entries):
                if e is None or dead[i] or not np.isfinite(e.expires_at):
                    continue
                ttl = max(e.expires_at - e.created_at, 1e-6)
                pen[i] = self.staleness_weight * min(max((now - e.created_at) / ttl, 0.0), 1.0)
            s = s - pen[None, :]
        order = np.argsort(-s, axis=-1, kind="stable")[:, :k]
        return np.take_along_axis(s, order, -1), order.astype(np.int64)

    def get(self, slot: int) -> Optional[TierEntry]:
        return self._entries[slot]

    # -- promote -------------------------------------------------------------

    def pop(self, slot: int) -> Tuple[TierEntry, np.ndarray]:
        """Remove and return (entry, vector) for promotion back to tier 0."""
        e = self._entries[slot]
        assert e is not None, "pop() of an empty tier-1 slot"
        self._entries[slot] = None
        self._key_to_slot.pop(e.key, None)
        self.size -= 1
        self.promotions += 1
        return e, np.array(self._vecs[slot], np.float32)

    # -- maintenance ---------------------------------------------------------

    def clear(self, older_than: Optional[float] = None) -> int:
        """Drop everything, or with ``older_than`` (seconds) only entries
        created more than that long ago plus anything expired."""
        now = time.time()
        cutoff = None if older_than is None else now - float(older_than)
        dropped = 0
        for i, e in enumerate(self._entries):
            if e is None:
                continue
            if cutoff is None or e.created_at <= cutoff or e.expires_at <= now:
                self._entries[i] = None
                self._key_to_slot.pop(e.key, None)
                self.size -= 1
                dropped += 1
        return dropped

    def snapshot_entries(self) -> List[Tuple[TierEntry, np.ndarray]]:
        """Live (entry, vector) pairs, oldest demotion first (export order)."""
        out = []
        for off in range(self.capacity):
            slot = (self._ptr + off) % self.capacity
            e = self._entries[slot]
            if e is not None:
                out.append((e, np.array(self._vecs[slot], np.float32)))
        return out


class SnapshotTier:
    """Tier 2: persistent snapshot export/import for warm-starts and
    cross-deployment cache sharing.

    ``export_from`` captures a store's full live contents — device lane
    (tier 0) plus any attached host ring (tier 1) — as one npz + manifest
    under ``path``. ``import_into`` replays a snapshot into any compatible
    store: entries are re-keyed into the target's key space but keep their
    lifecycle stamps and access counts, already-expired entries are skipped,
    and rows arrive oldest-created first so when the snapshot exceeds the
    device capacity the newest entries stay in tier 0 and the overflow
    demotes naturally into the target's tier 1.
    """

    def __init__(self, path: str):
        self.path = path

    def _vec_path(self) -> str:
        return os.path.join(self.path, "snapshot.npz")

    def _manifest_path(self) -> str:
        return os.path.join(self.path, "snapshot.json")

    def export_from(self, store) -> int:
        """Snapshot every live, unexpired entry of ``store`` (tier 0 then
        tier 1). One device pull of the lane rows — fine off the hot path."""
        now = time.time()
        rows: List[np.ndarray] = []
        items: List[dict] = []
        lane_rows = np.asarray(store._buf)  # [cap, D] device pull
        counts = np.asarray(store._access_count)
        for idx, e in enumerate(store._entries):
            if e is None or e.expires_at <= now:
                continue
            rows.append(np.asarray(lane_rows[idx], np.float32))
            items.append(
                {
                    "query": e.query,
                    "response": e.response,
                    "meta": e.meta,
                    "created_at": e.created_at,
                    "expires_at": None if not np.isfinite(e.expires_at) else e.expires_at,
                    "access_count": int(counts[idx]),
                }
            )
        if getattr(store, "tier1", None) is not None:
            for e, vec in store.tier1.snapshot_entries():
                if e.expires_at <= now:
                    continue
                rows.append(vec)
                items.append(
                    {
                        "query": e.query,
                        "response": e.response,
                        "meta": e.meta,
                        "created_at": e.created_at,
                        "expires_at": None if not np.isfinite(e.expires_at) else e.expires_at,
                        "access_count": int(e.access_count),
                    }
                )
        os.makedirs(self.path, exist_ok=True)
        vecs = (
            np.stack(rows) if rows else np.zeros((0, store.dim), np.float32)
        )
        np.savez(self._vec_path(), vecs=vecs)
        manifest = {"dim": store.dim, "metric": store.metric, "entries": items}
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, self._manifest_path())  # atomic commit
        return len(items)

    def count(self) -> int:
        if not os.path.exists(self._manifest_path()):
            return 0
        with open(self._manifest_path()) as f:
            return len(json.load(f)["entries"])

    def import_into(self, store) -> int:
        """Warm-start ``store`` from the snapshot. Returns entries imported
        (expired rows in the snapshot are dropped on the way in)."""
        with open(self._manifest_path()) as f:
            m = json.load(f)
        assert m["dim"] == store.dim, "snapshot dim mismatch"
        vecs = np.load(self._vec_path())["vecs"]
        now = time.time()
        live = []
        for i, it in enumerate(m["entries"]):
            expires = float("inf") if it["expires_at"] is None else it["expires_at"]
            if expires <= now:
                continue
            live.append((it["created_at"], i, it, expires))
        # oldest first: the newest entries land last and therefore survive
        # in tier 0 when the snapshot overflows the device capacity
        live.sort(key=lambda t: (t[0], t[1]))
        if not live:
            return 0
        entries = []
        for created, i, it, expires in live:
            key = store._next_key
            store._next_key += 1  # re-key into the target's key space
            entries.append(
                TierEntry(
                    key=key,
                    query=it["query"],
                    response=it["response"],
                    meta=dict(it.get("meta") or {}),
                    created_at=created,
                    expires_at=expires,
                    access_count=int(it.get("access_count", 0)),
                )
            )
        rows = vecs[[i for _, i, _, _ in live]]
        store._restore_batch(rows, entries)
        return len(entries)

    def clear(self) -> int:
        dropped = self.count()
        for p in (self._vec_path(), self._manifest_path()):
            if os.path.exists(p):
                os.remove(p)
        return dropped
