"""Semantic cache (and the GPTCache-like baseline for the §6.1 comparison).

A lookup embeds the query, searches the vector store, and declares a hit when
the best similarity exceeds the *effective* threshold t_s — which is not a
constant: it is computed per query by the ThresholdPolicy (content type,
model cost/latency, connectivity, user preference; §2) and servoed over time
by the feedback controllers (§3.1).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.embeddings import EmbeddingModel
from repro_torch.core.vector_store import Entry, InMemoryVectorStore


@dataclass
class CacheResult:
    hit: bool
    response: Optional[str] = None
    similarity: float = -1.0
    combined_similarity: float = 0.0
    generative: bool = False
    sources: List[Tuple[float, Entry]] = field(default_factory=list)
    threshold_used: float = 0.0
    latency_s: float = 0.0
    level: str = "miss"


@dataclass
class CacheStats:
    lookups: int = 0
    hits: int = 0
    generative_hits: int = 0
    tier1_hits: int = 0  # tier-0 misses served from the host-RAM tier
    stale_hits: int = 0  # expired entries served stale-if-error (backends down)
    adds: int = 0
    embed_time_s: float = 0.0
    search_time_s: float = 0.0
    add_time_s: float = 0.0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class SemanticCache:
    def __init__(
        self,
        embedder: EmbeddingModel,
        threshold: float = 0.8,
        capacity: int = 4096,
        metric: str = "cosine",
        eviction: str = "lru",
        policy=None,  # ThresholdPolicy (repro_torch.core.adaptive)
        store: Optional[InMemoryVectorStore] = None,
        use_pallas: bool = False,
        device=None,  # store device: None = CUDA (raises without one), or "cpu"
    ):
        """``use_pallas=True`` searches through the ``similarity_topk``
        kernel wrapper; it is opt-in (off by default), as in the reference.
        ``chip_smoke.py`` and the serving parity test run it on."""
        self.embedder = embedder
        self.threshold = threshold
        self.policy = policy
        # note: `store or ...` would discard an *empty* store (len == 0 is falsy)
        self.store = (
            store
            if store is not None
            else InMemoryVectorStore(
                embedder.dim, capacity, metric, eviction, use_pallas=use_pallas,
                device=device,
            )
        )
        self.stats = CacheStats()

    # -- thresholds -----------------------------------------------------------

    def effective_threshold(self, query: str, context: Optional[dict] = None) -> float:
        if self.policy is not None:
            return self.policy.compute(query, context or {})
        return self.threshold

    # -- embedding ------------------------------------------------------------

    def embed(self, query: str) -> np.ndarray:
        t0 = time.perf_counter()
        v = self.embedder.embed_one(query)
        self.stats.embed_time_s += time.perf_counter() - t0
        return v

    def embed_batch(self, queries: List[str]) -> np.ndarray:
        """Embed a request batch in one model forward ([B, L] tokens)."""
        t0 = time.perf_counter()
        v = self.embedder.embed_batch(list(queries))
        self.stats.embed_time_s += time.perf_counter() - t0
        return v

    # -- candidate search (shared with the hierarchy) ----------------------------

    def search_candidates(
        self, vecs: np.ndarray, k: int, touch: bool = True
    ) -> List[List[Tuple[float, Entry]]]:
        """One timed store search for the whole batch. ``touch=False`` defers
        LRU/LFU bookkeeping to the caller — the hierarchy probes every level
        speculatively and bumps only levels a sequential walk would reach."""
        t0 = time.perf_counter()
        try:
            matches = self.store.search_batch(np.asarray(vecs), k=k, touch=touch)
        except TypeError:  # store without deferred-bookkeeping support
            matches = self.store.search_batch(np.asarray(vecs), k=k)
        self.stats.search_time_s += time.perf_counter() - t0
        return matches

    def touch(self, keys) -> None:
        """Apply deferred recency/frequency bookkeeping (no-op for stores
        without eviction counters, e.g. the sharded store)."""
        touch_keys = getattr(self.store, "touch_keys", None)
        if touch_keys is not None and keys:
            touch_keys(keys)

    # -- tier-1 consult (tier-0 miss only; host-side, off the fused path) -------

    def consult_tier1(
        self, queries: List[str], vecs: np.ndarray, thresholds, rows: List[int]
    ) -> Dict[int, CacheResult]:
        """Consult the store's host-RAM demotion tier for the listed miss
        rows. Hits promote back into the device lane via the same batched
        row scatter inserts ride (one scatter for all winners), then resolve
        as hits at level "tier1". Runs only after a tier-0 miss, so the
        fused read program stays one dispatch / zero host hops."""
        tier = getattr(self.store, "tier1", None)
        if tier is None or len(tier) == 0 or not rows:
            return {}
        vecs = np.asarray(vecs, np.float32)
        sc, slots = tier.search(vecs[rows], k=1)
        winners = []  # (batch row, effective score, tier slot)
        for j, i in enumerate(rows):
            s = float(sc[j, 0])
            if np.isfinite(s) and s > float(thresholds[i]):
                winners.append((i, s, int(slots[j, 0])))
        if not winners:
            return {}
        popped: Dict[int, tuple] = {}  # slot -> (TierEntry, vec); pop once
        for _, _, slot in winners:
            if slot not in popped:
                popped[slot] = tier.pop(slot)
        self.store._restore_batch(
            np.stack([v for _, v in popped.values()]),
            [e for e, _ in popped.values()],
        )
        out: Dict[int, CacheResult] = {}
        # the sharded store keeps (query, response) payloads, not Entry rows —
        # reconstruct from the TierEntry there
        entry_table = getattr(self.store, "_entries", None)
        for i, s, slot in winners:
            te = popped[slot][0]
            idx = self.store._key_to_slot.get(te.key)
            entry = (
                entry_table[idx]
                if idx is not None and entry_table is not None
                else Entry(te.key, te.query, te.response, dict(te.meta),
                           te.created_at, te.expires_at)
            )
            self.stats.hits += 1
            self.stats.tier1_hits += 1
            out[i] = CacheResult(
                True, entry.response, s, s, False, [(s, entry)],
                float(thresholds[i]), 0.0, "tier1",
            )
        return out

    # -- stale-if-error lookup (degraded path; resilience subsystem) ------------

    def lookup_stale(
        self,
        queries: List[str],
        vecs: np.ndarray,
        thresholds,
        now: Optional[float] = None,
        max_stale_s=None,
    ) -> Dict[int, CacheResult]:
        """Serve EXPIRED entries when every backend is down (stale-if-error).

        Host-side scan over tier 0's entry table plus the tier-1 ring —
        deliberately off the fused path: this runs only after the failover
        walk exhausted every backend, where a host matmul is noise next to
        the outage. An entry qualifies when it expires (or expired) after
        ``now - max_stale_s`` (``max_stale_s=None`` accepts any age; live
        entries qualify trivially). The winner must still clear the row's
        threshold. Nothing is promoted and no recency/frequency counters
        move — a dead backend must not reshape the eviction order.
        ``max_stale_s`` may be a scalar or a per-row sequence; returns
        row -> CacheResult at level ``stale:tier0`` / ``stale:tier1``.
        """
        from repro_torch.core.tiers import _host_scores, _normalize

        q = np.atleast_2d(np.asarray(vecs, np.float32))
        nq = q.shape[0]
        now = time.time() if now is None else now
        if max_stale_s is None or np.isscalar(max_stale_s):
            stales = [max_stale_s] * nq
        else:
            stales = list(max_stale_s)
        floors = np.array(
            [-np.inf if s is None else now - float(s) for s in stales], np.float64
        )

        def _best(db, expires):  # [N, D] rows + [N] expiry stamps -> per-row best
            if db.shape[0] == 0:
                return np.full(nq, -np.inf, np.float32), np.full(nq, -1, np.int64)
            rows = _normalize(db) if self.store.metric == "cosine" else db
            s = _host_scores(rows, q, self.store.metric).astype(np.float32)
            ok = expires[None, :] > floors[:, None]
            s = np.where(ok, s, -np.inf)
            j = np.argmax(s, axis=-1)
            return s[np.arange(nq), j], j

        out: Dict[int, CacheResult] = {}
        # tier 0: the entry table keeps expired rows until eviction reclaims
        # them — exactly the stale inventory this path serves
        entries = getattr(self.store, "_entries", None)
        if entries is not None:
            t0_idx = [i for i, e in enumerate(entries) if e is not None]
            if t0_idx:
                host = self.store._host_rows
                allrows = (
                    host if host is not None else np.asarray(self.store._buf, np.float32)
                )
                db = np.asarray(allrows, np.float32)[t0_idx]
                exp = np.array([entries[i].expires_at for i in t0_idx], np.float64)
                best, j = _best(db, exp)
                for r in range(nq):
                    if np.isfinite(best[r]) and best[r] > float(thresholds[r]):
                        e = entries[t0_idx[int(j[r])]]
                        out[r] = CacheResult(
                            True, e.response, float(best[r]), float(best[r]), False,
                            [(float(best[r]), e)], float(thresholds[r]), 0.0,
                            "stale:tier0",
                        )
        tier = getattr(self.store, "tier1", None)
        if tier is not None and len(tier) > 0:
            t1_idx = [i for i, e in enumerate(tier._entries) if e is not None]
            if t1_idx:
                db = np.asarray(tier._vecs, np.float32)[t1_idx]
                exp = np.array([tier._entries[i].expires_at for i in t1_idx], np.float64)
                best, j = _best(db, exp)
                for r in range(nq):
                    if r in out:
                        continue  # tier 0 already answered this row
                    if np.isfinite(best[r]) and best[r] > float(thresholds[r]):
                        te = tier._entries[t1_idx[int(j[r])]]
                        from repro_torch.core.vector_store import Entry as _Entry

                        e = _Entry(te.key, te.query, te.response, dict(te.meta),
                                   te.created_at, te.expires_at)
                        out[r] = CacheResult(
                            True, e.response, float(best[r]), float(best[r]), False,
                            [(float(best[r]), e)], float(thresholds[r]), 0.0,
                            "stale:tier1",
                        )
        if out:
            self.stats.stale_hits += len(out)
        return out

    # -- lookup / insert --------------------------------------------------------

    def lookup(
        self, query: str, context: Optional[dict] = None, vec: Optional[np.ndarray] = None
    ) -> CacheResult:
        t_start = time.perf_counter()
        self.stats.lookups += 1
        t_s = self.effective_threshold(query, context)
        if vec is None:
            vec = self.embed(query)
        t0 = time.perf_counter()
        matches = self.store.search(vec, k=1)
        self.stats.search_time_s += time.perf_counter() - t0
        if matches and matches[0][0] > t_s:
            score, entry = matches[0]
            self.stats.hits += 1
            return CacheResult(
                True, entry.response, score, score, False, [(score, entry)], t_s,
                time.perf_counter() - t_start, "semantic",
            )
        promoted = self.consult_tier1([query], np.asarray(vec)[None], [t_s], [0])
        if 0 in promoted:
            r = promoted[0]
            r.latency_s = time.perf_counter() - t_start
            return r
        best = matches[0][0] if matches else -1.0
        return CacheResult(
            False, None, best, best, False, matches[:1], t_s, time.perf_counter() - t_start
        )

    def _solo_k(self) -> int:
        """Candidates a standalone batched lookup searches (and touches)."""
        return 1

    def _fused_read_decision(self, queries, thresholds, vecs):
        """Try the zero-host-hop read program for a standalone lookup: one
        device dispatch covering embed -> search -> decide -> touch. Returns
        (ReadDecision, k) or (None, 0) when ineligible — customized decide
        logic, a non-bankable store, a store adopted into a multi-lane bank
        (a solo search must stay lane-scoped), or an empty store."""
        from repro_torch.core import read_path

        store = self.store
        if (
            not read_path.store_bankable(store)
            or store._bank.L != 1
            or len(store) == 0
        ):
            return None, 0
        k = min(max(self._solo_k(), 1), store.capacity)
        spec = read_path.level_spec(self, k)
        if spec is None:
            return None, 0
        t0 = time.perf_counter()
        dec = read_path.fused_read(
            store._bank, self.embedder, queries,
            np.asarray(thresholds, np.float32).reshape(-1, 1), (spec,), vecs=vecs,
        )
        self.stats.search_time_s += time.perf_counter() - t0
        return dec, k

    def lookup_batch(
        self,
        queries: List[str],
        contexts: Optional[List[Optional[dict]]] = None,
        vecs: Optional[np.ndarray] = None,
        return_vecs: bool = False,
    ):
        """Batched lookup: one fused device program (embed + search + decide
        masks + counter touches — see repro_torch.core.read_path) for B queries,
        or one embed forward + one store search when the store/decide logic
        is customized. ``return_vecs=True`` additionally returns the [B, D]
        embeddings (the serving path reuses them for dedup/backfill).

        Decision-identical to B sequential ``lookup`` calls against the same
        store snapshot (per-query effective thresholds applied vectorized);
        store contents are not mutated by the decisions themselves, so
        results do not depend on the order of queries within the batch.
        """
        t_start = time.perf_counter()
        n = len(queries)
        if n == 0:
            empty = np.zeros((0, self.embedder.dim), np.float32)
            return ([], empty) if return_vecs else []
        contexts = list(contexts) if contexts is not None else [None] * n
        self.stats.lookups += n
        thresholds = np.asarray(
            [self.effective_threshold(q, c) for q, c in zip(queries, contexts)]
        )
        dec, k = self._fused_read_decision(queries, thresholds, vecs)
        if dec is not None:
            matches = [
                m[:k]
                for m in self.store.join_candidates(
                    dec.scores[:, 0], dec.idx[:, 0], touch=False
                )
            ]
            results, to_insert = self._materialize_batch(
                queries, thresholds, matches, dec.hit[:, 0], dec.generative[:, 0]
            )
            vecs = dec.vecs
        else:
            if vecs is None:
                vecs = self.embed_batch(list(queries))
            t0 = time.perf_counter()
            matches = self.store.search_batch(np.asarray(vecs), k=self._solo_k())
            self.stats.search_time_s += time.perf_counter() - t0
            results, to_insert = self._decide_batch(queries, thresholds, matches)
        misses = [i for i, r in enumerate(results) if not r.hit]
        if misses:
            promoted = self.consult_tier1(queries, vecs, thresholds, misses)
            for i, r in promoted.items():
                results[i] = r
        per_query_s = (time.perf_counter() - t_start) / n
        for r in results:
            r.latency_s = per_query_s
        if to_insert:
            # whole synthesized set lands in one add_batch scatter
            self.insert_batch(
                [queries[i] for i, _ in to_insert],
                [r for _, r in to_insert],
                metas=[{"generative": True}] * len(to_insert),
                vecs=np.stack([np.asarray(vecs[i]) for i, _ in to_insert]),
            )
        return (results, np.asarray(vecs)) if return_vecs else results

    def _decide_batch(
        self,
        queries: List[str],
        thresholds: np.ndarray,
        matches: List[List[Tuple[float, Entry]]],
        lazy_synth: bool = False,
    ) -> Tuple[List[CacheResult], List[tuple]]:
        """Per-query hit decisions over pre-searched candidates.

        Shared by ``lookup_batch`` and ``HierarchicalCache.lookup_batch`` (the
        hierarchy runs one search per level and feeds each level's candidates
        through that level's own decision rule). Returns the results (latency
        left at 0 for the caller to fill) plus deferred ``(query_index,
        response)`` inserts — empty here, used by the generative subclass.
        """
        results: List[CacheResult] = []
        for i, m in enumerate(matches):
            t_s = float(thresholds[i])
            best = m[0][0] if m else -1.0
            if m and best > t_s:
                score, entry = m[0]
                self.stats.hits += 1
                results.append(
                    CacheResult(True, entry.response, score, score, False,
                                [(score, entry)], t_s, 0.0, "semantic")
                )
            else:
                results.append(
                    CacheResult(False, None, best, best, False, m[:1], t_s, 0.0)
                )
        return results, []

    # -- host materialization for the fused (device-decide) read path -----------

    def _materialize_one(
        self,
        query: str,
        t_s: float,
        m: List[Tuple[float, Entry]],
        hit: bool,
        gen: bool,
        lazy_synth: bool = False,
    ) -> Tuple[CacheResult, Optional[str]]:
        """Build one CacheResult from the device decide masks plus the joined
        candidates — the host half of ``_decide_batch`` after the comparisons
        moved in-program. Returns (result, deferred synthesized response or
        None). The generative subclass overrides this; here a hit is always
        a plain semantic hit."""
        if hit:
            score, entry = m[0]
            self.stats.hits += 1
            return (
                CacheResult(True, entry.response, score, score, False,
                            [(score, entry)], t_s, 0.0, "semantic"),
                None,
            )
        best = m[0][0] if m else -1.0
        return CacheResult(False, None, best, best, False, m[:1], t_s, 0.0), None

    def _materialize_batch(
        self,
        queries: List[str],
        thresholds: np.ndarray,
        matches: List[List[Tuple[float, Entry]]],
        hit: np.ndarray,
        gen: np.ndarray,
        lazy_synth: bool = False,
    ) -> Tuple[List[CacheResult], List[tuple]]:
        """Vector form of ``_materialize_one`` (same (results, deferred
        inserts) contract as ``_decide_batch``)."""
        results: List[CacheResult] = []
        to_insert: List[tuple] = []
        for i, m in enumerate(matches):
            r, ins = self._materialize_one(
                queries[i], float(thresholds[i]), m, bool(hit[i]), bool(gen[i]),
                lazy_synth,
            )
            results.append(r)
            if ins is not None:
                to_insert.append((i, ins))
        return results, to_insert

    def insert(
        self,
        query: str,
        response: str,
        meta: Optional[Dict[str, Any]] = None,
        vec: Optional[np.ndarray] = None,
        ttl_s: Optional[float] = None,
    ) -> int:
        if vec is None:
            vec = self.embed(query)
        t0 = time.perf_counter()
        if ttl_s is not None:
            key = self.store.add(vec, query, response, meta, ttl_s=ttl_s)
        else:  # stores without TTL support keep working unchanged
            key = self.store.add(vec, query, response, meta)
        self.stats.add_time_s += time.perf_counter() - t0
        self.stats.adds += 1
        return key

    def insert_batch(
        self,
        queries: List[str],
        responses: List[str],
        metas: Optional[List[Optional[Dict[str, Any]]]] = None,
        vecs: Optional[np.ndarray] = None,
        ttls: Optional[List[Optional[float]]] = None,
    ) -> List[int]:
        """Insert N pairs with one embed forward + one ``add_batch`` scatter."""
        n = len(queries)
        if n == 0:
            return []
        if vecs is None:
            vecs = self.embed_batch(list(queries))
        t0 = time.perf_counter()
        if ttls is not None and any(t is not None for t in ttls):
            keys = self.store.add_batch(
                np.asarray(vecs), list(queries), list(responses), metas, ttls=ttls
            )
        else:
            keys = self.store.add_batch(np.asarray(vecs), list(queries), list(responses), metas)
        self.stats.add_time_s += time.perf_counter() - t0
        self.stats.adds += n
        return keys

    def clear(self, older_than: Optional[float] = None) -> int:
        """Prune: everything, or entries older than ``older_than`` seconds
        (expired entries always qualify). Cascades through the store into
        any attached tier-1 ring."""
        clear = getattr(self.store, "clear", None)
        return int(clear(older_than=older_than)) if clear is not None else 0

    def warm_start(self, pairs: List[Tuple[str, str]]) -> None:
        """Load query-answer pairs from past sessions (paper §4)."""
        if not pairs:
            return
        vecs = self.embedder.embed([q for q, _ in pairs])
        self.insert_batch([q for q, _ in pairs], [a for _, a in pairs], vecs=vecs)

    # -- persistence ------------------------------------------------------------

    def save(self, path: str) -> None:
        self.store.save(path)

    def load_store(self, path: str) -> None:
        # reload through the live store's class with its flags, so a
        # use_pallas store (or a custom subclass) survives the round-trip
        self.store = type(self.store).load(
            path, use_pallas=self.store.use_pallas, device=self.store._bank.device
        )


class GPTCacheLike:
    """Architecture-shaped GPTCache baseline: per-entry python-loop scalar
    similarity over a row store (the SQLite-backed eval path the paper
    criticizes in §6.1). Same embedder as SemanticCache so the comparison
    isolates the cache data path."""

    def __init__(self, embedder: EmbeddingModel, threshold: float = 0.8):
        self.embedder = embedder
        self.threshold = threshold
        self.rows: List[Tuple[np.ndarray, Entry]] = []
        self._key = 0
        self.stats = CacheStats()

    def insert(self, query: str, response: str, vec: Optional[np.ndarray] = None) -> int:
        if vec is None:
            vec = self.embedder.embed_one(query)
        t0 = time.perf_counter()
        # row-store semantics: append a row, rebuild the "index" lazily
        self.rows.append((np.asarray(vec, np.float64), Entry(self._key, query, response)))
        self.stats.add_time_s += time.perf_counter() - t0
        self.stats.adds += 1
        self._key += 1
        return self._key - 1

    def lookup(self, query: str, vec: Optional[np.ndarray] = None) -> CacheResult:
        t_start = time.perf_counter()
        self.stats.lookups += 1
        if vec is None:
            vec = self.embedder.embed_one(query)
        v = np.asarray(vec, np.float64)
        t0 = time.perf_counter()
        best_s, best_e = -1.0, None
        for row_vec, entry in self.rows:  # per-row scalar evaluation
            num = 0.0
            na = 0.0
            nb = 0.0
            for a, b in zip(v, row_vec):
                num += a * b
                na += a * a
                nb += b * b
            s = num / max(np.sqrt(na) * np.sqrt(nb), 1e-9)
            if s > best_s:
                best_s, best_e = s, entry
        self.stats.search_time_s += time.perf_counter() - t0
        if best_e is not None and best_s > self.threshold:
            self.stats.hits += 1
            return CacheResult(True, best_e.response, best_s, best_s, False,
                               [(best_s, best_e)], self.threshold,
                               time.perf_counter() - t_start, "semantic")
        return CacheResult(False, None, best_s, best_s, False, [], self.threshold,
                           time.perf_counter() - t_start)
