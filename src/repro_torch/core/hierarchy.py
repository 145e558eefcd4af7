"""Hierarchical / cooperative caching (§4, Figure 1).

Client-local L1 caches front shared L2 caches; L2 caches cooperate with peer
L2s. On a lower-level hit the query-response pair is promoted into the upper
levels (the paper: "If the L2 cache is able to satisfy the request with a
query-response pair q1, q1 is then stored in the L1 cache"). The same
similarity threshold t_s(1) (the requesting client's effective threshold) is
used at every level. Privacy hints let users keep personal entries out of
the shared levels (§4) — and they always win: ``cache_l2=False`` is a hard
veto, even in an inclusive hierarchy. ``inclusive=True`` makes the shared L2
a superset of what this client serves: peer-level winners are mirrored into
L2 alongside their L1 promotion (safe — they already live in a shared
level), so cooperating clients converge on one shared working set.

``lookup_batch`` serves B queries with one embed forward and ONE fused
search dispatch for the WHOLE hierarchy: the level stores are stacked into
a shared ``StoreBank`` ([L, cap, D]; see repro_torch.core.store_bank), a single
``search_lanes`` dispatch returns [B, L, k] candidates, and each level's
slice goes through that level's own decision rule
(``SemanticCache._decide_batch`` / the generative override). The per-query
winning level is resolved host-side (L1 beats L2 beats peers) on the
returned scores — masking lower levels for queries L1 already answered
costs no extra dispatch — lower-level winners are promoted into L1 via one
``add_batch`` scatter, and residual misses get a batched cross-level
generative pass over the already searched candidates. Levels that cannot
share a bank fall back to one dispatch per level.

The reference's key-sharded tier (``ensure_sharded_bank`` over a
``ShardedVectorStore`` mesh, with its ``router`` lane mask) is not ported
yet: every level here is a single-device ``InMemoryVectorStore`` lane.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from repro_torch.core.generative_cache import GenerativeCache
from repro_torch.core.semantic_cache import CacheResult, SemanticCache
from repro_torch.core.store_bank import StoreBank
from repro_torch.core.vector_store import InMemoryVectorStore


class HierarchicalCache:
    def __init__(
        self,
        l1: GenerativeCache,
        l2: Optional[GenerativeCache] = None,
        peers: Optional[List[GenerativeCache]] = None,
        inclusive: bool = False,
        promote: bool = True,
        generative_across_levels: bool = True,
        fused: bool = True,
        device_decide: bool = True,
    ):
        self.l1 = l1
        self.l2 = l2
        self.peers = peers or []
        self.inclusive = inclusive
        self.promote = promote
        self.generative_across_levels = generative_across_levels
        # fused=True stacks the level stores into one StoreBank so a batched
        # lookup searches every level in ONE device dispatch; levels whose
        # stores cannot be banked (custom subclass, mixed dim, aliased
        # stores) transparently keep the per-level search loop.
        # device_decide=True additionally runs the whole read path — embed,
        # search, per-level thresholds + winner walk, and the LRU/LFU touch
        # scatter — as ONE device program (repro_torch.core.read_path); levels with
        # customized decide logic fall back to the banked host-decide path.
        self.fused = fused
        self.device_decide = device_decide
        self._shared_bank: Optional[StoreBank] = None

    def _levels(self):
        out = [("L1", self.l1)]
        if self.l2 is not None:
            out.append(("L2", self.l2))
        out.extend((f"L2-peer{i}", p) for i, p in enumerate(self.peers))
        return out

    def ensure_bank(self) -> Optional[StoreBank]:
        """Stack the level stores into one shared [L, cap, D] StoreBank (or
        return the current one if every level still points at its lane).

        Returns None — keeping the per-level search loop — when the levels
        cannot share a bank: fewer than two levels, a store subclass that
        overrides the search/join path, mixed dim/metric, or the same store
        object mounted at two levels (its lane view can only track one).
        A level whose store was swapped (e.g. ``load_store``) or adopted by
        another hierarchy triggers a re-adoption, which copies the stores'
        CURRENT lanes — never stale data."""
        caches = [c for _, c in self._levels()]
        stores = [c.store for c in caches]
        if len(stores) < 2:
            return None
        for c in caches:
            # the fused path replaces the cache-level retrieval hook too
            if type(c).search_candidates is not SemanticCache.search_candidates:
                return None
        for s in stores:
            if not isinstance(s, InMemoryVectorStore):
                return None
            if (
                type(s).search_batch is not InMemoryVectorStore.search_batch
                or type(s).join_candidates is not InMemoryVectorStore.join_candidates
            ):
                return None  # custom search semantics must keep running
        if len({id(s) for s in stores}) != len(stores):
            return None
        if len({s.dim for s in stores}) != 1:
            return None
        # per-lane metric tags cover mixed cosine/dot/euclidean hierarchies
        # in one bank; an unknown metric string keeps the per-level loop
        if any(s.metric not in ("cosine", "dot", "euclidean") for s in stores):
            return None
        bank = self._shared_bank
        if bank is not None and all(
            s._bank is bank and s._lane == li for li, s in enumerate(stores)
        ):
            return bank
        self._shared_bank = StoreBank.adopt(stores)
        return self._shared_bank

    # -- stale-if-error walk (degraded path; resilience subsystem) -------------

    def lookup_stale(
        self, queries, vecs, contexts, now=None, max_stale_s=None, l2_ok=None
    ):
        """Serve expired entries when every backend is down: walk the levels
        in hierarchy order (L1 > L2 > peers — the same priority a live
        lookup uses) and take the first level whose stale inventory clears
        that level's threshold for a row. ``l2_ok`` (per-row bools) carries
        the ``cache_l2`` privacy hint: a False row consults ONLY L1 — the
        degraded path must not leak a private query into shared levels. No
        promotion, no counter movement — see ``SemanticCache.lookup_stale``.
        Returns row -> CacheResult with the level name folded into
        ``level``."""
        out = {}
        for li, (name, cache) in enumerate(self._levels()):
            remaining = [
                r
                for r in range(len(queries))
                if r not in out and (li == 0 or l2_ok is None or l2_ok[r])
            ]
            if not remaining:
                continue
            thr = [
                cache.effective_threshold(queries[r], contexts[r]) for r in remaining
            ]
            sub_vecs = np.asarray(vecs, np.float32)[remaining]
            stales = (
                max_stale_s
                if max_stale_s is None or np.isscalar(max_stale_s)
                else [max_stale_s[r] for r in remaining]
            )
            found = cache.lookup_stale(
                [queries[r] for r in remaining], sub_vecs, thr,
                now=now, max_stale_s=stales,
            )
            for j, res in found.items():
                res.level = f"stale:{name}:{res.level.split(':', 1)[1]}"
                out[remaining[j]] = res
        return out

    # -- cross-level generative pool (§3 rule applied over every level) --------

    def _pool_candidates(self, level_matches: List[list]) -> List[tuple]:
        """Merge one query's per-level candidates into the generative pool:
        filter by the requesting client's t_single, dedupe across levels,
        best-first, capped at L1's max_sources (so N levels x k weak matches
        cannot clear t_combined when no single level would)."""
        pooled = []
        seen = set()
        for m in level_matches:
            for s, e in m:
                sig = (e.query, e.response[:64])
                if s > self.l1.t_single and sig not in seen:
                    seen.add(sig)
                    pooled.append((s, e))
        pooled.sort(key=lambda se: se[0], reverse=True)
        return pooled[: self.l1.max_sources]

    def lookup(
        self, query: str, context: Optional[dict] = None, vec: Optional[np.ndarray] = None
    ) -> CacheResult:
        t0 = time.perf_counter()
        if vec is None:
            vec = self.l1.embed(query)  # embed once; levels share the embedder space
        levels = self._levels()
        for name, cache in levels:
            res = cache.lookup(query, context, vec=vec)
            if res.hit:
                if self.promote and cache is not self.l1:
                    self.l1.insert(query, res.response, {"promoted_from": name}, vec=vec)
                    if self.inclusive and self.l2 is not None and cache is not self.l2:
                        # inclusive hierarchy: peer winners also land in our
                        # shared L2 (they came from a shared level, so the
                        # copy exposes nothing new)
                        self.l2.insert(query, res.response, {"promoted_from": name}, vec=vec)
                res.level = f"{name}:{res.level}"
                res.latency_s = time.perf_counter() - t0
                return res

        if self.generative_across_levels and len(levels) > 1:
            # pool candidates from every level and apply the generative rule
            pooled = self._pool_candidates([
                cache.store.search(vec, k=getattr(cache, "max_sources", 4))
                for _, cache in levels
            ])
            combined = float(sum(s for s, _ in pooled))
            if pooled and combined > self.l1.t_combined:
                from repro_torch.core import synthesis

                response = synthesis.combine(query, pooled, self.l1.synthesis_mode, self.l1.summarizer)
                self.l1.insert(query, response, {"generative": True}, vec=vec)
                self.l1.stats.generative_hits += 1
                return CacheResult(
                    True, response, pooled[0][0], combined, True, pooled,
                    self.l1.effective_threshold(query, context),
                    time.perf_counter() - t0, "multi-level:generative",
                )
        res = CacheResult(False)
        res.latency_s = time.perf_counter() - t0
        return res

    def lookup_batch(
        self,
        queries: List[str],
        contexts: Optional[List[Optional[dict]]] = None,
        vecs: Optional[np.ndarray] = None,
        return_vecs: bool = False,
    ):
        """Serve B queries; the whole read path is ONE device program.

        Decision-identical to B sequential ``lookup`` calls against the same
        level snapshots: every level is searched once for the whole batch,
        each level's decision rule runs over its own candidates, and the
        first level in L1 -> L2 -> peers order that hits wins. All store
        mutations (L1 promotion of lower-level winners, per-level synthesized
        answers, cross-level synthesized answers) are deferred past the last
        decision and applied as ``add_batch`` scatters, so in-batch queries
        never observe each other.

        Read tiers, fastest eligible wins: (a) the fused read program —
        embed forward, banked [L, cap, D] search, per-level decide masks,
        the L1>L2>peers winner walk, and the recency/frequency touch
        scatter on device, one search launch per batch, with
        host code only materializing ``CacheResult``s for decided winners
        and residual-miss pool rows; (b) the banked host-decide path (one
        fused search dispatch, decide on host) when a level customizes its
        decide rule; (c) the per-level search loop when stores cannot share
        a bank. ``return_vecs=True``
        additionally returns the [B, D] embeddings (serving reuses them for
        dedup/backfill without a second forward).
        """
        t0 = time.perf_counter()
        n = len(queries)
        if n == 0:
            empty = np.zeros((0, self.l1.embedder.dim), np.float32)
            return ([], empty) if return_vecs else []
        contexts = list(contexts) if contexts is not None else [None] * n
        levels = self._levels()
        # THE per-level candidate-count policy, shared by all three read
        # tiers (capacity cap only where the store exposes one — custom
        # stores without .capacity keep the uncapped per-level-loop k)
        ks = []
        for _, c in levels:
            k = max(getattr(c, "max_sources", 4), 1)
            cap = getattr(c.store, "capacity", None)
            ks.append(min(k, cap) if cap else k)
        # [n, L] per-query/per-level effective thresholds (host policy calls,
        # same call order as the per-level loop: levels outer, queries inner)
        thr = np.asarray(
            [
                [c.effective_threshold(q, ctx) for q, ctx in zip(queries, contexts)]
                for _, c in levels
            ],
            np.float64,
        ).T
        bank = self.ensure_bank() if self.fused else None
        dec = None
        if bank is not None and self.device_decide:
            from repro_torch.core import read_path

            specs = [
                read_path.level_spec(c, ks[li]) for li, (_, c) in enumerate(levels)
            ]
            if all(sp is not None for sp in specs):
                t0s = time.perf_counter()
                dec = read_path.fused_read(
                    bank, self.l1.embedder, queries, thr, specs, vecs=vecs
                )
                # the program is indivisible, so search_time_s absorbs the
                # whole fused wall time (embed leg included) split evenly —
                # slightly broader than the host tiers' search-only share
                share = (time.perf_counter() - t0s) / len(levels)
                for _, c in levels:
                    c.stats.search_time_s += share
        if dec is not None:
            vecs = dec.vecs
            out, promotions, l2_copies, deferred = self._materialize_fused(
                queries, contexts, thr, levels, ks, dec
            )
        else:
            if vecs is None:
                vecs = self.l1.embed_batch(list(queries))
            vecs = np.asarray(vecs)
            out, promotions, l2_copies, deferred = self._decide_host(
                queries, contexts, thr, levels, ks, vecs, bank
            )
        # residual misses consult each level's host-RAM demotion tier, in the
        # same L1 > L2 > peers priority as tier 0 (host-side; the fused
        # dispatch above is untouched). A tier-1 winner promotes into its own
        # level's device lane, and — like any lower-level winner — into L1.
        for li, (name, cache) in enumerate(levels):
            rows = [i for i in range(n) if out[i] is None]
            if not rows:
                break
            for i, res in cache.consult_tier1(queries, vecs, thr[:, li], rows).items():
                res.level = f"{name}:{res.level}"
                if self.promote and cache is not self.l1:
                    promotions.append((i, res.response, name))
                    if self.inclusive and self.l2 is not None and cache is not self.l2:
                        l2_copies.append((i, res.response, name))
                out[i] = res
        self._apply_writebacks(queries, vecs, promotions, l2_copies, deferred)
        per_query_s = (time.perf_counter() - t0) / n
        for i in range(n):
            if out[i] is None:
                out[i] = CacheResult(False)
            out[i].latency_s = per_query_s
        return (out, np.asarray(vecs)) if return_vecs else out

    def _materialize_fused(self, queries, contexts, thr, levels, ks, dec):
        """Host stage of the fused read: turn the program's decision tensors
        into CacheResults, joining ONLY the rows that materialize (each
        query's winning level, plus every level for residual misses feeding
        the cross-level generative pool). Stats land where the sequential
        walk would have put them; touches already happened on device."""
        from repro_torch.core import read_path

        n = len(queries)
        L = len(levels)
        winner = dec.winner
        # the sequential walk reaches level li only while every level above
        # missed — credit lookups accordingly (hits are credited by
        # _materialize_one on the winning level only)
        for li, (_, cache) in enumerate(levels):
            cache.stats.lookups += int(np.sum(winner >= li))
        need_pool = self.generative_across_levels and L > 1
        miss_rows = [i for i in range(n) if winner[i] >= L]
        rows_by_level: List[dict] = []
        for li, (_, cache) in enumerate(levels):
            rows = [i for i in range(n) if winner[i] == li]
            if need_pool:
                rows = rows + miss_rows
            rows_by_level.append(
                read_path.join_rows(
                    cache.store, dec.scores[:, li], dec.idx[:, li], rows, ks[li]
                )
            )
        out: List[Optional[CacheResult]] = [None] * n
        promotions: List[tuple] = []
        l2_copies: List[tuple] = []
        deferred: List[tuple] = []
        synth_memo: dict = {}  # duplicate in-batch queries synthesize once
        for i in range(n):
            li = int(winner[i])
            if li >= L:
                continue
            name, cache = levels[li]
            res, _ = cache._materialize_one(
                queries[i], float(thr[i, li]), rows_by_level[li][i],
                True, bool(dec.generative[i, li]), lazy_synth=True,
            )
            if res.generative and res.response is None:
                key = (id(cache), queries[i])
                if key not in synth_memo:
                    from repro_torch.core import synthesis

                    synth_memo[key] = synthesis.combine(
                        queries[i], res.sources, cache.synthesis_mode, cache.summarizer
                    )
                    if cache.cache_synthesized:
                        deferred.append((cache, i, synth_memo[key], {"generative": True}))
                res.response = synth_memo[key]
            if self.promote and cache is not self.l1:
                promotions.append((i, res.response, name))
                if self.inclusive and self.l2 is not None and cache is not self.l2:
                    l2_copies.append((i, res.response, name))
            res.level = f"{name}:{res.level}"
            out[i] = res
        if need_pool:
            for i in miss_rows:
                pooled = self._pool_candidates(
                    [rows_by_level[li].get(i, []) for li in range(L)]
                )
                combined = float(sum(s for s, _ in pooled))
                if pooled and combined > self.l1.t_combined:
                    key = ("multi-level", queries[i])
                    if key not in synth_memo:
                        from repro_torch.core import synthesis

                        synth_memo[key] = synthesis.combine(
                            queries[i], pooled, self.l1.synthesis_mode, self.l1.summarizer
                        )
                        deferred.append((self.l1, i, synth_memo[key], {"generative": True}))
                    self.l1.stats.generative_hits += 1
                    out[i] = CacheResult(
                        True, synth_memo[key], pooled[0][0], combined, True, pooled,
                        self.l1.effective_threshold(queries[i], contexts[i]),
                        0.0, "multi-level:generative",
                    )
        return out, promotions, l2_copies, deferred

    def _decide_host(self, queries, contexts, thr, levels, ks, vecs, bank):
        """The banked host-decide path (one fused search dispatch, decisions
        in host Python) and the per-level loop fallback — the pre-fused-read
        pipeline, kept for levels/stores with customized semantics and as
        the benchmark baseline."""
        n = len(queries)
        level_results: List[List[CacheResult]] = []
        level_matches: List[list] = []
        if bank is not None:
            # banked path: every level's candidates come out of ONE stacked
            # [L, cap, D] x [B, D] top-k dispatch; per-level decision rules
            # (and the L1-beats-L2-beats-peers walk below) run host-side on
            # the returned scores — no extra dispatches
            t0s = time.perf_counter()
            s_all, i_all = bank.search_lanes(vecs, max(ks))  # [B, L, k_fused]
            search_share = (time.perf_counter() - t0s) / len(levels)
            for li, (_, cache) in enumerate(levels):
                # touch=False equivalent: the join skips the recency bump;
                # counters move below, only on levels the walk would probe
                matches = cache.store.join_candidates(
                    s_all[:, li], i_all[:, li], touch=False
                )
                if ks[li] < max(ks):  # this level's own k, like its solo search
                    matches = [m[: ks[li]] for m in matches]
                cache.stats.search_time_s += search_share
                results, _ = cache._decide_batch(queries, thr[:, li], matches, lazy_synth=True)
                level_results.append(results)
                level_matches.append(matches)
        else:
            for li, (_, cache) in enumerate(levels):
                # touch=False: every level is probed speculatively here, but the
                # sequential walk stops at the winning level — recency/frequency
                # bookkeeping is applied after winners resolve, only on levels
                # the walk would actually have searched (eviction hygiene)
                matches = cache.search_candidates(vecs, k=ks[li], touch=False)
                # lazy_synth: only levels that win a query synthesize (below)
                results, _ = cache._decide_batch(queries, thr[:, li], matches, lazy_synth=True)
                level_results.append(results)
                level_matches.append(matches)

        out: List[Optional[CacheResult]] = [None] * n
        winner_idx = [len(levels)] * n  # level index that served each query
        promotions: List[tuple] = []  # (query index, response, from_name)
        l2_copies: List[tuple] = []  # inclusive: peer winners mirrored into L2
        synth_memo: dict = {}  # duplicate in-batch queries synthesize once
        # (cache, index, response, meta): deferred writebacks. A level's
        # synthesized answer only lands if that level actually won the query —
        # sequentially, levels below a hit are never probed.
        deferred: List[tuple] = []
        for i in range(n):
            for li, ((name, cache), results) in enumerate(zip(levels, level_results)):
                res = results[i]
                if res.hit:
                    if res.generative and res.response is None:
                        key = (id(cache), queries[i])
                        if key not in synth_memo:
                            from repro_torch.core import synthesis

                            synth_memo[key] = synthesis.combine(
                                queries[i], res.sources, cache.synthesis_mode, cache.summarizer
                            )
                            if cache.cache_synthesized:
                                deferred.append((cache, i, synth_memo[key], {"generative": True}))
                        res.response = synth_memo[key]
                    if self.promote and cache is not self.l1:
                        promotions.append((i, res.response, name))
                        if self.inclusive and self.l2 is not None and cache is not self.l2:
                            l2_copies.append((i, res.response, name))
                    res.level = f"{name}:{res.level}"
                    winner_idx[i] = li
                    out[i] = res
                    break

        # stats fidelity: the sequential walk stops at the winning level, so
        # levels below it were never looked up — retract the counters the
        # all-levels batch decision provisionally credited them with
        for li, ((_, cache), results) in enumerate(zip(levels, level_results)):
            cache.stats.lookups += sum(1 for i in range(n) if winner_idx[i] >= li)
            for i in range(n):
                if winner_idx[i] < li and results[i].hit:
                    cache.stats.hits -= 1
                    if results[i].generative:
                        cache.stats.generative_hits -= 1

        # eviction hygiene: level li's LRU/LFU counters only see query i's
        # candidates when the sequential walk would have probed level li,
        # i.e. every level above it missed (winner_idx[i] >= li)
        for li, ((_, cache), matches_l) in enumerate(zip(levels, level_matches)):
            cache.touch(
                [e.key for i in range(n) if winner_idx[i] >= li
                 for _, e in matches_l[i] if hasattr(e, "key")]
            )

        if self.generative_across_levels and len(levels) > 1:
            for i in range(n):
                if out[i] is not None:
                    continue
                pooled = self._pool_candidates([m[i] for m in level_matches])
                combined = float(sum(s for s, _ in pooled))
                if pooled and combined > self.l1.t_combined:
                    key = ("multi-level", queries[i])
                    if key not in synth_memo:
                        from repro_torch.core import synthesis

                        synth_memo[key] = synthesis.combine(
                            queries[i], pooled, self.l1.synthesis_mode, self.l1.summarizer
                        )
                        deferred.append((self.l1, i, synth_memo[key], {"generative": True}))
                    response = synth_memo[key]
                    self.l1.stats.generative_hits += 1
                    out[i] = CacheResult(
                        True, response, pooled[0][0], combined, True, pooled,
                        self.l1.effective_threshold(queries[i], contexts[i]),
                        0.0, "multi-level:generative",
                    )
        return out, promotions, l2_copies, deferred

    def _apply_writebacks(self, queries, vecs, promotions, l2_copies, deferred):
        """Batched writebacks: one scatter per destination cache. Dedupe
        repeated in-batch queries first — sequentially only the first
        occurrence writes (later ones would hit the fresh L1 copy), and a
        coalesced batch of duplicates must not flush L1 with clones."""

        def _dedupe(items: List[tuple]) -> List[tuple]:
            seen, out = set(), []
            for it in items:
                key = (queries[it[0]], it[1])
                if key not in seen:
                    seen.add(key)
                    out.append(it)
            return out

        promotions = _dedupe(promotions)
        l2_copies = _dedupe(l2_copies)
        if promotions:
            self.l1.insert_batch(
                [queries[i] for i, _, _ in promotions],
                [r for _, r, _ in promotions],
                metas=[{"promoted_from": name} for _, _, name in promotions],
                vecs=np.stack([vecs[i] for i, _, _ in promotions]),
            )
        if l2_copies:
            self.l2.insert_batch(
                [queries[i] for i, _, _ in l2_copies],
                [r for _, r, _ in l2_copies],
                metas=[{"promoted_from": name} for _, _, name in l2_copies],
                vecs=np.stack([vecs[i] for i, _, _ in l2_copies]),
            )
        by_cache: dict = {}
        for cache, i, r, meta in deferred:
            by_cache.setdefault(id(cache), (cache, []))[1].append((i, r, meta))
        for cache, items in by_cache.values():
            items = _dedupe(items)
            cache.insert_batch(
                [queries[i] for i, _, _ in items],
                [r for _, r, _ in items],
                metas=[m for _, _, m in items],
                vecs=np.stack([vecs[i] for i, _, _ in items]),
            )

    def insert(
        self,
        query: str,
        response: str,
        meta: Optional[dict] = None,
        cache_l1: bool = True,
        cache_l2: bool = True,
        vec: Optional[np.ndarray] = None,
        ttl_s: Optional[float] = None,
    ) -> None:
        """Privacy hints (§4): callers may exclude either level.

        ``cache_l2=False`` is absolute — inclusivity never copies a private
        entry into the shared level.
        """
        if vec is None:
            vec = self.l1.embed(query)
        if cache_l1:
            self.l1.insert(query, response, meta, vec=vec, ttl_s=ttl_s)
        if cache_l2 and self.l2 is not None:
            self.l2.insert(query, response, meta, vec=vec, ttl_s=ttl_s)

    def insert_batch(
        self,
        queries: List[str],
        responses: List[str],
        metas: Optional[List[Optional[dict]]] = None,
        cache_l1: bool = True,
        cache_l2: bool = True,
        vecs: Optional[np.ndarray] = None,
        ttls: Optional[List[Optional[float]]] = None,
    ) -> None:
        """Batched ``insert``: one embed forward + one scatter per level the
        privacy hints allow (same veto semantics as ``insert``)."""
        if not queries:
            return
        if vecs is None:
            vecs = self.l1.embed_batch(list(queries))
        vecs = np.asarray(vecs)
        if cache_l1:
            self.l1.insert_batch(list(queries), list(responses), metas, vecs=vecs, ttls=ttls)
        if cache_l2 and self.l2 is not None:
            self.l2.insert_batch(list(queries), list(responses), metas, vecs=vecs, ttls=ttls)

    def clear(self, older_than: Optional[float] = None) -> int:
        """Prune every level (tier-1 rings included). Returns total entries
        dropped across levels."""
        return sum(cache.clear(older_than=older_than) for _, cache in self._levels())
