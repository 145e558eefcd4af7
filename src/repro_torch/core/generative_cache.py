"""Generative caching (§3) — the paper's headline contribution.

Algorithm (verbatim from the paper, with t_single < t_s < t_combined):

    X <- {cached queries x_i : S(x_i, Q5) > t_single}
    if sum_{x_i in X} S(x_i, Q5) > t_combined:  cache hit (synthesize from X)
    else:                                        cache miss

Invocation modes:
  * primary   — generative matching IS the default lookup algorithm
  * secondary — generative matching only runs after a regular semantic miss

A single-entry exact-style hit (best similarity > t_s) is still served
directly (it trivially satisfies the generative rule and needs no synthesis).
Synthesized answers are inserted back into the cache so future queries
semantically similar to Q5 hit directly.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core import synthesis
from repro_torch.core.semantic_cache import CacheResult, SemanticCache


class GenerativeCache(SemanticCache):
    def __init__(
        self,
        embedder,
        threshold: float = 0.8,
        t_single: float = 0.6,
        t_combined: float = 1.4,
        mode: str = "secondary",  # "primary" | "secondary"
        max_sources: int = 4,
        synthesis_mode: str = "template",
        summarizer: Optional[Callable[[str], str]] = None,
        cache_synthesized: bool = True,
        **kwargs,
    ):
        super().__init__(embedder, threshold, **kwargs)
        assert mode in ("primary", "secondary")
        self.t_single = t_single
        self.t_combined = t_combined
        self.mode = mode
        self.max_sources = max_sources
        self.synthesis_mode = synthesis_mode
        self.summarizer = summarizer
        self.cache_synthesized = cache_synthesized

    # -- generative matching -----------------------------------------------------

    def _generative_lookup(
        self, query: str, vec: np.ndarray, t_s: float, t_start: float
    ) -> CacheResult:
        t0 = time.perf_counter()
        matches = self.store.search(vec, k=self.max_sources)
        self.stats.search_time_s += time.perf_counter() - t0
        X = [(s, e) for s, e in matches if s > self.t_single]
        combined = float(sum(s for s, _ in X))
        best = matches[0][0] if matches else -1.0

        if X and combined > self.t_combined:
            # single overwhelming match -> direct hit, no synthesis needed
            if X[0][0] > t_s:
                s, e = X[0]
                self.stats.hits += 1
                return CacheResult(True, e.response, s, combined, False, X[:1], t_s,
                                   time.perf_counter() - t_start, "semantic")
            response = synthesis.combine(query, X, self.synthesis_mode, self.summarizer)
            self.stats.hits += 1
            self.stats.generative_hits += 1
            if self.cache_synthesized:
                self.insert(query, response, {"generative": True}, vec=vec)
            return CacheResult(True, response, best, combined, True, X, t_s,
                               time.perf_counter() - t_start, "generative")
        promoted = self.consult_tier1([query], np.asarray(vec)[None], [t_s], [0])
        if 0 in promoted:
            r = promoted[0]
            r.latency_s = time.perf_counter() - t_start
            return r
        return CacheResult(False, None, best, combined, False, X, t_s,
                           time.perf_counter() - t_start)

    # -- lookup ---------------------------------------------------------------

    def lookup(self, query: str, context: Optional[dict] = None, vec: Optional[np.ndarray] = None) -> CacheResult:
        t_start = time.perf_counter()
        self.stats.lookups += 1
        t_s = self.effective_threshold(query, context)
        if vec is None:
            vec = self.embed(query)

        if self.mode == "primary":
            return self._generative_lookup(query, vec, t_s, t_start)

        # secondary: regular semantic lookup first
        t0 = time.perf_counter()
        matches = self.store.search(vec, k=1)
        self.stats.search_time_s += time.perf_counter() - t0
        if matches and matches[0][0] > t_s:
            s, e = matches[0]
            self.stats.hits += 1
            return CacheResult(True, e.response, s, s, False, [(s, e)], t_s,
                               time.perf_counter() - t_start, "semantic")
        return self._generative_lookup(query, vec, t_s, t_start)

    def _solo_k(self) -> int:
        """A batched generative lookup searches top-max_sources once; the
        top-1 of that shared candidate set equals the sequential secondary
        probe, so decisions match B sequential ``lookup`` calls. (The base
        class ``lookup_batch`` drives both the fused device-decide program
        and the host fallback through this k; synthesized answers are
        inserted after all decisions, so in-batch queries never hit each
        other's synthesized entries.)"""
        return max(self.max_sources, 1)

    def _decide_batch(self, queries, thresholds, matches, lazy_synth=False):
        """Generative-rule decisions over pre-searched candidates (§3).

        ``matches`` rows may hold more than ``max_sources`` candidates (the
        hierarchy searches each level once with a shared k); the rule only
        ever sees the top ``max_sources``, like the sequential path. Deferred
        synthesized inserts come back as ``(query_index, response)`` so the
        caller controls when (and whether) they land. With ``lazy_synth``,
        generative hits carry ``response=None`` and no deferred inserts — the
        hierarchy synthesizes only for levels that actually win a query (the
        summarizer may be an LLM call; losers must not pay for it)."""
        results: List[CacheResult] = []
        to_insert: List[tuple] = []  # synthesized answers, applied post-batch
        for i, m in enumerate(matches):
            t_s = float(thresholds[i])
            best = m[0][0] if m else -1.0
            if self.mode == "secondary" and m and best > t_s:
                s, e = m[0]
                self.stats.hits += 1
                results.append(CacheResult(True, e.response, s, s, False, [(s, e)],
                                           t_s, 0.0, "semantic"))
                continue
            X = [(s, e) for s, e in m[: self.max_sources] if s > self.t_single]
            combined = float(sum(s for s, _ in X))
            if X and combined > self.t_combined:
                if X[0][0] > t_s:
                    s, e = X[0]
                    self.stats.hits += 1
                    results.append(CacheResult(True, e.response, s, combined, False,
                                               X[:1], t_s, 0.0, "semantic"))
                    continue
                if lazy_synth:
                    response = None
                else:
                    response = synthesis.combine(queries[i], X, self.synthesis_mode, self.summarizer)
                    if self.cache_synthesized:
                        to_insert.append((i, response))
                self.stats.hits += 1
                self.stats.generative_hits += 1
                results.append(CacheResult(True, response, best, combined, True, X,
                                           t_s, 0.0, "generative"))
            else:
                results.append(CacheResult(False, None, best, combined, False, X,
                                           t_s, 0.0))
        return results, to_insert

    def _materialize_one(self, query, t_s, m, hit, gen, lazy_synth=False):
        """Host half of the generative ``_decide_batch`` for the fused read
        path: the hit/generative classification arrives as device-computed
        masks; this rebuilds the X set, scores, and (unless ``lazy_synth``)
        the synthesized response for exactly the rows that need them. The
        sub-classification of a non-generative hit (direct secondary match
        vs the rule's single-overwhelming-match branch) re-runs the same
        float comparisons on the same device scores, so it cannot disagree
        with the masks."""
        best = m[0][0] if m else -1.0
        X = [(s, e) for s, e in m[: self.max_sources] if s > self.t_single]
        combined = float(sum(s for s, _ in X))
        if hit and not gen:
            if self.mode == "secondary" and m and best > t_s:
                s, e = m[0]
                self.stats.hits += 1
                return (
                    CacheResult(True, e.response, s, s, False, [(s, e)], t_s,
                                0.0, "semantic"),
                    None,
                )
            s, e = X[0]  # gen_ok hit with best > t_s: X[0] == m[0]
            self.stats.hits += 1
            return (
                CacheResult(True, e.response, s, combined, False, X[:1], t_s,
                            0.0, "semantic"),
                None,
            )
        if hit:
            self.stats.hits += 1
            self.stats.generative_hits += 1
            if lazy_synth:
                response, ins = None, None
            else:
                response = synthesis.combine(query, X, self.synthesis_mode, self.summarizer)
                ins = response if self.cache_synthesized else None
            return (
                CacheResult(True, response, best, combined, True, X, t_s, 0.0,
                            "generative"),
                ins,
            )
        return CacheResult(False, None, best, combined, False, X, t_s, 0.0), None
