"""The read path as one device program: embed -> search -> decide -> touch.

A batched lookup runs on the bank's device end to end:

    token ids / raw vectors
        -> embedding forward                      (on device)
        -> banked [L, cap, D] lane top-k          (plain torch, or ONE launch
                                                   of the similarity_topk kernel)
        -> per-query/per-level threshold + generative-rule decide masks
        -> L1 > L2 > peers winner walk            (first hit over [B, L])
        -> recency/frequency counter touches, in place on the bank,
           gated to the levels a sequential walk would have probed
        -> compact decision tensors back to host, in ONE fetch

The program is eager torch plus one kernel launch. Between embed and decide
nothing reads a device value on the host (no ``.item()``, ``.tolist()``,
``bool(tensor)`` or Python branch on a tensor), and the counters are
updated in place where the reference donates them to its jitted program.

Decision semantics are those of ``SemanticCache._decide_batch`` /
``GenerativeCache._decide_batch`` (hit iff best > t_s; generative hit iff
the §3 rule fires), expressed as masks; the host *materialization* stage
(``_materialize_batch`` on the caches) turns masks + joined candidates into
``CacheResult``s for exactly the rows that need them. The generative rule's
combined-similarity sum is accumulated in device float32, as in the
reference program.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.store_bank import (
    StoreBank,
    _bank_touch,
    _topk_desc,
    fused_search_body,
    pad_to_bucket,
)
from repro_torch.kernels.backend import fetch, to_device

_NEG_FINITE = -3.0e38  # anything below is an invalid-slot sentinel (-inf / NEG)


@dataclass(frozen=True)
class LevelSpec:
    """Static per-level decision parameters of the read program."""

    generative: bool  # GenerativeCache level (the §3 rule applies)
    secondary: bool  # direct best>t_s check first (semantic levels: always)
    t_single: float
    t_combined: float
    max_sources: int  # X-set cap for the generative rule
    k: int  # candidates searched & touched for this level


def level_spec(cache, k: int) -> Optional[LevelSpec]:
    """Build the device decide spec for one cache level, or None when the
    cache customizes ``_decide_batch`` (its semantics cannot be assumed —
    the caller must stay on the host decide path)."""
    from repro_torch.core.generative_cache import GenerativeCache
    from repro_torch.core.semantic_cache import SemanticCache

    cls = type(cache)
    if isinstance(cache, GenerativeCache):
        if cls._decide_batch is not GenerativeCache._decide_batch:
            return None
        return LevelSpec(
            True, cache.mode == "secondary", float(cache.t_single),
            float(cache.t_combined), int(cache.max_sources), int(k),
        )
    if isinstance(cache, SemanticCache):
        if cls._decide_batch is not SemanticCache._decide_batch:
            return None
        return LevelSpec(False, True, 0.0, float("inf"), 0, int(k))
    return None


def store_bankable(store) -> bool:
    """The store's device rows/counters live in a StoreBank lane and its
    search/join semantics are the stock ones."""
    from repro_torch.core.vector_store import InMemoryVectorStore

    return (
        isinstance(store, InMemoryVectorStore)
        and type(store).search_batch is InMemoryVectorStore.search_batch
        and type(store).join_candidates is InMemoryVectorStore.join_candidates
    )


@dataclass
class ReadDecision:
    """Host-side view of one fused read, sliced back to the real batch."""

    vecs: np.ndarray  # [n, D] embeddings (reused for promotions/backfill)
    scores: np.ndarray  # [n, L, K]
    idx: np.ndarray  # [n, L, K] lane-local slots (int32)
    winner: np.ndarray  # [n] winning level index; L = miss everywhere
    hit: np.ndarray  # [n, L] per-level hit mask (semantic or generative)
    generative: np.ndarray  # [n, L] generative-hit mask (subset of hit)


@functools.lru_cache(maxsize=64)
def make_decide(specs: Tuple[LevelSpec, ...], K: int, device: torch.device):
    """The decide stage: the ``_decide_batch`` semantics as [B, L] masks,
    the L1 > L2 > peers winner walk, and the probed-levels touch mask. The
    per-level constants are uploaded once per (specs, K, device).

    Returns ``decide(s, thresholds, qmask) -> (winner, hit, generative,
    tmask)`` where ``s`` is [B, L, K] score-desc candidates and ``tmask``
    is the [B, L, K] bump mask (levels a sequential walk would have probed,
    finite candidates only, capped at each level's own k)."""
    L = len(specs)

    def const(values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)

    t_single = const([s.t_single for s in specs], torch.float32)
    t_comb = const([s.t_combined if s.generative else np.inf for s in specs], torch.float32)
    msl = const([min(s.max_sources, s.k) for s in specs], torch.int64)
    ks = const([s.k for s in specs], torch.int64)
    gen_l = const([s.generative for s in specs], torch.bool)
    sec_l = const([(not s.generative) or s.secondary for s in specs], torch.bool)
    colK = torch.arange(K, device=device)
    lanes = torch.arange(L, device=device)

    def decide(s, thresholds, qmask):
        # -- decide: the _decide_batch semantics as [B, L] masks -------------
        finite = s > _NEG_FINITE
        best = s[:, :, 0]  # scores sorted desc, so [.., 0] is each lane's best
        sem_direct = sec_l[None, :] & (best > thresholds)
        in_x = (
            finite
            & (s > t_single[None, :, None])
            & (colK[None, None, :] < msl[None, :, None])
            & gen_l[None, :, None]
        )
        combined = torch.where(in_x, s, torch.zeros_like(s)).sum(-1)
        gen_ok = in_x.any(-1) & (combined > t_comb[None, :])
        # X[0] == best whenever X is nonempty (desc order), so the rule's
        # "single overwhelming match" branch is best > t_s under gen_ok
        semantic = sem_direct | (gen_ok & (best > thresholds))
        hit = (semantic | gen_ok) & qmask[:, None]
        generative = gen_ok & ~semantic & qmask[:, None]
        # -- winner walk: first hitting level in L1 > L2 > peers order --------
        # argmax takes no bool tensor; on ints it returns the first maximum
        first = torch.argmax(hit.to(torch.int32), dim=1)
        winner = torch.where(hit.any(1), first, torch.full_like(first, L)).to(torch.int32)
        # -- touch: bump exactly what the sequential walk would have probed --
        probed = (lanes[None, :] <= winner[:, None]) & qmask[:, None]
        tmask = probed[:, :, None] & finite & (colK[None, None, :] < ks[None, :, None])
        return winner, hit, generative, tmask

    return decide


def _search(bank: StoreBank, q, valid, K: int, use_kernel: bool):
    if use_kernel:
        from repro_torch.kernels.similarity_topk.ops import _similarity_topk_lanes

        mixed = len(set(bank.metrics)) > 1
        return _similarity_topk_lanes(
            bank.buf, valid, q, k=K, metric=bank.metrics,
            prenormalized=True if mixed else bank.prenormalized,
            lane_rows=tuple(bank.capacities),  # rows past a lane's capacity stay unread
        )
    return fused_search_body(bank.buf, valid, q, K, bank.metrics, bank.prenorm)


def _lifecycle(bank: StoreBank, s, idx, now: float, K: int):
    """Staleness-aware rescore of live candidates, then a stable re-sort:
    an aging entry loses ``w[lane] * clip(age/ttl, 0, 1)`` of its score."""
    finite = s > _NEG_FINITE
    lanes3 = torch.arange(bank.L, device=s.device)[None, :, None].expand_as(idx)
    c = bank.d_created[lanes3, idx]
    e = bank.d_expires[lanes3, idx]
    frac = torch.clamp((now - c) / torch.clamp(e - c, min=1e-6), 0.0, 1.0)
    w = bank.d_staleness()
    pen = torch.where(finite & torch.isfinite(e), w[None, :, None] * frac, torch.zeros_like(s))
    s, order = _topk_desc(s - pen, K)  # decide assumes best-first candidates
    return s, torch.gather(idx, -1, order)


def run_program(bank: StoreBank, forward, embed_args, thresholds, qmask,
                specs: Tuple[LevelSpec, ...], K: int, use_kernel: bool,
                lifecycle: bool, tick: int, now: float):
    """The read program on the bank's device: embed -> search (ONE kernel
    launch on the kernel path) -> [lifecycle rescore] -> decide -> in-place
    counter touches. Returns device tensors (q, s, idx, winner, hit,
    generative); nothing crosses to the host in here."""
    q = forward(*embed_args).to(torch.float32)  # [B, D], stays on device
    valid = bank.valid
    if lifecycle:
        # expiry mask INSIDE the read: a dead row is invalid for this read,
        # so it can never surface as a candidate, let alone win
        valid = valid & (bank.d_expires > now)
    s, idx = _search(bank, q, valid, K, use_kernel)
    idx = idx.to(torch.int64)  # int64 for indexing; int32 again on the host
    if lifecycle:
        s, idx = _lifecycle(bank, s, idx, now, K)
    winner, hit, generative, tmask = make_decide(specs, K, bank.device)(s, thresholds, qmask)
    lanes3 = torch.arange(bank.L, device=s.device)[None, :, None].expand_as(idx)
    _bank_touch(
        bank.d_last_access, bank.d_access_count, lanes3.reshape(-1),
        idx.reshape(-1), tmask.reshape(-1).to(torch.int32), tick,
    )
    return q, s, idx, winner, hit, generative


def fused_read(
    bank: StoreBank,
    embedder,
    texts: Sequence[str],
    thresholds: np.ndarray,  # [n, L] per-query/per-level effective t_s
    specs: Sequence[LevelSpec],
    vecs: Optional[np.ndarray] = None,
) -> ReadDecision:
    """Run one fused read over a bank: one device program end to end,
    including the eviction-counter touches, and ONE host fetch of the
    decision tensors. ``vecs`` short-circuits the embed stage (callers that
    already hold embeddings upload them once)."""
    from repro_torch.core.embeddings import _identity_forward
    from repro_torch.kernels.similarity_topk import ops as st_ops

    n = len(texts)
    specs = tuple(specs)
    L = len(specs)
    K = max(s.k for s in specs)
    if vecs is not None:
        v, _ = pad_to_bucket(np.asarray(vecs, np.float32).reshape(n, bank.dim))
        args, B, forward = (v,), v.shape[0], _identity_forward
    else:
        prepare, forward = embedder.fused_forward()
        args, n_prep, B = prepare(list(texts))
        if n_prep != n:
            raise ValueError(f"prepare returned {n_prep} rows for {n} texts")
    dev = bank.device
    embed_args = tuple(to_device(a, dev) for a in args)
    qmask = torch.as_tensor(np.arange(B) < n, device=dev)
    thr = np.full((B, L), np.inf, np.float32)
    thr[:n] = np.asarray(thresholds, np.float32).reshape(n, L)

    bank.flush_pending()
    use_kernel = bank.use_pallas and bank._kernel_ok()
    lifecycle = bank.lifecycle_active()
    tick = bank.next_tick()
    bank.dispatches += 1
    if use_kernel:
        st_ops.record_dispatch()
    q, s, idx, winner, hit, gen = run_program(
        bank, forward, embed_args, to_device(thr, dev), qmask, specs, K,
        use_kernel, lifecycle, tick, float(np.float32(bank.rel_now())),
    )
    bank.mark_counters_dirty()
    # ONE host fetch for all decision tensors (the counters stay on device)
    q, s, idx, winner, hit, gen = fetch(q, s, idx.to(torch.int32), winner, hit, gen)
    return ReadDecision(q[:n], s[:n], idx[:n], winner[:n], hit[:n], gen[:n])


def join_rows(
    store, scores: np.ndarray, idx: np.ndarray, rows: List[int], k: int
) -> dict:
    """Join only the listed row indices against the store's host entries
    (the fused path materializes winners and pool rows — not B x L rows)."""
    if not rows:
        return {}
    joined = store.join_candidates(scores[rows], idx[rows], touch=False)
    return {i: m[:k] for i, m in zip(rows, joined)}
