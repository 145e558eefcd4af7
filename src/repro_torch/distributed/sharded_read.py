"""The sharded read path: one read over the whole mesh, zero host hops.

``repro_torch.core.read_path`` runs embed -> search -> decide -> touch for a
single-device bank; this module is its twin for deployments whose DB lanes
are sharded over a mesh (``repro_torch.launch.mesh.Mesh``). One read, driven
by one process over every position, covers:

    embed forward                       once, on the first position's device
    replicated hot lanes  [Lr, cap, D]  per-level top-k (one launch of the
                                        similarity top-k lanes kernel, B1)
    sharded lanes         [n, capl, D]  per position, on its device: a local
                                        top-k (the single-store form, B2)
                                        with global flat ids, then the
                                        [B, k] candidate sets merge on the
                                        first device (innermost axis first)
    router mask                         lane visibility per query
    threshold + generative-rule masks   repro_torch.core.read_path.make_decide
    + L1 > L2 > peers winner walk       — the body of the single-device read
    recency/frequency touches           the replicated bank's in one update;
                                        each position bumps only the slots it
                                        owns, on its own device

Only compact decision tensors ([B, L, K] scores/slots, winner, hit and
generative masks, and the embeddings) return to the host, in one fetch.

Entry lifecycle (TTL expiry + staleness penalty) runs in the read too, but
— unlike the single-device read, which rescores only the top-K candidates
— the penalty applies to the full per-position score matrix BEFORE the
local top-k. No kernel computes that, so the levels of a bank whose
lifecycle is active are scored by the plain matmul, the expiry mask and
the penalty, and a stable top-k; the levels of a bank without one (no
finite expiry, every weight 0: the penalty is 0 and the mask changes
nothing) keep the kernels. ``host_reference_read`` is its exact numpy
mirror.

The host walk (device search, host-side staleness rescore + threshold
decide + a separate touch) survives as
``ShardedVectorStore.search_host``/``search_batch_host``/
``lookup_batch_host`` and as ``host_reference_read`` below — references for
parity tests, not serving paths.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.read_path import (
    _NEG_FINITE,
    LevelSpec,
    ReadDecision,
    make_decide,
)
from repro_torch.core.store_bank import (
    _KERNEL_METRICS,
    StoreBank,
    _bank_touch,
    _lane_scores,
    _topk_desc,
    fused_search_body,
    pad_to_bucket,
)
from repro_torch.distributed.sharded_store import (
    _shard_axes,
    all_gather_merge_topk,
    position_topk,
    shard_devices,
)
from repro_torch.kernels.backend import fetch, to_device


def _on(device: torch.device):
    """Make ``device`` the current CUDA device (a no-op off CUDA)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _pad_cols(ts, ti, K: int):
    """Pad merged candidate columns up to K with -inf/slot-0 sentinels (the
    decide/touch masks treat non-finite scores as absent, and a slot-0 index
    under a False touch mask is a no-op scatter)."""
    pad = K - ts.shape[-1]
    if pad <= 0:
        return ts, ti
    ts = torch.cat([ts, torch.full((*ts.shape[:-1], pad), float("-inf"), dtype=ts.dtype,
                                   device=ts.device)], -1)
    ti = torch.cat([ti, torch.zeros((*ti.shape[:-1], pad), dtype=ti.dtype, device=ti.device)], -1)
    return ts, ti


def _penalty(created, expires, w, now):
    """Staleness penalty ``w * clip(age / ttl, 0, 1)`` where the expiry is
    finite, else 0 (float32, as in the reference program)."""
    frac = torch.clamp((now - created) / torch.clamp(expires - created, min=1e-6), 0.0, 1.0)
    return torch.where(torch.isfinite(expires), w * frac, torch.zeros_like(frac))


def _rep_topk(rb: StoreBank, q, K: int, lifecycle: bool, now):
    """Per-level top-k of the replicated bank -> ([B, Lr, k], [B, Lr, k])."""
    k = min(K, rb.cap)
    if not lifecycle:
        if rb.use_pallas and rb._kernel_ok():
            from repro_torch.kernels.similarity_topk.ops import _similarity_topk_lanes

            mixed = len(set(rb.metrics)) > 1
            return _similarity_topk_lanes(
                rb.buf, rb.valid, q, k=k, metric=rb.metrics,
                prenormalized=True if mixed else rb.prenormalized,
                lane_rows=tuple(rb.capacities),  # rows past a lane's capacity stay unread
            )
        return fused_search_body(rb.buf, rb.valid, q, k, rb.metrics, rb.prenorm)
    # the expiry mask + staleness penalty BEFORE the top-k (module docstring)
    valid = rb.valid & (rb.d_expires > now)
    pen = _penalty(rb.d_created, rb.d_expires, rb.d_staleness()[:, None], now)
    if len(set(rb.metrics)) == 1:
        s = _lane_scores(rb.buf, q, rb.metrics[0], all(rb.prenorm))
    else:
        s = torch.stack([_lane_scores(rb.buf[r], q, rb.metrics[r], rb.prenorm[r])
                         for r in range(rb.L)])
    s = (s - pen[:, None, :]).masked_fill(~valid[:, None, :], float("-inf"))
    ts, ti = _topk_desc(s, k)  # [Lr, Q, k]
    return ts.transpose(0, 1), ti.transpose(0, 1)


def _local_topk(part: StoreBank, q, K: int, metric: str, prenorm: bool, use_kernel: bool,
                lifecycle: bool, now):
    """One position's top-k over its lanes flattened into [cap_shard] slots
    -> (scores [Q, k], shard-local flat idx [Q, k]), on its device."""
    lanes_loc, cap_local, _ = part.buf.shape
    k = min(K, lanes_loc * cap_local)
    if lifecycle:  # the expiry mask and the penalty before the top-k
        pen = _penalty(part.d_created.reshape(-1), part.d_expires.reshape(-1),
                       part.d_staleness().repeat_interleave(cap_local), now)
        return position_topk(part.buf, part.valid & (part.d_expires > now), q, k, metric,
                             prenorm, penalty=pen)
    if not use_kernel:
        return position_topk(part.buf, part.valid, q, k, metric, prenorm)
    from repro_torch.kernels.similarity_topk import ops

    if lanes_loc == 1:  # one lane is one store: B2
        s, i = ops.similarity_topk(part.buf[0], part.valid[0], q, k=k, metric=metric,
                                   prenormalized=prenorm)
        return s, i.to(torch.int64)
    # several lanes: B1 per lane, then the stable merge (ties to the lower
    # lane, as one top-k over the flattened slots breaks them)
    s, i = ops._similarity_topk_lanes(part.buf, part.valid, q, k=min(K, cap_local),
                                      metric=(metric,), prenormalized=prenorm)
    i = i.to(torch.int64) + torch.arange(lanes_loc, device=i.device)[None, :, None] * cap_local
    s, pos = _topk_desc(s.reshape(s.shape[0], -1), k)
    return s, torch.gather(i.reshape(i.shape[0], -1), 1, pos)


class ShardedReadBank:
    """Device-resident view of a sharded hierarchy behind ONE read: hot
    levels backed by ``InMemoryVectorStore`` are adopted into one
    ``StoreBank`` on the first position's device (a single-controller mesh
    needs no copy per device), levels backed by ``ShardedVectorStore`` stay
    sharded by key over the mesh. ``fused_read`` then serves the whole
    hierarchy — embed, per-level candidates, candidate merge, router,
    decide, winner walk, and both banks' counter touches — with no host hop
    in between.

    ``members`` is the level list in L1 > L2 > peers order, each entry
    ``("rep", InMemoryVectorStore)`` or ``("sh", ShardedVectorStore)``."""

    def __init__(self, mesh, members: Sequence[Tuple[str, object]]):
        axes = _shard_axes(mesh)
        if not axes:
            raise ValueError("sharded read path needs a mesh with a pod/data axis")
        self.mesh = mesh
        self.axes = axes
        self.devices = shard_devices(mesh, axes)
        self.device = self.devices[0]
        self.members = list(members)
        self.rep_stores = [s for kind, s in self.members if kind == "rep"]
        self.sh_stores = [s for kind, s in self.members if kind == "sh"]
        if not self.sh_stores:
            raise ValueError("no sharded member — use read_path.fused_read")
        for s in self.sh_stores:
            if s.mesh is not mesh:
                raise ValueError("sharded members must share the read's mesh")
        self.rep_bank: Optional[StoreBank] = (
            StoreBank.adopt(self.rep_stores, device=self.device) if self.rep_stores else None
        )
        layout: List[Tuple[str, int]] = []
        ri = si = 0
        for kind, _ in self.members:
            if kind == "rep":
                layout.append(("rep", ri))
                ri += 1
            else:
                layout.append(("sh", si))
                si += 1
        self.layout = tuple(layout)
        self.dim = (self.rep_bank or self.sh_stores[0].bank).dim
        # dataflow counters (same contract as StoreBank's): one read counts
        # ONE dispatch however many positions it spans
        self.dispatches = 0
        self.host_hops = 0
        self.counter_scatters = 0
        # resilience: reads served with >= 1 shard masked dead (survivors'
        # candidates answered instead of the read failing)
        self.degraded_reads = 0

    @property
    def n_shards(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.axes]))

    @property
    def degraded(self) -> bool:
        """True once any read ran with a shard masked out."""
        return self.degraded_reads > 0

    def banks(self) -> List[StoreBank]:
        head = [self.rep_bank] if self.rep_bank is not None else []
        return head + [s.bank for s in self.sh_stores]

    def intact(self, stores: Sequence) -> bool:
        """The given level stores (in order) still match this adoption —
        same objects, replicated members still pointing at our shared bank
        lanes (a swapped/re-adopted store forces a rebuild)."""
        if len(stores) != len(self.members):
            return False
        ri = 0
        for (kind, s0), s in zip(self.members, stores):
            if s is not s0:
                return False
            if kind == "rep":
                if s._bank is not self.rep_bank or s._lane != ri:
                    return False
                ri += 1
        return True

    def lifecycle_active(self) -> bool:
        return any(b.lifecycle_active() for b in self.banks())

    def fused_read(
        self,
        embedder,
        texts: Sequence[str],
        thresholds: np.ndarray,  # [n, L] per-query/per-level effective t_s
        specs: Sequence[LevelSpec],
        vecs: Optional[np.ndarray] = None,
        router: Optional[np.ndarray] = None,  # [n, L] lane visibility
        touch: bool = True,
        shard_mask: Optional[np.ndarray] = None,  # [n_shards] bool; False = dead
    ) -> ReadDecision:
        """One read over the whole sharded hierarchy. Returns the same
        ``ReadDecision`` contract as ``read_path.fused_read``; sharded levels
        report store-global flat slot indices (what their
        ``join_candidates`` expects), replicated levels lane-local ones.

        ``shard_mask`` marks shards unavailable (False): nothing is read or
        written on them, their candidates score -inf (their lowest slots
        stand in) and their counters stay untouched, so a lookup degrades to
        the surviving shards' winners instead of the whole read failing —
        the read-path leg of the resilience degradation ladder."""
        from repro_torch.core.embeddings import _identity_forward

        n = len(texts)
        specs = tuple(specs)
        L = len(specs)
        K = max(sp.k for sp in specs)
        if vecs is not None:
            v, _ = pad_to_bucket(np.asarray(vecs, np.float32).reshape(n, self.dim))
            args, B, forward = (v,), v.shape[0], _identity_forward
        else:
            prepare, forward = embedder.fused_forward()
            args, n_prep, B = prepare(list(texts))
            if n_prep != n:
                raise ValueError(f"prepare returned {n_prep} rows for {n} texts")
        dev = self.device
        qmask = torch.as_tensor(np.arange(B) < n, device=dev)
        thr = np.full((B, L), np.inf, np.float32)
        thr[:n] = np.asarray(thresholds, np.float32).reshape(n, L)
        rmask = np.ones((B, L), bool)
        if router is not None:
            rmask[:n] = np.asarray(router, bool).reshape(n, L)
        if shard_mask is None:
            shard_ok = np.ones(self.n_shards, bool)
        else:
            shard_ok = np.asarray(shard_mask, bool).reshape(self.n_shards)
            if not shard_ok.any():
                raise ValueError("shard_mask marks every shard dead")
            if not shard_ok.all():
                self.degraded_reads += 1

        banks = self.banks()
        for b in banks:
            b.flush_pending()
        ticks = [b.next_tick() for b in banks] if touch else []
        now = torch.tensor(float(np.float32(StoreBank.rel_now())), dtype=torch.float32)
        self.dispatches += 1

        q = forward(*(to_device(a, dev) for a in args)).to(torch.float32)  # [B, D]
        level_s: List = [None] * L
        level_i: List = [None] * L
        rb = self.rep_bank
        if rb is not None:
            with _on(rb.device):
                ts, ti = _rep_topk(rb, q.to(rb.device), K, rb.lifecycle_active(),
                                   now.to(rb.device))
            ts, ti = _pad_cols(ts.to(dev), ti.to(dev, torch.int64), K)
            for li, (kind, j) in enumerate(self.layout):
                if kind == "rep":
                    level_s[li], level_i[li] = ts[:, j], ti[:, j]
        for li, (kind, j) in enumerate(self.layout):
            if kind != "sh":
                continue
            store = self.sh_stores[j]
            use_kernel = store.use_pallas and store.metric in _KERNEL_METRICS
            lifecycle = store.bank.lifecycle_active()  # the route is the level's own
            cap_shard = store.bank.lanes_loc * store.cap_local
            cand_s, cand_i = [], []
            for sid, part in enumerate(store.bank.parts):
                if shard_ok[sid]:
                    with _on(part.device):  # a kernel launches on its position's card
                        s, i = _local_topk(part, q.to(part.device), K, store.metric,
                                           store.bank.prenormalized, use_kernel, lifecycle,
                                           now.to(part.device))
                else:  # a dead shard: -inf candidates at its lowest slots
                    k_j = min(K, cap_shard)
                    s = torch.full((B, k_j), float("-inf"), device=dev)
                    i = torch.arange(k_j, device=dev).expand(B, k_j)
                cand_s.append(s)
                cand_i.append(i + sid * cap_shard)  # shard-local -> store-global
            ts, ti = all_gather_merge_topk(self.mesh, self.axes, cand_s, cand_i, K)
            level_s[li], level_i[li] = _pad_cols(ts, ti, K)
        s_all = torch.stack(level_s, 1)  # [B, L, K]
        idx_all = torch.stack(level_i, 1)
        # router: an invisible lane's candidates can neither win nor be touched
        s_all = s_all.masked_fill(~torch.as_tensor(rmask, device=dev)[:, :, None], float("-inf"))
        winner, hit, generative, tmask = make_decide(specs, K, dev)(
            s_all, to_device(thr, dev), qmask
        )
        if touch:
            self._touch(idx_all, tmask, ticks, shard_ok)
        # ONE host fetch for all decision tensors (the counters stay on their
        # devices; vector-ingress callers already hold the embeddings)
        s_all, idx_all, winner, hit, generative, q = fetch(
            s_all, idx_all.to(torch.int32), winner, hit, generative, q
        )
        if vecs is not None:
            q = v
        return ReadDecision(q[:n], s_all[:n], idx_all[:n], winner[:n], hit[:n], generative[:n])

    def _touch(self, idx_all, tmask, ticks, shard_ok) -> None:
        """The counter touches: the replicated bank's in one update; each
        live position bumps only the sharded slots it owns (a dead shard's
        counters never move)."""
        rb = self.rep_bank
        rep = [(li, j) for li, (kind, j) in enumerate(self.layout) if kind == "rep"]
        if rep:
            cols = [li for li, _ in rep]
            idx_r = idx_all[:, cols].to(rb.device)
            lanes3 = torch.as_tensor([j for _, j in rep], device=rb.device)[None, :, None]
            _bank_touch(
                rb.d_last_access, rb.d_access_count, lanes3.expand_as(idx_r).reshape(-1),
                idx_r.reshape(-1), tmask[:, cols].to(rb.device, torch.int32).reshape(-1),
                ticks[0],
            )
            rb.mark_counters_dirty()
        tick_off = 1 if rb is not None else 0
        for li, (kind, j) in enumerate(self.layout):
            if kind != "sh":
                continue
            store = self.sh_stores[j]
            lanes_loc, cap_local = store.bank.lanes_loc, store.cap_local
            for sid, part in enumerate(store.bank.parts):
                if not shard_ok[sid]:
                    continue
                idxg = idx_all[:, li].to(part.device)
                ll = idxg // cap_local - sid * lanes_loc
                own = tmask[:, li].to(part.device) & (ll >= 0) & (ll < lanes_loc)
                _bank_touch(
                    part.d_last_access, part.d_access_count,
                    ll.clamp(0, lanes_loc - 1).reshape(-1), (idxg % cap_local).reshape(-1),
                    own.to(torch.int32).reshape(-1), ticks[tick_off + j],
                )
            store.bank.mark_counters_dirty()


# -- host reference walk (parity tests only) ------------------------------------


def _np_scores(db: np.ndarray, q: np.ndarray, metric: str, prenormalized: bool):
    """Numpy float32 mirror of the read's scoring leg (cosine/dot)."""
    db = np.asarray(db, np.float32)
    q = np.asarray(q, np.float32)
    if metric == "cosine":
        if not prenormalized:
            db = db / np.maximum(np.linalg.norm(db, axis=-1, keepdims=True), np.float32(1e-9))
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), np.float32(1e-9))
    return q @ db.T


def _np_decide(specs: Tuple[LevelSpec, ...], K: int, s: np.ndarray, thr: np.ndarray):
    """Numpy mirror of ``read_path.make_decide`` (no padding rows here, so
    qmask is implicit all-True)."""
    L = len(specs)
    t_single = np.asarray([sp.t_single for sp in specs], np.float32)
    t_comb = np.asarray([sp.t_combined if sp.generative else np.inf for sp in specs], np.float32)
    msl = np.asarray([min(sp.max_sources, sp.k) for sp in specs], np.int32)
    ks = np.asarray([sp.k for sp in specs], np.int32)
    gen_l = np.asarray([sp.generative for sp in specs])
    sec_l = np.asarray([(not sp.generative) or sp.secondary for sp in specs])
    colK = np.arange(K)
    finite = s > np.float32(_NEG_FINITE)
    best = s[:, :, 0]
    sem_direct = sec_l[None, :] & (best > thr)
    in_x = (
        finite
        & (s > t_single[None, :, None])
        & (colK[None, None, :] < msl[None, :, None])
        & gen_l[None, :, None]
    )
    combined = np.sum(np.where(in_x, s, np.float32(0.0)), axis=-1, dtype=np.float32)
    gen_ok = in_x.any(-1) & (combined > t_comb[None, :])
    semantic = sem_direct | (gen_ok & (best > thr))
    hit = semantic | gen_ok
    generative = gen_ok & ~semantic
    winner = np.where(hit.any(1), np.argmax(hit, axis=1), L).astype(np.int32)
    probed = np.arange(L)[None, :] <= winner[:, None]
    tmask = probed[:, :, None] & finite & (colK[None, None, :] < ks[None, :, None])
    return winner, hit, generative, tmask


def _np_penalty(c: np.ndarray, e: np.ndarray, w, now32) -> np.ndarray:
    with np.errstate(invalid="ignore"):
        frac = np.clip((now32 - c) / np.maximum(e - c, np.float32(1e-6)),
                       np.float32(0.0), np.float32(1.0))
    return np.where(np.isfinite(e), w * frac, np.float32(0.0))


def host_reference_read(
    srb: ShardedReadBank,
    vecs: np.ndarray,
    thresholds: np.ndarray,
    specs: Sequence[LevelSpec],
    router: Optional[np.ndarray] = None,
    now: Optional[float] = None,
    shard_mask: Optional[np.ndarray] = None,
) -> dict:
    """The host walk, kept as the parity reference: a pure-numpy mirror of
    the sharded fused read over device-fetched state. Computes the FULL
    per-level effective-score matrices (so the pre-top-k lifecycle
    semantics are reproduced exactly), per-level top-K with the stable tie
    order (ascending slot), the router mask, the shared decide/winner walk,
    and the touch mask — without mutating any device state. Returns a dict
    with ``scores``/``idx``/``winner``/``hit``/``generative``/``tmask``."""
    specs = tuple(specs)
    L = len(specs)
    K = max(sp.k for sp in specs)
    q = np.atleast_2d(np.asarray(vecs, np.float32))
    n = q.shape[0]
    now32 = np.float32(StoreBank.rel_now() if now is None else now)
    level_s: List[np.ndarray] = []
    level_i: List[np.ndarray] = []
    rb = srb.rep_bank
    ri = 0
    for kind, store in srb.members:
        if kind == "rep":
            buf = rb.buf[ri].cpu().numpy()
            valid = rb.valid[ri].cpu().numpy().copy()
            s = _np_scores(buf, q, rb.metrics[ri], rb.prenorm[ri])
            if rb.lifecycle_active():
                c = rb.d_created[ri].cpu().numpy()
                e = rb.d_expires[ri].cpu().numpy()
                valid &= e > now32
                s = s - _np_penalty(c, e, np.float32(rb.staleness_w[ri]), now32)[None, :]
            ri += 1
        else:
            bank = store.bank
            buf = bank.buf.cpu().numpy().reshape(store.capacity, store.dim)
            valid = bank.valid.cpu().numpy().reshape(store.capacity).copy()
            if shard_mask is not None:
                # shard sid owns the contiguous global flat slots
                # [sid*cap_shard, (sid+1)*cap_shard): invalidate dead shards'
                m = np.asarray(shard_mask, bool).ravel()
                valid &= np.repeat(m, store.capacity // m.size)
            s = _np_scores(buf, q, store.metric, bank.prenormalized)
            if bank.lifecycle_active():
                c = bank.d_created.cpu().numpy().reshape(-1)
                e = bank.d_expires.cpu().numpy().reshape(-1)
                w = np.repeat(bank.staleness_w.astype(np.float32), store.cap_local)
                valid &= e > now32
                s = s - _np_penalty(c, e, w, now32)[None, :]
        s = np.where(valid[None, :], s, -np.inf).astype(np.float32)
        order = np.argsort(-s, axis=-1, kind="stable")[:, : min(K, s.shape[1])]
        ts = np.take_along_axis(s, order, -1)
        ti = order.astype(np.int32)
        if ts.shape[1] < K:
            pad = K - ts.shape[1]
            ts = np.concatenate([ts, np.full((n, pad), -np.inf, np.float32)], 1)
            ti = np.concatenate([ti, np.zeros((n, pad), np.int32)], 1)
        level_s.append(ts)
        level_i.append(ti)
    s_all = np.stack(level_s, 1)
    idx_all = np.stack(level_i, 1)
    if router is not None:
        s_all = np.where(
            np.asarray(router, bool).reshape(n, L)[:, :, None], s_all, -np.inf
        ).astype(np.float32)
    thr = np.asarray(thresholds, np.float32).reshape(n, L)
    winner, hit, generative, tmask = _np_decide(specs, K, s_all, thr)
    return {
        "scores": s_all, "idx": idx_all, "winner": winner, "hit": hit,
        "generative": generative, "tmask": tmask,
    }
