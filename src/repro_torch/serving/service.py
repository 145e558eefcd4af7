"""Async-first cache serving layer — the paper's latency story as an API.

The paper's headline numbers are a latency *gap*: hits answer in
milliseconds while misses wait seconds-to-minutes on a backend. A blocking
batch call erases the gap — a hit sharing a batch with one slow miss
returns at miss latency. ``CacheService`` keeps it:

    service.submit(CacheRequest(...)) -> concurrent.futures.Future[CacheResponse]

A priority-aware front scheduler micro-batches submissions through the
batched embed -> search -> decide stage (one embed forward + one search
dispatch per admitted batch, exactly like ``complete_batch``); hit and
generative-hit futures resolve right there. The miss residue is forwarded
— original future, priority, and deadline intact — to a background
dispatcher that coalesces misses by priority, resolves deadline-expired
ones with a typed ``DEADLINE_EXCEEDED`` response instead of generating,
dedups near-identical queued misses (embedding cosine above the hit
threshold — a cold paraphrase burst generates ONCE, the follower futures
resolve from the leader's result), and fans each (model, max_tokens,
temperature) group to the backend in one ``generate_batch``, backfilling
the cache with one scatter per level. The lookup stage itself rides the
banked hierarchy path: the levels' stores are prewarmed into one stacked
``StoreBank`` at service construction, so the embed -> search stage costs
ONE fused top-k dispatch for the whole hierarchy per admitted batch.

Backpressure is explicit: ``submit`` fast-fails with ``AdmissionRejected``
once ``max_inflight`` futures are unresolved, and raises ``ServiceClosed``
after ``close()`` (which drains both schedulers so every accepted future
resolves).

``complete(requests)`` runs the same two phases inline in the caller's
thread — the compatibility path behind ``EnhancedClient.query`` /
``complete_batch``, which are now thin sync wrappers. ``asubmit`` /
``acomplete`` wrap the futures for asyncio callers.

Lock discipline (`# guarded-by:` convention)
--------------------------------------------
The serving layer's mutable cross-thread state declares its lock with a
trailing comment on the ``__init__`` assignment::

    self._inflight = 0  # guarded-by: _lock

The contract (enforced at lint time on the reference package by
``python -m repro.analysis``, checker RA301) is that every later
``self.<attr>`` access sits inside a
``with self._lock:`` block. Condition variables built over a lock
(``threading.Condition(self._lock)``) count as aliases of that lock; a
method documented to be *called* with the lock held may declare
``# repro: holds[_lock]`` on its ``def`` line instead. The same convention
covers ``BatchCoalescer`` (``_cv``) and ``EnhancedClient``
(``_state_lock``).
"""
from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.client import ClientResult, EnhancedClient, LLMResponse
from repro_torch.core.request import (
    DEADLINE_EXCEEDED,
    GENERATED,
    HIT,
    STALE,
    CacheChunk,
    CacheRequest,
    CacheResponse,
    split_stream_tokens,
)
from repro_torch.resilience.errors import AllBackendsFailed
from repro_torch.serving.coalescer import (  # noqa: F401 — re-exported service errors
    AdmissionRejected,
    BatchCoalescer,
    DeadlineExceeded,
    ServiceClosed,
)


def _accepts_return_vecs(target) -> bool:
    """A cache/hierarchy subclass overriding ``lookup_batch`` with the
    pre-fused signature (no ``return_vecs``) must keep working behind the
    service — probe the override's own signature once per class."""
    from repro_torch.core.client import accepts_kwarg

    return accepts_kwarg(type(target), "lookup_batch", "return_vecs")


@dataclass
class _Pending:
    """A submitted request in flight through the service."""

    request: CacheRequest
    rid: int
    chosen: str  # backend resolved at submit (escalation ladder state then)
    t_submit: float
    deadline_t: Optional[float]  # absolute perf_counter stamp, None = no deadline
    vec: Optional[np.ndarray] = None  # set by the lookup stage, reused at backfill


@dataclass
class ServiceStats:
    submitted: int = 0
    hits: int = 0
    generated: int = 0
    expired: int = 0
    rejected: int = 0
    deduped: int = 0  # queued misses resolved from another miss's generation
    stale_served: int = 0  # expired entries served stale-if-error (backends down)
    backend_unavailable: int = 0  # misses that hit AllBackendsFailed with no stale answer


class CacheService:
    def __init__(
        self,
        client: EnhancedClient,
        *,
        max_batch: int = 8,
        max_wait_ms: float = 2.0,
        dispatch_batch: Optional[int] = None,
        dispatch_wait_ms: Optional[float] = None,
        max_inflight: int = 1024,
        dedup_misses: bool = True,
        dedup_threshold: Optional[float] = None,
    ):
        self.client = client
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.dispatch_batch = dispatch_batch if dispatch_batch is not None else max_batch
        self.dispatch_wait_ms = (
            dispatch_wait_ms if dispatch_wait_ms is not None else max_wait_ms
        )
        self.max_inflight = max_inflight
        # in-flight miss dedup (async dispatcher only): a cold paraphrase
        # burst looks itself up against one snapshot before any backfill
        # lands, so N near-identical queued misses would all generate —
        # coalesce them onto one backend call instead (cosine >= the hit
        # threshold; dedup_threshold overrides the per-request policy value)
        self.dedup_misses = dedup_misses
        self.dedup_threshold = dedup_threshold
        self.stats = ServiceStats()
        self._inflight = 0  # guarded-by: _lock
        self._lock = threading.Lock()  # service counters + lifecycle
        self._capacity = threading.Condition(self._lock)  # blocking-submit waits
        # client-owned: every service sharing this client serializes its store
        # lookups against backfill scatters through the same lock
        self._cache_lock = client._cache_lock
        self._closed = False  # guarded-by: _lock
        # schedulers start lazily: the sync complete() path never spawns threads
        self._lookup_sched: Optional[BatchCoalescer] = None
        self._miss_sched: Optional[BatchCoalescer] = None
        # prewarm the fused hierarchy bank so the first admitted batch pays
        # the banked one-dispatch lookup, not the adoption copy
        if client.hierarchy is not None:
            with self._cache_lock:
                getattr(client.hierarchy, "ensure_bank", lambda: None)()

    # -- async API -------------------------------------------------------------

    def submit(self, request: CacheRequest, *, block: bool = False) -> "Future[CacheResponse]":
        """Admit one request; the returned future resolves with a typed
        ``CacheResponse`` (hit in milliseconds, generated at backend pace,
        or ``DEADLINE_EXCEEDED``). Raises ``AdmissionRejected`` when the
        in-flight budget is spent (``block=True`` waits for capacity
        instead), ``ServiceClosed`` after ``close``."""
        client = self.client
        with self._lock:
            while block and self._inflight >= self.max_inflight and not self._closed:
                self._capacity.wait()
            if self._closed:
                raise ServiceClosed("service is closed")
            if self._inflight >= self.max_inflight:
                self.stats.rejected += 1
                raise AdmissionRejected(
                    f"in-flight budget exhausted ({self.max_inflight} requests)"
                )
            self._inflight += 1
            self.stats.submitted += 1
            # under the same lock as the closed-check: close() cannot slip in
            # between admission and scheduler startup and strand the request
            self._ensure_started()
        with client._state_lock:
            client.stats.requests += 1
            rid = client._next_id
            client._next_id += 1
        pending = self._pending(request, rid, time.perf_counter())
        try:
            fut = self._lookup_sched.submit(pending, priority=request.priority)
        except BaseException:
            self._release(None)
            raise
        fut.add_done_callback(self._release)
        return fut

    def submit_many(self, requests: Sequence[CacheRequest]) -> List["Future[CacheResponse]"]:
        """Bulk submit that blocks for capacity instead of shedding — the
        sync helpers (``query_many``/``broadcast``) must never abandon
        futures they already hold. ``ServiceClosed`` still propagates."""
        return [self.submit(r, block=True) for r in requests]

    def asubmit(self, request: CacheRequest) -> "asyncio.Future[CacheResponse]":
        """Awaitable ``submit`` for asyncio callers (needs a running loop)."""
        return asyncio.wrap_future(self.submit(request))

    async def acomplete(
        self, request: Union[CacheRequest, str], **hints
    ) -> CacheResponse:
        """One-shot asyncio facade: ``await service.acomplete("prompt")``."""
        if not isinstance(request, CacheRequest):
            request = CacheRequest(request, **hints)
        return await self.asubmit(request)

    async def astream(
        self,
        request: CacheRequest,
        *,
        pace_s: float = 0.0,
        chunk_tokens: int = 1,
    ):
        """Streamed delivery: resolve ``request`` through the normal
        submit path, then replay the answer as ``CacheChunk``s whose
        concatenated text is byte-identical to the non-streamed response.

        Cache hits resolve in milliseconds but replay through the SAME
        chunked surface as generated misses — with ``pace_s`` > 0 sleeping
        between chunks, a client watching the stream cannot tell a replayed
        hit from a live generation (the paper's drop-in-proxy story; the
        gateway surfaces the truth in its ``X-Cache`` header instead).
        ``chunk_tokens`` groups several tokens per chunk for long answers.
        Typed failures (deadline expiry) still yield exactly one final
        chunk carrying the typed response, so every stream terminates.
        Submission errors (``AdmissionRejected``/``ServiceClosed``) raise
        before the first chunk — nothing has streamed yet, so the caller
        can still map them to a clean error response."""
        resp = await self.asubmit(request)
        tokens = split_stream_tokens(resp.text or "")
        if chunk_tokens > 1:
            tokens = [
                "".join(tokens[i : i + chunk_tokens])
                for i in range(0, len(tokens), chunk_tokens)
            ]
        if not tokens:
            yield CacheChunk("", 0, True, resp)
            return
        last = len(tokens) - 1
        for i, tok in enumerate(tokens):
            yield CacheChunk(tok, i, i == last, resp)
            if pace_s > 0.0 and i != last:
                await asyncio.sleep(pace_s)

    # -- sync compatibility path ------------------------------------------------

    def complete(self, requests: Sequence[CacheRequest]) -> List[CacheResponse]:
        """Serve a batch inline in the caller's thread (no scheduler hop):
        the same lookup + dispatch phases, resolved before returning. This
        is the path behind ``EnhancedClient.query`` / ``complete_batch``.

        Misses dispatch in (model, max_tokens, temperature) groups; if one
        group's generation fails on every backend, its error raises after
        earlier groups already generated and backfilled (their results are
        dropped — the stats and the cache keep them, matching what a retry
        would then hit)."""
        reqs = list(requests)
        n = len(reqs)
        if n == 0:
            return []
        client = self.client
        t0 = time.perf_counter()
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is closed")
            self.stats.submitted += n
        with client._state_lock:
            rid0 = client._next_id
            client._next_id += n
            client.stats.requests += n
        pendings = [self._pending(r, rid0 + i, t0) for i, r in enumerate(reqs)]
        with self._cache_lock:
            responses = self._lookup_phase(pendings)
        miss = [i for i in range(n) if responses[i] is None]
        if miss:
            outcomes = self._dispatch_phase([pendings[i] for i in miss])
            for i, out in zip(miss, outcomes):
                if isinstance(out, Exception):
                    raise out
                responses[i] = out
        return responses  # type: ignore[return-value]

    # -- lifecycle -------------------------------------------------------------

    def clear(self, older_than: Optional[float] = None) -> int:
        """Prune the cache behind the service: everything, or — with
        ``older_than`` (seconds) — entries created more than that long ago
        plus anything already expired. Serialized against in-flight lookups
        and backfills through the shared cache lock; cascades through every
        hierarchy level and its host-RAM tier. Returns entries dropped."""
        client = self.client
        target = client.hierarchy if client.hierarchy is not None else client.cache
        clear = getattr(target, "clear", None)
        if clear is None:
            return 0
        with self._cache_lock:
            return int(clear(older_than=older_than))

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Stop admissions and drain: lookup first (misses forward to the
        dispatcher), then the dispatcher — every accepted future resolves."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._capacity.notify_all()  # wake blocking submitters -> ServiceClosed
        if self._lookup_sched is not None:
            self._lookup_sched.close(timeout=timeout)
        if self._miss_sched is not None:
            self._miss_sched.close(timeout=timeout)

    def __enter__(self) -> "CacheService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def inflight(self) -> int:
        """Accepted-but-unresolved futures right now — the gateway's
        graceful drain watches this reach zero before closing the service."""
        with self._lock:
            return self._inflight

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def scheduler_stats(self) -> Tuple:
        """(lookup, dispatch) CoalescerStats, None before the first submit."""
        return (
            self._lookup_sched.stats if self._lookup_sched else None,
            self._miss_sched.stats if self._miss_sched else None,
        )

    # -- internals --------------------------------------------------------------

    def _pending(self, request: CacheRequest, rid: int, t_submit: float) -> _Pending:
        deadline_t = (
            None if request.deadline_s is None else t_submit + request.deadline_s
        )
        return _Pending(
            request, rid, self.client._select_model(request.model), t_submit, deadline_t
        )

    def _release(self, _fut: Optional[Future]) -> None:
        with self._lock:
            self._inflight -= 1
            self._capacity.notify_all()

    def _ensure_started(self) -> None:
        """Start the schedulers on first use (caller holds ``self._lock``).
        The sync ``complete`` path never calls this, so it spawns no threads."""
        if self._lookup_sched is not None:
            return
        self._miss_sched = BatchCoalescer(
            self._run_dispatch,
            max_batch=self.dispatch_batch,
            max_wait_ms=self.dispatch_wait_ms,
            max_queue=0,  # max_inflight already bounds admissions
            owns_futures=True,
            on_expired=self._expire,
        )
        self._lookup_sched = BatchCoalescer(
            self._run_lookup,
            max_batch=self.max_batch,
            max_wait_ms=self.max_wait_ms,
            max_queue=0,
            owns_futures=True,
        )

    def _expire(self, pending: _Pending, fut: Future) -> None:
        """Scheduler hook: a queued miss outlived its deadline — resolve the
        future with the typed response; the backend is never called."""
        with self._lock:
            self.stats.expired += 1
        resp = CacheResponse(
            None, DEADLINE_EXCEEDED, False, None, None, pending.chosen, 0.0,
            time.perf_counter() - pending.t_submit, pending.rid,
        )
        if not fut.done():
            fut.set_result(resp)

    # -- phase A: batched embed -> search -> decide ------------------------------

    def _run_lookup(self, pendings: List[_Pending], futs: List[Future]) -> None:
        with self._cache_lock:
            responses = self._lookup_phase(pendings)
        for pending, fut, resp in zip(pendings, futs, responses):
            if resp is not None:  # hit/generative hit: resolve NOW
                if not fut.done():
                    fut.set_result(resp)
            else:  # miss residue: original future rides to the dispatcher
                self._miss_sched.submit(
                    pending,
                    priority=pending.request.priority,
                    deadline_t=pending.deadline_t,
                    future=fut,
                )

    def _lookup_phase(
        self, pendings: List[_Pending]
    ) -> List[Optional[CacheResponse]]:
        """One fused read program for the admitted batch (embed -> search ->
        decide -> touch in a single device dispatch — repro_torch.core.read_path);
        returns a response per hit and None for each miss. The embeddings
        come back with the decision tensors and are stashed on the pendings
        for the dedup/backfill stages — no second forward."""
        client = self.client
        n = len(pendings)
        responses: List[Optional[CacheResponse]] = [None] * n
        target = client.hierarchy if client.hierarchy is not None else client.cache
        if target is None:
            return responses
        owner = client.hierarchy.l1 if client.hierarchy is not None else client.cache
        embed_idx = [i for i, p in enumerate(pendings) if p.request.use_cache]
        if not embed_idx:
            return responses
        lk = [i for i in embed_idx if not pendings[i].request.force_fresh]
        ff = [i for i in embed_idx if pendings[i].request.force_fresh]
        if ff:
            # force_fresh skips the lookup but still needs embeddings for
            # dedup + backfill: a separate forward for the (rare) residue
            vecs_ff = np.asarray(
                owner.embed_batch([pendings[i].request.prompt for i in ff])
            )
            for j, i in enumerate(ff):
                pendings[i].vec = vecs_ff[j]
        if not lk:
            return responses
        prompts = [pendings[i].request.prompt for i in lk]
        contexts = [
            client._context_for(pendings[i].request, pendings[i].chosen) for i in lk
        ]
        if _accepts_return_vecs(target):
            cache_results, vecs = target.lookup_batch(
                prompts, contexts, return_vecs=True
            )
        else:
            # a cache subclass overriding lookup_batch with the pre-fused
            # signature: embed here (its own forward) and call it compatibly
            vecs = np.asarray(owner.embed_batch(prompts))
            cache_results = target.lookup_batch(prompts, contexts, vecs=vecs)
        for j, i in enumerate(lk):
            pendings[i].vec = np.asarray(vecs[j])
        now = time.perf_counter()
        for i, cr in zip(lk, cache_results):
            if not cr.hit:
                continue
            p = pendings[i]
            resp = CacheResponse(
                cr.response, HIT, True, cr, None, "cache", 0.0, now - p.t_submit, p.rid
            )
            with self._lock:
                self.stats.hits += 1
            with client._state_lock:
                client.stats.cache_hits += 1
                client._results[p.rid] = client._to_client_result(resp)
                if client.cost_ctl:
                    client.cost_ctl.record(0.0, True)
            responses[i] = resp
        return responses

    # -- phase B: miss dispatch + backfill ---------------------------------------

    def _run_dispatch(self, pendings: List[_Pending], futs: List[Future]) -> None:
        # the async dispatcher dedups near-identical queued misses; the sync
        # complete() path does not (it must match B sequential lookups)
        outcomes = self._dispatch_phase(pendings, dedup=self.dedup_misses)
        for fut, out in zip(futs, outcomes):
            if fut.done():
                continue
            if isinstance(out, Exception):
                fut.set_exception(out)
            else:
                fut.set_result(out)

    def _dedup_misses(
        self, pendings: List[_Pending], live: List[int]
    ) -> Dict[int, int]:
        """Coalesce near-identical queued misses onto one generation.

        Returns follower index -> leader index. Two misses coalesce when
        they would dispatch identically ((model, max_tokens, temperature)
        group) and their embeddings' cosine clears the follower's hit
        threshold — i.e. had the leader's answer already been backfilled,
        the follower's lookup would have HIT it. First-submitted wins
        leadership; ``force_fresh`` requests never coalesce either way."""
        client = self.client
        owner = client.hierarchy.l1 if client.hierarchy is not None else client.cache
        if owner is None:
            return {}
        # the dedup criterion is cosine-vs-threshold; on a euclidean/dot cache
        # the threshold lives in a different score space and would mis-coalesce
        if getattr(getattr(owner, "store", None), "metric", None) != "cosine":
            return {}
        by_group: Dict[tuple, List[int]] = {}
        for i in live:
            p = pendings[i]
            if not p.request.use_cache or p.request.force_fresh or p.vec is None:
                continue
            key = (p.chosen, p.request.max_tokens, p.request.temperature)
            by_group.setdefault(key, []).append(i)
        leader_of: Dict[int, int] = {}
        for idxs in by_group.values():
            leaders: List[Tuple[int, np.ndarray, float]] = []  # (idx, vec, norm)
            for i in idxs:
                p = pendings[i]
                v = np.asarray(p.vec, np.float64).ravel()
                nv = float(np.linalg.norm(v)) or 1.0
                thr = (
                    self.dedup_threshold
                    if self.dedup_threshold is not None
                    else owner.effective_threshold(
                        p.request.prompt, client._context_for(p.request, p.chosen)
                    )
                )
                best, best_j = -1.0, None
                for j, w, nw in leaders:
                    cos = float(v @ w) / (nv * nw)
                    if cos > best:
                        best, best_j = cos, j
                if best_j is not None and best > thr:
                    leader_of[i] = best_j
                else:
                    leaders.append((i, v, nv))
        if leader_of:
            with self._lock:
                self.stats.deduped += len(leader_of)
        return leader_of

    def _dispatch_phase(
        self, pendings: List[_Pending], dedup: bool = False,
        _regen_depth: int = 0,
    ) -> List[Union[CacheResponse, Exception]]:
        """Generate the miss residue: expired misses resolve typed (no
        backend call), near-identical misses coalesce onto one generation
        (``dedup=True``, the async dispatcher), the rest group by
        (model, max_tokens, temperature) into one ``generate_batch`` each,
        then backfill the cache with one scatter per destination level
        before the futures resolve. A deduped follower whose leader expired
        mid-generation re-dispatches (``_regen_depth`` bounds the recursion)
        when the follower itself still has deadline headroom."""
        client = self.client
        n = len(pendings)
        outcomes: List[Optional[Union[CacheResponse, Exception]]] = [None] * n
        llm_resps: List[Optional[LLMResponse]] = [None] * n
        now = time.perf_counter()
        live: List[int] = []
        for i, p in enumerate(pendings):
            if p.deadline_t is not None and now > p.deadline_t:
                with self._lock:
                    self.stats.expired += 1
                outcomes[i] = CacheResponse(
                    None, DEADLINE_EXCEEDED, False, None, None, p.chosen, 0.0,
                    now - p.t_submit, p.rid,
                )
            else:
                live.append(i)

        leader_of = self._dedup_misses(pendings, live) if dedup else {}
        groups: Dict[tuple, List[int]] = {}
        for i in live:
            if i in leader_of:
                continue  # rides its leader's generation
            p = pendings[i]
            key = (p.chosen, p.request.max_tokens, p.request.temperature)
            groups.setdefault(key, []).append(i)
        for (model, max_tokens, temperature), idxs in groups.items():
            prompts = [pendings[i].request.prompt for i in idxs]
            ddls = [pendings[i].deadline_t for i in idxs]
            try:
                resps = client._generate_batch_with_failover(
                    model, prompts, max_tokens, temperature,
                    deadlines=ddls if any(d is not None for d in ddls) else None,
                )
                if len(resps) != len(idxs):  # fail fast on a short batch
                    raise RuntimeError(
                        f"backend returned {len(resps)} responses for {len(idxs)} prompts"
                    )
            except AllBackendsFailed as e:
                # degradation ladder: every backend open/down -> rows that
                # opted in (allow_stale) try the expired-inventory lookup
                # before the typed backend_unavailable error reaches a future
                served = self._serve_stale([pendings[i] for i in idxs])
                for j, i in enumerate(idxs):
                    stale = served.get(j)
                    if stale is not None:
                        outcomes[i] = stale
                    else:
                        with self._lock:
                            self.stats.backend_unavailable += 1
                        outcomes[i] = e
                continue
            except Exception as e:  # noqa: BLE001 — the group's futures carry it
                for i in idxs:
                    outcomes[i] = e
                continue
            for i, resp in zip(idxs, resps):
                if getattr(resp, "expired", False):
                    # deadline passed MID-generation: the deadline-aware
                    # backend canceled the slot; resolve typed, cache nothing
                    p = pendings[i]
                    with self._lock:
                        self.stats.expired += 1
                    outcomes[i] = CacheResponse(
                        None, DEADLINE_EXCEEDED, False, None, None, p.chosen, 0.0,
                        time.perf_counter() - p.t_submit, p.rid,
                    )
                    continue
                cost = client._cost_of(resp.model, resp)
                resp.cost_usd = cost
                with self._lock:
                    self.stats.generated += 1
                with client._state_lock:
                    client.stats.llm_calls += 1
                    client.stats.total_cost_usd += cost
                    if client.cost_ctl:
                        client.cost_ctl.record(cost, False)
                llm_resps[i] = resp

        generated = [i for i in live if llm_resps[i] is not None]
        self._backfill(
            [pendings[i] for i in generated], [llm_resps[i] for i in generated]
        )
        done = time.perf_counter()
        for i in generated:
            p, resp = pendings[i], llm_resps[i]
            out = CacheResponse(
                resp.text, GENERATED, False, None, resp, resp.model, resp.cost_usd,
                done - p.t_submit, p.rid,
            )
            with client._state_lock:
                client.stats.total_latency_s += out.latency_s
                client._results[p.rid] = client._to_client_result(out)
            outcomes[i] = out
        # deduped followers resolve from their leader's single generation:
        # same text, zero marginal cost, no second backfill scatter
        regen: List[int] = []
        for i, j in leader_of.items():
            p, resp = pendings[i], llm_resps[j]
            if resp is None:
                lead_out = outcomes[j]
                if not isinstance(lead_out, CacheResponse):
                    outcomes[i] = lead_out  # group failure — carry its error
                    continue
                # the leader expired mid-generation; its deadline is NOT the
                # follower's. A follower with headroom re-dispatches (its own
                # deadline still applies there); one without resolves with
                # its OWN typed response, never the leader's (own rid/latency)
                if (
                    p.deadline_t is None or time.perf_counter() <= p.deadline_t
                ) and _regen_depth < 2:
                    regen.append(i)
                    continue
                with self._lock:
                    self.stats.expired += 1
                outcomes[i] = CacheResponse(
                    None, DEADLINE_EXCEEDED, False, None, None, p.chosen, 0.0,
                    time.perf_counter() - p.t_submit, p.rid,
                )
                continue
            out = CacheResponse(
                resp.text, GENERATED, False, None, resp, resp.model, 0.0,
                done - p.t_submit, p.rid,
            )
            with client._state_lock:
                client.stats.total_latency_s += out.latency_s
                client._results[p.rid] = client._to_client_result(out)
            outcomes[i] = out
        if regen:
            redo = self._dispatch_phase(
                [pendings[i] for i in regen], dedup=dedup,
                _regen_depth=_regen_depth + 1,
            )
            for i, out in zip(regen, redo):
                outcomes[i] = out
        return outcomes  # type: ignore[return-value]

    def _serve_stale(self, pendings: List[_Pending]) -> Dict[int, CacheResponse]:
        """Stale-if-error: after ``AllBackendsFailed``, rows that opted in
        (``allow_stale`` + ``use_cache``) consult the expired inventory
        (tier-0 entry table + tier-1 ring, via the hierarchy walk when one
        is mounted). Returns local index -> STALE CacheResponse for the rows
        a stale entry answered; the rest keep the typed error."""
        client = self.client
        target = client.hierarchy if client.hierarchy is not None else client.cache
        if target is None:
            return {}
        elig = [
            j
            for j, p in enumerate(pendings)
            if p.request.allow_stale and p.request.use_cache and p.vec is not None
        ]
        if not elig:
            return {}
        queries = [pendings[j].request.prompt for j in elig]
        vecs = np.stack([np.asarray(pendings[j].vec, np.float32) for j in elig])
        contexts = [
            client._context_for(pendings[j].request, pendings[j].chosen) for j in elig
        ]
        stales = [pendings[j].request.max_stale_s for j in elig]
        with self._cache_lock:
            if client.hierarchy is not None:
                found = client.hierarchy.lookup_stale(
                    queries, vecs, contexts, max_stale_s=stales,
                    l2_ok=[pendings[j].request.cache_l2 for j in elig],
                )
            else:
                thr = [
                    client.cache.effective_threshold(q, c)
                    for q, c in zip(queries, contexts)
                ]
                found = client.cache.lookup_stale(
                    queries, vecs, thr, max_stale_s=stales
                )
        out: Dict[int, CacheResponse] = {}
        now = time.perf_counter()
        for k, res in found.items():
            j = elig[k]
            p = pendings[j]
            resp = CacheResponse(
                res.response, STALE, True, res, None, "cache", 0.0,
                now - p.t_submit, p.rid,
            )
            with self._lock:
                self.stats.stale_served += 1
            with client._state_lock:
                client._results[p.rid] = client._to_client_result(resp)
            out[j] = resp
        return out

    def _backfill(
        self, pendings: List[_Pending], resps: List[LLMResponse]
    ) -> None:
        """Insert generated answers: per-request privacy hints group into at
        most one ``insert_batch`` scatter per (cache_l1, cache_l2) class."""
        client = self.client
        eligible = [
            (p, r)
            for p, r in zip(pendings, resps)
            if p.request.use_cache and p.vec is not None
        ]
        if not eligible:
            return
        groups: Dict[tuple, List[tuple]] = {}
        for p, r in eligible:
            groups.setdefault((p.request.cache_l1, p.request.cache_l2), []).append((p, r))
        from repro_torch.core.client import accepts_kwarg

        with self._cache_lock:
            for (l1_ok, l2_ok), members in groups.items():
                prompts = [p.request.prompt for p, _ in members]
                texts = [r.text for _, r in members]
                vecs = np.stack([p.vec for p, _ in members])
                ttls = [p.request.ttl_s for p, _ in members]
                target = client.hierarchy if client.hierarchy is not None else client.cache
                kw = {}
                if any(t is not None for t in ttls) and accepts_kwarg(
                    type(target), "insert_batch", "ttls"
                ):
                    kw["ttls"] = ttls
                if client.hierarchy is not None:
                    if l1_ok or l2_ok:
                        client.hierarchy.insert_batch(
                            prompts, texts, cache_l1=l1_ok, cache_l2=l2_ok,
                            vecs=vecs, **kw,
                        )
                elif l1_ok:
                    client.cache.insert_batch(
                        prompts,
                        texts,
                        metas=[{"model": r.model} for _, r in members],
                        vecs=vecs,
                        **kw,
                    )
