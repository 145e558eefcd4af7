"""The reference's ``tests/test_service.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

Async-first CacheService + priority scheduler: hits resolve before
co-batched misses generate, priority ordering under contention, deadline
expiry without a backend call, typed admission control / close errors, and
the asyncio facade (stdlib ``asyncio.run`` harness — no pytest-asyncio).
"""
import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro_torch.core import (
    CacheRequest,
    EnhancedClient,
    GenerativeCache,
    LLMBackend,
    LLMResponse,
    MockLLM,
    NgramHashEmbedder,
)
from repro_torch.core.request import DEADLINE_EXCEEDED, GENERATED, HIT
from repro_torch.serving.coalescer import (
    AdmissionRejected,
    BatchCoalescer,
    DeadlineExceeded,
    ServiceClosed,
)
from repro_torch.serving.service import CacheService
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


def _client(latency_s: float = 0.0, backend=None):
    cache = GenerativeCache(
        NgramHashEmbedder(), threshold=0.85, t_single=0.45, t_combined=1.0
    )
    client = EnhancedClient(cache=cache)
    client.register_backend(backend or MockLLM("backend", latency_s=latency_s))
    return client, cache


class GatedLLM(LLMBackend):
    """First generate_batch call blocks on ``gate``; later calls record the
    prompt order — lets tests pile work behind a busy dispatcher."""

    name = "gated"

    def __init__(self):
        self.order = []
        self.gate = threading.Event()
        self.entered = threading.Event()

    def generate_batch(self, prompts, max_tokens: int = 256, temperature: float = 0.0):
        if not self.entered.is_set():
            self.entered.set()
            assert self.gate.wait(timeout=10)
        self.order.extend(prompts)
        return [LLMResponse(f"generated: {p}", self.name) for p in prompts]


# -- the headline invariant ----------------------------------------------------


def test_hit_future_resolves_before_cobatched_miss_generates():
    client, cache = _client(latency_s=0.5)
    cache.insert("what is a cache", "a cache stores answers")
    cache.lookup_batch(["warm", "warm 2"])  # compile outside the assertion window
    with CacheService(client, max_batch=8, max_wait_ms=20.0) as svc:
        miss_fut = svc.submit(CacheRequest("completely unrelated question zq"))
        hit_fut = svc.submit(CacheRequest("what is a cache"))
        hit = hit_fut.result(timeout=5)
        assert hit.status == HIT and hit.from_cache
        assert hit.text == "a cache stores answers"
        assert not miss_fut.done()  # the 0.5s generation is still in flight
        miss = miss_fut.result(timeout=5)
        assert miss.status == GENERATED and not miss.from_cache
    assert svc.stats.hits == 1 and svc.stats.generated == 1


def test_generated_answer_backfills_cache():
    client, cache = _client()
    with CacheService(client, max_wait_ms=1.0) as svc:
        first = svc.submit(CacheRequest("novel question about jax")).result(timeout=5)
        assert first.status == GENERATED
        again = svc.submit(CacheRequest("novel question about jax")).result(timeout=5)
        assert again.status == HIT and again.text == first.text


# -- priority / deadline scheduling --------------------------------------------


def test_priority_ordering_under_contention():
    backend = GatedLLM()
    client, _ = _client(backend=backend)
    svc = CacheService(client, max_wait_ms=1.0, dispatch_batch=1, dispatch_wait_ms=1.0)
    filler = svc.submit(CacheRequest("filler"))
    assert backend.entered.wait(timeout=10)  # dispatcher now blocked in the backend
    futs = [
        svc.submit(CacheRequest(p, priority=pr))
        for p, pr in [("low prio q", 0), ("high prio q", 9), ("mid prio q", 3)]
    ]
    time.sleep(0.05)  # let the lookup stage forward all three misses
    backend.gate.set()
    for f in [filler] + futs:
        assert f.result(timeout=10).status == GENERATED
    svc.close()
    assert backend.order[1:] == ["high prio q", "mid prio q", "low prio q"]


def test_deadline_expiry_resolves_without_backend_call():
    backend = GatedLLM()
    client, _ = _client(backend=backend)
    svc = CacheService(client, max_wait_ms=1.0)
    filler = svc.submit(CacheRequest("filler"))
    assert backend.entered.wait(timeout=10)
    doomed = svc.submit(CacheRequest("urgent but doomed", deadline_s=0.05))
    time.sleep(0.15)  # deadline passes while the dispatcher is blocked
    backend.gate.set()
    resp = doomed.result(timeout=10)
    assert resp.status == DEADLINE_EXCEEDED and resp.expired
    assert resp.text is None
    assert filler.result(timeout=10).status == GENERATED
    svc.close()
    assert "urgent but doomed" not in backend.order  # never generated
    assert svc.stats.expired == 1


def test_hit_served_even_past_deadline():
    # deadlines shed *generation* load; an instant hit is still worth serving
    client, cache = _client()
    cache.insert("cached q", "cached a")
    with CacheService(client, max_wait_ms=1.0) as svc:
        resp = svc.submit(CacheRequest("cached q", deadline_s=30.0)).result(timeout=5)
        assert resp.status == HIT


# -- admission control ----------------------------------------------------------


def test_admission_rejection_is_typed_and_drain_survives():
    backend = GatedLLM()
    client, _ = _client(backend=backend)
    svc = CacheService(client, max_wait_ms=1.0, max_inflight=2)
    f1 = svc.submit(CacheRequest("first"))
    assert backend.entered.wait(timeout=10)
    f2 = svc.submit(CacheRequest("second"))
    with pytest.raises(AdmissionRejected):
        svc.submit(CacheRequest("over budget"))
    assert svc.stats.rejected == 1
    backend.gate.set()
    assert f1.result(timeout=10).status == GENERATED
    assert f2.result(timeout=10).status == GENERATED
    # the drain thread survived the rejection: new work is accepted and served
    assert svc.submit(CacheRequest("after the storm")).result(timeout=10).status == GENERATED
    svc.close()


def test_submit_after_close_raises_typed_service_closed():
    client, _ = _client()
    svc = CacheService(client, max_wait_ms=1.0)
    assert svc.submit(CacheRequest("one")).result(timeout=10).status == GENERATED
    svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit(CacheRequest("too late"))
    with pytest.raises(ServiceClosed):
        svc.complete([CacheRequest("too late")])


# -- sync compatibility wrappers -------------------------------------------------


def test_sync_wrappers_ride_the_service():
    client, cache = _client()
    r1 = client.query("some question")
    assert not r1.from_cache
    r2 = client.query("some question")
    assert r2.from_cache and r2.cost_usd == 0.0
    rs = client.complete_batch(["some question", "another question"])
    assert rs[0].from_cache and not rs[1].from_cache
    assert client.stats.requests == 4 and client.stats.cache_hits == 2


def test_complete_requests_per_request_hints():
    client, cache = _client()
    reqs = [
        CacheRequest("public question"),
        CacheRequest("private question", cache_l1=False, cache_l2=False),
    ]
    rs = client.complete_requests(reqs)
    assert all(not r.from_cache for r in rs)
    stored = [e.query for e in cache.store._entries if e is not None]
    assert "public question" in stored and "private question" not in stored


def test_query_many_mixed_models_grouped_dispatch():
    client, _ = _client()
    m2 = MockLLM("m2")
    client.register_backend(m2)
    rs = client.query_many(["q a", "q b", "q c"], models=["backend", "m2", "backend"],
                           use_cache=False)
    assert [r.model for r in rs] == ["backend", "m2", "backend"]


# -- scheduler (reworked BatchCoalescer) unit tests ------------------------------


def test_coalescer_priority_order_under_contention():
    batches = []
    gate, entered = threading.Event(), threading.Event()

    def handler(items):
        if not entered.is_set():
            entered.set()
            assert gate.wait(timeout=10)
        batches.append(list(items))
        return items

    with BatchCoalescer(handler, max_batch=2, max_wait_ms=1.0) as co:
        warm = co.submit("warm")
        assert entered.wait(timeout=10)
        futs = [co.submit(x, priority=p) for x, p in [("lo", 0), ("hi", 9), ("mid", 5)]]
        time.sleep(0.02)
        gate.set()
        for f in [warm] + futs:
            f.result(timeout=10)
    assert [x for b in batches[1:] for x in b] == ["hi", "mid", "lo"]


def test_coalescer_deadline_default_exception():
    gate, entered = threading.Event(), threading.Event()

    def handler(items):
        if not entered.is_set():
            entered.set()
            assert gate.wait(timeout=10)
        return items

    with BatchCoalescer(handler, max_batch=4, max_wait_ms=1.0) as co:
        co.submit("warm")
        assert entered.wait(timeout=10)
        doomed = co.submit("doomed", deadline_s=0.01)
        time.sleep(0.05)
        gate.set()
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=10)
        assert co.stats.expired == 1


def test_coalescer_close_flushes_pending_futures():
    co = BatchCoalescer(lambda xs: [x + 1 for x in xs], max_batch=4, max_wait_ms=50.0)
    futs = [co.submit(i) for i in range(10)]
    co.close()
    assert all(f.done() for f in futs)
    assert sorted(f.result() for f in futs) == [i + 1 for i in range(10)]


def test_coalescer_submit_after_close_typed():
    co = BatchCoalescer(lambda xs: xs, max_batch=2)
    co.close()
    with pytest.raises(ServiceClosed):
        co.submit(1)
    assert isinstance(ServiceClosed("x"), RuntimeError)  # old callers still catch


def test_coalescer_admission_rejected_is_queue_full():
    import queue

    gate, entered = threading.Event(), threading.Event()

    def handler(items):
        if not entered.is_set():
            entered.set()
            assert gate.wait(timeout=10)
        return items

    co = BatchCoalescer(handler, max_batch=1, max_wait_ms=1.0, max_queue=2)
    f0 = co.submit("warm")
    assert entered.wait(timeout=10)
    fs = [co.submit(i) for i in range(2)]
    with pytest.raises(AdmissionRejected):
        co.submit("overflow")
    assert isinstance(AdmissionRejected("x"), queue.Full)  # old callers still catch
    assert co.stats.rejected == 1
    gate.set()
    for f in [f0] + fs:
        f.result(timeout=10)
    co.close()


# -- asyncio facade --------------------------------------------------------------


def test_asyncio_facade_roundtrip():
    client, cache = _client(latency_s=0.05)
    cache.insert("what is a cache", "a cache stores answers")

    async def main():
        with CacheService(client, max_wait_ms=2.0) as svc:
            hit = await svc.acomplete("what is a cache")
            miss = await svc.asubmit(CacheRequest("a new question xq"))
            pair = await asyncio.gather(
                svc.asubmit(CacheRequest("what is a cache")),
                svc.asubmit(CacheRequest("another new question yq", priority=5)),
            )
            return hit, miss, pair

    hit, miss, pair = asyncio.run(main())
    assert hit.status == HIT and hit.from_cache
    assert miss.status == GENERATED
    assert pair[0].status == HIT and pair[1].status == GENERATED


def test_asyncio_gather_mixed_stream_hits_fast():
    client, cache = _client(latency_s=0.3)
    cache.insert("hot query", "hot answer")
    cache.lookup_batch(["warm", "warm 2"])

    async def main():
        with CacheService(client, max_wait_ms=5.0) as svc:
            t0 = time.perf_counter()
            miss_task = svc.asubmit(CacheRequest("cold query zz"))
            hit = await svc.acomplete("hot query")
            hit_elapsed = time.perf_counter() - t0
            await miss_task
            return hit, hit_elapsed, time.perf_counter() - t0

    hit, hit_elapsed, total = asyncio.run(main())
    assert hit.status == HIT
    assert hit_elapsed < total  # the hit did not wait for the miss


def test_concurrent_submitters_share_batches():
    client, cache = _client()
    hot = [f"hot question {i}" for i in range(8)]
    cache.insert_batch(hot, [f"answer {i}" for i in range(8)])
    with CacheService(client, max_batch=8, max_wait_ms=20.0) as svc:
        with ThreadPoolExecutor(max_workers=8) as pool:
            resps = list(pool.map(
                lambda q: svc.submit(CacheRequest(q)).result(timeout=10), hot
            ))
    assert all(r.status == HIT for r in resps)
    lookup_stats, _ = svc.scheduler_stats
    assert max(lookup_stats.batch_sizes) > 1  # concurrency actually coalesced


def test_submit_many_blocks_for_capacity_instead_of_shedding():
    client, _ = _client(latency_s=0.05)
    svc = CacheService(client, max_wait_ms=1.0, max_inflight=2)
    prompts = ["alpha falcon dawn", "brine cobalt ember", "cedar glyph mirth",
               "dune harbor nickel", "elm quartz saffron", "fjord lichen topaz"]
    futs = svc.submit_many([CacheRequest(p) for p in prompts])
    assert len(futs) == 6
    assert [f.result(timeout=10).status for f in futs] == [GENERATED] * 6
    assert svc.stats.rejected == 0  # waited, never shed
    svc.close()


def test_query_many_larger_than_inflight_budget():
    client, _ = _client()
    client.service.max_inflight = 3  # force capacity waits in the bulk path
    rs = client.query_many([f"q {i}" for i in range(10)], use_cache=False)
    assert len(rs) == 10 and all(r.text for r in rs)


def test_coalescer_starved_low_priority_deadline_still_expires():
    """A deadlined item that never wins a pop (sustained high-priority load)
    must still resolve typed: expiry sweeps the whole heap at each drain."""
    gate, entered = threading.Event(), threading.Event()

    def handler(items):
        if not entered.is_set():
            entered.set()
            assert gate.wait(timeout=10)
        return items

    co = BatchCoalescer(handler, max_batch=2, max_wait_ms=1.0)
    warm = co.submit("warm")
    assert entered.wait(timeout=10)
    doomed = co.submit("doomed", priority=0, deadline_s=0.02)
    highs = [co.submit(f"hi{i}", priority=9) for i in range(4)]
    time.sleep(0.05)  # deadline passes while blocked behind the gated batch
    gate.set()
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=10)
    for f in [warm] + highs:
        f.result(timeout=10)
    co.close()
    assert co.stats.expired == 1


# -- in-flight miss dedup ------------------------------------------------------


def _wait_for(predicate, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if predicate():
            return True
        time.sleep(0.005)
    return False


def test_paraphrase_burst_of_misses_generates_once():
    """Near-identical queued misses coalesce onto ONE backend generation:
    the follower futures resolve from the leader's result (the async-path
    fix for the cold paraphrase burst in ROADMAP)."""
    backend = GatedLLM()
    client, cache = _client(backend=backend)
    cache.lookup_batch(["warm 1"])  # compile outside the timing-sensitive window
    with CacheService(client, max_batch=8, max_wait_ms=2.0) as svc:
        blocker = svc.submit(CacheRequest("blocker question zzz"))
        assert backend.entered.wait(timeout=10)
        burst = [svc.submit(CacheRequest("what color is a ripe apple"))
                 for _ in range(3)]
        distinct = svc.submit(CacheRequest("submarine hull engineering basics"))
        # every queued miss must reach the dispatcher before the gate opens,
        # or it would ride a later batch (and legitimately dedup nothing)
        assert _wait_for(lambda: svc.scheduler_stats[1].submitted >= 5)
        backend.gate.set()
        rs = [f.result(timeout=10) for f in burst]
        assert all(r.status == GENERATED for r in rs)
        assert len({r.text for r in rs}) == 1  # one generation, shared result
        assert backend.order.count("what color is a ripe apple") == 1
        assert distinct.result(timeout=10).status == GENERATED
        assert blocker.result(timeout=10).status == GENERATED
    assert svc.stats.deduped == 2
    assert svc.stats.generated == 3  # blocker + burst leader + distinct
    # only the leader pays: followers carry zero marginal cost
    assert sum(r.cost_usd for r in rs) == rs[0].cost_usd


def test_dissimilar_misses_do_not_dedup():
    backend = GatedLLM()
    client, _ = _client(backend=backend)
    with CacheService(client, max_batch=8, max_wait_ms=2.0) as svc:
        blocker = svc.submit(CacheRequest("blocker question zzz"))
        assert backend.entered.wait(timeout=10)
        a = svc.submit(CacheRequest("how do transformers compute attention"))
        b = svc.submit(CacheRequest("best chocolate cake recipe for birthdays"))
        assert _wait_for(lambda: svc.scheduler_stats[1].submitted >= 3)
        backend.gate.set()
        assert a.result(timeout=10).text != b.result(timeout=10).text
        blocker.result(timeout=10)
    assert svc.stats.deduped == 0


def test_force_fresh_requests_never_coalesce():
    backend = GatedLLM()
    client, _ = _client(backend=backend)
    with CacheService(client, max_batch=8, max_wait_ms=2.0) as svc:
        blocker = svc.submit(CacheRequest("blocker question zzz"))
        assert backend.entered.wait(timeout=10)
        futs = [svc.submit(CacheRequest("identical fresh prompt", force_fresh=True))
                for _ in range(2)]
        assert _wait_for(lambda: svc.scheduler_stats[1].submitted >= 3)
        backend.gate.set()
        for f in futs:
            assert f.result(timeout=10).status == GENERATED
        blocker.result(timeout=10)
    assert svc.stats.deduped == 0
    assert backend.order.count("identical fresh prompt") == 2


def test_dedup_disabled_generates_per_miss():
    backend = GatedLLM()
    client, _ = _client(backend=backend)
    with CacheService(client, max_batch=8, max_wait_ms=2.0,
                      dedup_misses=False) as svc:
        blocker = svc.submit(CacheRequest("blocker question zzz"))
        assert backend.entered.wait(timeout=10)
        futs = [svc.submit(CacheRequest("identical prompt twice")) for _ in range(2)]
        assert _wait_for(lambda: svc.scheduler_stats[1].submitted >= 3)
        backend.gate.set()
        for f in futs:
            f.result(timeout=10)
        blocker.result(timeout=10)
    assert svc.stats.deduped == 0
    assert backend.order.count("identical prompt twice") == 2


def test_sync_complete_path_does_not_dedup():
    """The inline complete() path must stay decision-identical to B
    sequential lookups: no dedup (each miss generates)."""
    client, _ = _client()
    svc = CacheService(client)
    rs = svc.complete([CacheRequest("same sync prompt"), CacheRequest("same sync prompt")])
    assert [r.status for r in rs] == [GENERATED, GENERATED]
    assert svc.stats.deduped == 0


def test_dedup_disabled_on_non_cosine_metric():
    """The dedup criterion is cosine-vs-threshold; a euclidean/dot cache's
    threshold lives in a different score space, so dedup must not fire."""
    from repro_torch.serving.service import _Pending

    cache = GenerativeCache(NgramHashEmbedder(), threshold=0.85, t_single=0.45,
                            t_combined=1.0, metric="euclidean")
    client = EnhancedClient(cache=cache)
    client.register_backend(MockLLM("backend"))
    svc = CacheService(client)
    t0 = time.perf_counter()
    pendings = [
        _Pending(CacheRequest("identical prompt"), rid, "backend", t0, None,
                 vec=np.ones(cache.embedder.dim, np.float32))
        for rid in range(2)
    ]
    assert svc._dedup_misses(pendings, [0, 1]) == {}


class StallingDeadlineLLM(LLMBackend):
    """Deadline-aware backend that stalls exactly long enough for a deadline
    carried into ``generate_batch`` to pass mid-generation: those prompts
    come back ``expired=True``, the rest generate normally. First call
    blocks on ``gate`` like GatedLLM so tests can pile work behind it."""

    name = "stalling"

    def __init__(self, stall_s: float = 1.3):
        self.stall_s = stall_s
        self.calls = []
        self.gate = threading.Event()
        self.entered = threading.Event()

    def generate_batch(self, prompts, max_tokens: int = 256,
                       temperature: float = 0.0, deadlines=None):
        self.calls.append((tuple(prompts), deadlines))
        if not self.entered.is_set():
            self.entered.set()
            assert self.gate.wait(timeout=10)
        if deadlines is not None and any(d is not None for d in deadlines):
            time.sleep(self.stall_s)
        now = time.perf_counter()
        out = []
        for i, p in enumerate(prompts):
            dl = deadlines[i] if deadlines is not None else None
            if dl is not None and now > dl:
                out.append(LLMResponse("", self.name, expired=True))
            else:
                out.append(LLMResponse(f"generated: {p}", self.name))
        return out


def test_deduped_follower_regenerates_when_leader_expires_mid_generation():
    """Regression: a deduped follower must not inherit its leader's
    mid-generation deadline expiry. A follower with headroom re-dispatches
    and generates; one whose own deadline also passed resolves with its OWN
    typed DEADLINE_EXCEEDED response (own request_id, own latency)."""
    backend = StallingDeadlineLLM(stall_s=1.3)
    client, cache = _client(backend=backend)
    cache.lookup_batch(["warm 1"])  # compile outside the timing-sensitive window
    with CacheService(client, max_batch=8, max_wait_ms=2.0) as svc:
        blocker = svc.submit(CacheRequest("blocker question zzz"))
        assert backend.entered.wait(timeout=10)
        # leader first (it becomes the dedup leader), then two followers
        lead_f = svc.submit(CacheRequest("the shared doomed prompt", deadline_s=1.0))
        free_f = svc.submit(CacheRequest("the shared doomed prompt"))
        tight_f = svc.submit(CacheRequest("the shared doomed prompt", deadline_s=1.0))
        assert _wait_for(lambda: svc.scheduler_stats[1].submitted >= 4)
        backend.gate.set()
        lead = lead_f.result(timeout=15)
        free = free_f.result(timeout=15)
        tight = tight_f.result(timeout=15)
        blocker.result(timeout=15)
    # the leader's deadline passed while the backend stalled
    assert lead.status == DEADLINE_EXCEEDED and lead.text is None
    # the deadline-free follower regenerated instead of inheriting the expiry
    assert free.status == GENERATED
    assert free.text == "generated: the shared doomed prompt"
    assert free.request_id != lead.request_id
    # the tight follower had no headroom left: its OWN typed expiry, own rid
    assert tight.status == DEADLINE_EXCEEDED
    assert tight.request_id not in (lead.request_id, free.request_id)
    assert svc.stats.deduped == 2
    assert svc.stats.expired == 2  # leader mid-generation + tight follower
    assert svc.stats.generated == 2  # blocker + the follower's regeneration
    # three backend calls: blocker, the stalled dedup group, the regen retry
    assert len(backend.calls) == 3
    prompts, ddls = backend.calls[2]
    assert prompts == ("the shared doomed prompt",) and ddls is None
