"""The reference's ``tests/test_resilience.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

Resilience subsystem: breaker FSM, deadline-aware retry, typed failover
errors, seeded fault injection, and the serve-stale degradation ladder.

Everything here is deterministic: breakers run on an injectable fake
clock, retry jitter is pinned by seeded draws, and every chaos fixture
goes through a ``FaultInjector`` with a fixed seed — the same schedule
produces the same faults on every run.
"""
import json
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the cache under the service is jax-backed

from repro_torch.core import (  # noqa: E402
    EnhancedClient,
    GenerativeCache,
    MockLLM,
    NgramHashEmbedder,
)
from repro_torch.core.client import LLMResponse  # noqa: E402
from repro_torch.core.request import GENERATED, STALE, CacheRequest  # noqa: E402
from repro_torch.gateway.errors import map_exception  # noqa: E402
from repro_torch.resilience import (  # noqa: E402
    CLOSED,
    HALF_OPEN,
    OPEN,
    AllBackendsFailed,
    BackendFailure,
    CircuitBreaker,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    RetryBudget,
    RetryPolicy,
)
from repro_torch.serving.service import CacheService  # noqa: E402
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


class Clock:
    """Injectable monotonic clock for breaker tests — no sleeping."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FlakyBackend:
    """Minimal LLMBackend: fails on demand, counts real calls."""

    supports_deadlines = False

    def __init__(self, name="flaky", fail=True):
        self.name = name
        self.fail = fail
        self.calls = 0

    def generate(self, prompt, max_tokens=256, temperature=0.0):
        return self.generate_batch([prompt], max_tokens, temperature)[0]

    def generate_batch(self, prompts, max_tokens=256, temperature=0.0):
        self.calls += 1
        if self.fail:
            raise ConnectionError(f"{self.name} unreachable")
        return [
            LLMResponse(f"[{self.name}] answer to: {p}", self.name,
                        tokens_in=1, tokens_out=1)
            for p in prompts
        ]


FAST_RETRY = RetryPolicy(max_attempts=2, base_backoff_s=0.0, jitter=0.0)


# -- circuit breaker FSM --------------------------------------------------------


def test_breaker_trip_open_halfopen_close():
    clk = Clock()
    br = CircuitBreaker("b", failure_threshold=3, recovery_s=5.0, time_fn=clk)
    assert br.state == CLOSED and br.allow()
    assert not br.record_failure()
    assert not br.record_failure()
    assert br.record_failure()  # third consecutive failure trips
    assert br.state == OPEN
    assert not br.allow() and not br.allow()  # fast-fail: no call burned
    assert br.snapshot()["open_skips"] == 2
    clk.t = 4.99
    assert not br.allow()  # recovery window not elapsed yet
    clk.t = 5.0
    assert br.allow()  # admitted as THE half-open probe
    assert br.state == HALF_OPEN
    assert not br.allow()  # probe budget is 1
    br.record_success()
    assert br.state == CLOSED and br.allow()
    snap = br.snapshot()
    assert snap["trips"] == 1 and snap["consecutive_failures"] == 0


def test_breaker_halfopen_failure_reopens_with_fresh_timer():
    clk = Clock()
    br = CircuitBreaker("b", failure_threshold=1, recovery_s=1.0, time_fn=clk)
    assert br.record_failure()
    clk.t = 1.0
    assert br.allow()  # the probe
    assert br.record_failure()  # failed probe -> OPEN again, a second trip
    assert br.state == OPEN
    clk.t = 1.9
    assert not br.allow()  # timer restarted at the SECOND trip
    clk.t = 2.0
    assert br.allow()
    br.record_success()
    assert br.state == CLOSED
    assert br.snapshot()["trips"] == 2


def test_breaker_health_score_trips_flapper():
    # 2 fail / 1 success repeating never reaches 3 consecutive failures,
    # but the EMA health score sinks below the floor and trips anyway —
    # the mode a consecutive-only breaker cannot catch
    br = CircuitBreaker("b", failure_threshold=3, health_alpha=0.4,
                        health_floor=0.45)
    tripped = False
    for _ in range(20):
        if br.record_failure() or br.record_failure():
            tripped = True
            break
        br.record_success()
    assert tripped
    assert br.snapshot()["consecutive_failures"] < 3  # not the consecutive rule


# -- retry policy + budget ------------------------------------------------------


def test_backoff_deterministic_and_capped():
    pol = RetryPolicy(max_attempts=4, base_backoff_s=0.1, max_backoff_s=0.3,
                      multiplier=2.0, jitter=0.5)
    assert pol.backoff_s(1, draw=0.5) == pytest.approx(0.1)  # midpoint: no jitter
    assert pol.backoff_s(2, draw=0.5) == pytest.approx(0.2)
    assert pol.backoff_s(3, draw=0.5) == pytest.approx(0.3)  # capped
    assert pol.backoff_s(4, draw=0.5) == pytest.approx(0.3)
    assert pol.backoff_s(1, draw=0.0) == pytest.approx(0.05)  # -jitter edge
    assert pol.backoff_s(1, draw=1.0) == pytest.approx(0.15)  # +jitter edge


def test_retry_budget_token_bucket():
    b = RetryBudget(capacity=2.0, ratio=0.5)
    assert b.try_spend() and b.try_spend()
    assert not b.try_spend()  # dry
    b.deposit(2)  # two first attempts credit 2 * 0.5 = 1 token
    assert b.try_spend()
    assert not b.try_spend()
    snap = b.snapshot()
    assert snap["spent"] == 3 and snap["refused"] == 2


# -- client failover ------------------------------------------------------------


def test_all_backends_failed_is_typed_with_causes():
    b1, b2 = FlakyBackend("m1"), FlakyBackend("m2")
    client = EnhancedClient(retry_policy=FAST_RETRY)
    client.register_backend(b1)
    client.register_backend(b2)
    with pytest.raises(AllBackendsFailed) as ei:
        client._generate_batch_with_failover(None, ["q"], 64, 0.0)
    err = ei.value
    assert isinstance(err, ConnectionError)  # legacy except clauses still catch
    assert [c.backend for c in err.causes] == ["m1", "m2"]
    assert all(c.attempts == 2 for c in err.causes)
    assert err.causes[0].kinds == ["ConnectionError", "ConnectionError"]
    assert err.to_dict()["causes"][1]["backend"] == "m2"
    assert client.stats.all_backends_failed == 1
    assert client.stats.llm_errors == 4  # 2 backends x 2 attempts
    assert client.stats.retries == 2


def test_breaker_skips_dead_backend_then_probes_it_back():
    clk = Clock()
    b1, b2 = FlakyBackend("m1"), FlakyBackend("m2", fail=False)
    client = EnhancedClient(
        retry_policy=RetryPolicy(max_attempts=1),
        breaker_factory=lambda name: CircuitBreaker(
            name, failure_threshold=1, recovery_s=60.0, time_fn=clk
        ),
    )
    client.register_backend(b1)
    client.register_backend(b2)
    r1 = client._generate_batch_with_failover(None, ["q1"], 64, 0.0)
    assert r1[0].model == "m2" and b1.calls == 1
    assert client.breakers["m1"].state == OPEN
    assert client.stats.breaker_trips == 1
    r2 = client._generate_batch_with_failover(None, ["q2"], 64, 0.0)
    assert r2[0].model == "m2"
    assert b1.calls == 1  # open breaker: skipped without a call
    assert client.stats.breaker_open_skips == 1
    clk.t = 61.0  # recovery elapsed; next walk probes m1 (now healthy)
    b1.fail = False
    r3 = client._generate_batch_with_failover(None, ["q3"], 64, 0.0)
    assert r3[0].model == "m1"
    assert client.breakers["m1"].state == CLOSED
    assert client.breaker_snapshot()["m1"]["trips"] == 1


def test_deadline_expiry_is_not_a_backend_failure():
    b = FlakyBackend("dead")
    client = EnhancedClient(retry_policy=FAST_RETRY)
    client.register_backend(b)
    past = time.perf_counter() - 0.01
    rows = client._generate_batch_with_failover(None, ["q"], 64, 0.0,
                                                deadlines=[past])
    assert rows[0].expired
    assert b.calls == 0  # expiry burns no backend call...
    assert client.stats.llm_errors == 0  # ...and is not an error
    assert client.stats.all_backends_failed == 0


def test_no_retry_without_deadline_headroom():
    b = FlakyBackend("dead")
    client = EnhancedClient(
        retry_policy=RetryPolicy(max_attempts=5, base_backoff_s=10.0, jitter=0.0)
    )
    client.register_backend(b)
    deadline = time.perf_counter() + 0.5  # the 10 s backoff would sail past it
    t0 = time.perf_counter()
    with pytest.raises(AllBackendsFailed) as ei:
        client._generate_batch_with_failover(None, ["q"], 64, 0.0,
                                             deadlines=[deadline])
    assert time.perf_counter() - t0 < 0.4  # never slept the backoff
    assert b.calls == 1 and ei.value.causes[0].attempts == 1
    assert client.stats.retries == 0


def test_retry_budget_exhaustion_stops_retries():
    b = FlakyBackend("dead")
    budget = RetryBudget(capacity=1.0, ratio=0.0)
    client = EnhancedClient(
        retry_policy=RetryPolicy(max_attempts=10, base_backoff_s=0.0, jitter=0.0),
        retry_budget=budget,
    )
    client.register_backend(b)
    with pytest.raises(AllBackendsFailed):
        client._generate_batch_with_failover(None, ["q"], 64, 0.0)
    assert b.calls == 2  # first attempt + the single budgeted retry
    snap = budget.snapshot()
    assert snap["spent"] == 1 and snap["refused"] == 1


# -- fault injector -------------------------------------------------------------


def test_fault_injector_deterministic_across_runs():
    def run():
        inj = FaultInjector(seed=7)
        inj.schedule("b", FaultSpec("error", p=0.5))
        return [inj.plan("b")[1] is not None for _ in range(64)]

    a, b = run(), run()
    assert a == b
    assert any(a) and not all(a)  # p=0.5 actually branches both ways


def test_flap_schedule_phases_down_first():
    inj = FaultInjector(seed=0)
    inj.schedule("b", FaultSpec("flap", period=3))
    got = []
    for _ in range(12):
        _, spec = inj.plan("b")
        got.append(spec.kind if spec else None)
    assert got == ["flap"] * 3 + [None] * 3 + ["flap"] * 3 + [None] * 3


def test_faulty_backend_window_and_counters():
    inj = FaultInjector(seed=0)
    fb = inj.wrap_backend(MockLLM("m"))
    inj.schedule("m", FaultSpec("error", start=1, stop=3))
    assert fb.generate_batch(["a"])[0].text  # call 0: before the window
    for _ in range(2):  # calls 1-2: inside it
        with pytest.raises(InjectedFault):
            fb.generate_batch(["a"])
    assert fb.generate_batch(["a"])[0].text  # call 3: past the window
    snap = inj.snapshot()
    assert snap["calls"]["m"] == 4
    assert snap["injected"] == {"m:error": 2}


def test_hang_blocks_until_deadline_then_raises_typed():
    inj = FaultInjector(seed=0)
    fb = inj.wrap_backend(MockLLM("m"))
    inj.schedule("m", FaultSpec("hang", hang_s=5.0))
    deadline = time.perf_counter() + 0.05
    t0 = time.perf_counter()
    with pytest.raises(InjectedFault) as ei:
        fb.generate_batch(["a"], deadlines=[deadline])
    dt = time.perf_counter() - t0
    assert 0.04 <= dt < 1.0  # slept to the deadline, NOT the 5 s hang_s
    assert ei.value.kind == "hang"


# -- serve-stale ladder (service level) -----------------------------------------


def _stale_stack():
    cache = GenerativeCache(NgramHashEmbedder(), threshold=0.8, capacity=64,
                            cache_synthesized=False)
    client = EnhancedClient(cache=cache, retry_policy=FAST_RETRY)
    backend = FlakyBackend("origin", fail=False)
    client.register_backend(backend)
    service = CacheService(client, max_batch=4, max_wait_ms=1.0)
    return service, client, cache, backend


def test_serve_stale_byte_parity_then_refusals():
    service, client, _, backend = _stale_stack()
    try:
        r0 = service.submit(
            CacheRequest("alpha question about pandas", ttl_s=0.05)
        ).result(timeout=30)
        assert r0.status == GENERATED
        time.sleep(0.12)  # entry is now expired
        backend.fail = True

        # without the opt-in, the outage surfaces as the typed error
        with pytest.raises(AllBackendsFailed):
            service.submit(
                CacheRequest("alpha question about pandas")
            ).result(timeout=30)

        r1 = service.submit(
            CacheRequest("alpha question about pandas", allow_stale=True)
        ).result(timeout=30)
        assert r1.status == STALE and r1.from_cache
        assert r1.cache_status == "stale"
        assert r1.resolved_level == "stale"
        assert r1.cache_result.level.startswith("stale:")
        assert r1.text == r0.text  # byte parity with the original answer

        # a bound tighter than the entry's age refuses the stale answer
        with pytest.raises(AllBackendsFailed):
            service.submit(
                CacheRequest("alpha question about pandas", allow_stale=True,
                             max_stale_s=1e-4)
            ).result(timeout=30)

        assert service.stats.stale_served == 1
        assert service.stats.backend_unavailable == 2
        assert client.stats.all_backends_failed >= 3
    finally:
        service.close()


def test_gateway_serves_stale_header_and_maps_503():
    from repro_torch.gateway.app import serve_in_thread
    from repro_torch.gateway.client import GatewayClient

    service, _, _, backend = _stale_stack()
    r0 = service.submit(
        CacheRequest("beta question about llamas", ttl_s=0.05)
    ).result(timeout=30)
    time.sleep(0.12)
    backend.fail = True
    runner = serve_in_thread(service, own_service=True)
    try:
        with GatewayClient("127.0.0.1", runner.gateway.port, timeout=30.0) as gw:
            ok = gw.request(
                "POST", "/v1/completions",
                {"prompt": "beta question about llamas", "allow_stale": True},
            )
            assert ok.status == 200
            assert ok.headers.get("x-cache") == "stale"
            assert ok.text == r0.text  # byte parity over the wire

            bad = gw.request(
                "POST", "/v1/completions",
                {"prompt": "beta question about llamas"},
            )
            assert bad.status == 503
            assert bad.headers.get("retry-after")
            assert bad.json()["error"]["code"] == "backend_unavailable"

            neg = gw.request(
                "POST", "/v1/completions",
                {"prompt": "x", "max_stale_s": -1},
            )
            assert neg.status == 400
    finally:
        runner.stop()


def test_map_exception_all_backends_failed_envelope():
    exc = AllBackendsFailed([
        BackendFailure("m1", attempts=2,
                       errors=["ConnectionError('x')"] * 2,
                       kinds=["ConnectionError"] * 2),
        BackendFailure("m2", skipped=True),
    ])
    status, headers, body = map_exception(exc)
    assert status == 503
    assert ("Retry-After", "1") in headers
    err = json.loads(body)["error"]
    assert err["type"] == "service_unavailable"
    assert err["code"] == "backend_unavailable"
    assert "m1" in err["message"] and "breaker open" in err["message"]
    assert exc.skipped_backends == ["m2"]


# -- stats surfaces -------------------------------------------------------------


def test_healthz_degrades_when_every_breaker_is_open():
    from repro_torch.gateway.app import serve_in_thread
    from repro_torch.gateway.client import GatewayClient

    service, client, _, backend = _stale_stack()
    backend.fail = True
    runner = serve_in_thread(service, own_service=True)
    try:
        with GatewayClient("127.0.0.1", runner.gateway.port, timeout=30.0) as gw:
            h0 = gw.request("GET", "/healthz").json()
            assert h0["status"] == "ok"
            assert h0["breakers"]["origin"]["state"] == CLOSED
            client.breakers["origin"].force_open()
            h1 = gw.request("GET", "/healthz").json()
            assert h1["status"] == "degraded"
            assert h1["breakers"]["origin"]["state"] == OPEN
            stats = gw.request("GET", "/v1/cache/stats").json()
            assert stats["breakers"]["origin"]["trips"] == 1
            assert "retry_budget" in stats
            assert "stale_served" in stats["service"]
            assert "breaker_trips" in stats["client"]
    finally:
        runner.stop()


def test_fault_injector_feeds_client_stats_deterministically():
    # wraps a real failover walk in a seeded flap schedule: the SAME seed
    # must produce the SAME retry/trip/error counters every run
    def run():
        inj = FaultInjector(seed=3)
        inner = MockLLM("flappy")
        inj.schedule("flappy", FaultSpec("flap", period=2))
        client = EnhancedClient(
            retry_policy=RetryPolicy(max_attempts=2, base_backoff_s=0.0, jitter=0.0),
            breaker_factory=lambda name: CircuitBreaker(
                name, failure_threshold=2, recovery_s=0.0
            ),
        )
        client.register_backend(inj.wrap_backend(inner))
        served = 0
        for i in range(8):
            try:
                client._generate_batch_with_failover(None, [f"q{i}"], 16, 0.0)
                served += 1
            except AllBackendsFailed:
                pass
        s = client.stats
        return (served, s.llm_errors, s.retries, s.breaker_trips,
                inj.snapshot()["injected"])

    assert run() == run()
