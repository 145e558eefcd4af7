"""The port's HTTP gateway against the reference's, over real sockets.

Each scenario builds the same MockLLM-backed stack from each package
(the port's stores on the CPU), serves it through that package's
``serve_in_thread`` on 127.0.0.1, and sends the same request sequence
through that package's ``GatewayClient``. Status codes, ``X-Cache``,
``X-Cache-Level``, ``Retry-After``/``Allow`` and the body bytes are equal;
``X-Cache-Similarity`` within 2e-5 as a float. Left out of the comparison:
the completion ``id`` and ``created`` fields, ``X-Request-Id`` and the
latency (``X-Service-Latency-Ms``, and the elapsed milliseconds a 504's
message quotes).

The port is also held to the assertions of the reference's own gateway
tests where they do not compare packages: streamed/non-streamed byte
parity, the drain (``stop()`` returns True within 2 s while a keep-alive
client is open, and every in-flight request resolves) and the ``astream``
facade. The reference's drain test stays red on Python >= 3.12.1: its
``drain`` awaits ``Server.wait_closed()`` before it closes the idle
keep-alive connections that call waits for; the port closes them first.
"""
import asyncio
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import repro.core as J
import repro.gateway as JG
import repro_torch.core as T
import repro_torch.gateway as TG
from repro.core.tiers import HostRamTier as JTier
from repro.core.vector_store import InMemoryVectorStore as JStore
from repro.gateway import errors as jerrors
from repro.gateway.protocol import ProtocolError as JProtocolError
from repro.resilience.errors import AllBackendsFailed as JAllFailed
from repro.resilience.errors import BackendFailure as JFailure
from repro.serving.coalescer import AdmissionRejected as JRejected
from repro.serving.coalescer import ServiceClosed as JClosed
from repro.serving.service import CacheService as JService
from repro_torch.core.request import split_stream_tokens
from repro_torch.core.tiers import HostRamTier as TTier
from repro_torch.core.vector_store import InMemoryVectorStore as TStore
from repro_torch.gateway import errors as terrors
from repro_torch.gateway.protocol import ProtocolError as TProtocolError
from repro_torch.resilience.errors import AllBackendsFailed as TAllFailed
from repro_torch.resilience.errors import BackendFailure as TFailure
from repro_torch.serving.coalescer import AdmissionRejected as TRejected
from repro_torch.serving.coalescer import ServiceClosed as TClosed
from repro_torch.serving.service import CacheService as TService

torch.set_num_threads(1)

Q_A = "how does the storage subsystem behave under heavy load"
Q_B = "how does the routing subsystem behave under heavy load"
SIM_TOL = 2e-5

# one namespace per package: what a scenario needs to build and drive a stack
PKGS = {
    "reference": dict(core=J, gw=JG, service=JService, store=JStore, tier=JTier, dev={}),
    "port": dict(core=T, gw=TG, service=TService, store=TStore, tier=TTier,
                 dev={"device": "cpu"}),
}


def _gated(P):
    """A backend whose first ``generate_batch`` blocks on ``gate`` (as the
    reference's service tests' ``GatedLLM``), built on ``P``'s LLMBackend."""

    class Gated(P["core"].LLMBackend):
        name = "gated"

        def __init__(self):
            self.gate = threading.Event()
            self.entered = threading.Event()

        def generate_batch(self, prompts, max_tokens=256, temperature=0.0):
            if not self.entered.is_set():
                self.entered.set()
                assert self.gate.wait(timeout=10)
            return [P["core"].LLMResponse(f"generated: {p}", self.name) for p in prompts]

    return Gated()


def _down(P):
    """A backend that always fails: misses with no stale entry get a 503."""

    class Down(P["core"].LLMBackend):
        name = "down"

        def generate_batch(self, prompts, max_tokens=256, temperature=0.0):
            raise ConnectionError("upstream refused the connection")

    return Down()


def _service(P, backend=None, *, tier1=False, threshold=0.8, **svc_kw):
    """The reference gateway tests' stack, from package ``P``."""
    C = P["core"]
    emb = C.NgramHashEmbedder()
    store = None
    if tier1:
        store = P["store"](emb.dim, capacity=2, eviction="lru",
                           tier1=P["tier"](emb.dim, capacity=16), **P["dev"])
    cache = C.GenerativeCache(emb, threshold=threshold, t_single=0.45, t_combined=1.0,
                              store=store, cache_synthesized=False, **P["dev"])
    client = C.EnhancedClient(cache=cache)
    client.register_backend(backend or C.MockLLM("backend", latency_s=0.0))
    return P["service"](client, max_batch=8, max_wait_ms=1.0, **svc_kw)


_ID = re.compile(rb'"id": "[^"]*", ')
_CREATED = re.compile(rb'"created": \d+, ')
_ELAPSED = re.compile(rb"after [0-9.]+ ms in service")


def _wire(reply):
    """What must be equal across packages: everything but ids, stamps and
    latency; the similarity separately, as a float."""
    body = _ELAPSED.sub(b"after <t> ms in service", _CREATED.sub(b"", _ID.sub(b"", reply.body)))
    h = reply.headers
    keep = ("x-cache", "x-cache-level", "retry-after", "allow", "content-type",
            "transfer-encoding", "cache-control")
    return reply.status, {k: h[k] for k in keep if k in h}, body


def _similarity(reply):
    s = reply.headers.get("x-cache-similarity")
    return None if s is None else float(s)


def _serve(P, service):
    return P["gw"].serve_in_thread(service, own_service=True)


def _assert_same_wire(jreplies, treplies):
    assert len(treplies) == len(jreplies)
    for i, (j, t) in enumerate(zip(jreplies, treplies)):
        assert _wire(t) == _wire(j), f"reply {i}"
        sj, st = _similarity(j), _similarity(t)
        assert (sj is None) == (st is None), f"reply {i}"
        if sj is not None:
            assert abs(sj - st) <= SIM_TOL, f"reply {i}: {st} vs {sj}"


# -- scenarios: each drives one fresh stack per package -------------------------


def _basic(P):
    """Misses, hits, streamed and not, both surfaces, the ops endpoints and
    every parse/route error shape."""
    runner = _serve(P, _service(P))
    out = []
    try:
        with P["gw"].GatewayClient("127.0.0.1", runner.gateway.port) as http:
            out.append(http.chat(Q_A))  # miss
            out.append(http.chat(Q_A))  # hit
            out.append(http.chat(Q_A, stream=True))  # streamed hit
            out.append(http.completion("streamed cold prompt never seen", stream=True))
            out.append(http.completion("streamed cold prompt never seen"))  # hit
            out.append(http.completion("a plain completion prompt", max_tokens=16))
            out.append(http.chat(Q_B, system="be brief", stream=True))  # streamed miss
            out.append(http.healthz())
            stats = http.cache_stats()
            out.append(http.request("POST", "/v1/chat/completions", {"messages": []}))
            out.append(http.request("POST", "/v1/completions", {}))
            out.append(http.request("POST", "/v1/completions", {"prompt": "x", "max_tokens": "many"}))
            out.append(http.request("POST", "/v1/chat/completions", {"messages": [{"role": "user"}]}))
            out.append(http.request("POST", "/v1/completions", {"prompt": "x", "priority": True}))
            out.append(http.request("GET", "/v2/everything"))
            out.append(http.request("POST", "/healthz", {}))
            out.append(http.request("GET", "/v1/chat/completions"))
            # a body that is not JSON: a 400, and the server closes the connection
            conn = http._connection()
            conn.request("POST", "/v1/chat/completions", body=b"{nope",
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out.append(P["gw"].GatewayReply(resp.status, {k.lower(): v for k, v in resp.getheaders()},
                                            resp.read()))
            http.close()
    finally:
        assert runner.stop()
    return out, stats.json()


def _four_classes(P):
    """miss, hit, generative and tier1 (the reference's all-four test)."""
    runner = _serve(P, _service(P, tier1=True, threshold=0.93))
    try:
        with P["gw"].GatewayClient("127.0.0.1", runner.gateway.port) as http:
            return [http.completion(p) for p in
                    (Q_A, Q_A, Q_B, f"{Q_A} and also {Q_B}", "some third filler prompt", Q_A)]
    finally:
        assert runner.stop()


def _deadline(P):
    runner = _serve(P, _service(P, P["core"].MockLLM("slow", latency_s=0.5)))
    try:
        with P["gw"].GatewayClient("127.0.0.1", runner.gateway.port) as http:
            return [http.completion("too slow to make it", deadline_ms=30),
                    http.completion("still too slow to make it", deadline_ms=30, stream=True)]
    finally:
        assert runner.stop()


def _backend_down(P):
    runner = _serve(P, _service(P, _down(P)))
    try:
        with P["gw"].GatewayClient("127.0.0.1", runner.gateway.port) as http:
            return [http.completion("nobody can answer this"),
                    http.chat("nor this one", stream=True)]
    finally:
        assert runner.stop()


def _admission(P):
    backend = _gated(P)
    runner = _serve(P, _service(P, backend, max_inflight=1))
    try:
        port = runner.gateway.port

        def one(i):
            with P["gw"].GatewayClient("127.0.0.1", port, timeout=30.0) as c:
                return c.completion(f"admission probe {i}")

        with ThreadPoolExecutor(max_workers=6) as pool:
            first = pool.submit(one, 0)
            assert backend.entered.wait(timeout=10)  # the only slot is taken
            shed = [f.result() for f in [pool.submit(one, i) for i in range(1, 6)]]
            backend.gate.set()
            return [first.result()] + shed
    finally:
        assert runner.stop()


def test_basic_surface_matches_reference():
    (jr, jstats), (tr, tstats) = _basic(PKGS["reference"]), _basic(PKGS["port"])
    _assert_same_wire(jr, tr)
    assert [r.headers.get("x-cache") for r in tr[:7]] == ["miss", "hit", "hit", "miss", "hit",
                                                          "miss", "miss"]
    assert [r.status for r in tr[7:]] == [200, 400, 400, 400, 400, 400, 404, 405, 405, 400]
    assert tr[14].headers["allow"] == "GET" and tr[15].headers["allow"] == "POST"
    for k in ("gateway", "service"):
        tstats[k].pop("inflight", None), jstats[k].pop("inflight", None)
        assert tstats[k] == jstats[k]


def test_streamed_replies_match_their_nonstreamed_bodies():
    tr, _ = _basic(PKGS["port"])
    plain_hit, sse_hit = tr[1], tr[2]
    assert sse_hit.headers["content-type"].startswith("text/event-stream")
    assert sse_hit.done and sse_hit.text == plain_hit.text
    assert len(sse_hit.events) >= len(split_stream_tokens(plain_hit.text))
    assert sse_hit.events[0]["choices"][0]["delta"].get("role") == "assistant"
    assert sse_hit.events[-1]["choices"][0]["finish_reason"] == "stop"
    assert all(e["object"] == "chat.completion.chunk" for e in sse_hit.events)
    sse_miss, plain_repeat = tr[3], tr[4]
    assert sse_miss.headers["x-cache"] == "miss" and plain_repeat.headers["x-cache"] == "hit"
    assert sse_miss.text == plain_repeat.text
    assert all(e["object"] == "text_completion" for e in sse_miss.events)


@pytest.mark.parametrize("scenario", [_four_classes, _deadline, _backend_down, _admission],
                         ids=lambda f: f.__name__.strip("_"))
def test_scenario_matches_reference(scenario):
    jr, tr = scenario(PKGS["reference"]), scenario(PKGS["port"])
    _assert_same_wire(jr, tr)
    statuses = [r.status for r in tr]
    if scenario is _four_classes:
        assert [r.headers["x-cache"] for r in tr] == ["miss", "hit", "miss", "generative",
                                                      "miss", "tier1"]
        assert "tier1" in tr[-1].headers["x-cache-level"]
    elif scenario is _deadline:
        assert statuses == [504, 504]
        assert tr[0].json()["error"]["code"] == "deadline_exceeded"
    elif scenario is _backend_down:
        assert statuses == [503, 503] and all(r.headers["retry-after"] == "1" for r in tr)
        assert all(r.json()["error"]["code"] == "backend_unavailable" for r in tr)
    else:
        assert statuses == [200] + [429] * 5
        assert all(r.headers["retry-after"] == "1" for r in tr[1:])
        assert all(r.json()["error"]["code"] == "admission_rejected" for r in tr[1:])


def _exceptions(pkg):
    """One instance of every exception the gateway maps, per package."""
    if pkg == "reference":
        PE, AR, AF, BF, SC = JProtocolError, JRejected, JAllFailed, JFailure, JClosed
    else:
        PE, AR, AF, BF, SC = TProtocolError, TRejected, TAllFailed, TFailure, TClosed
    return {
        "protocol": PE(400, "'max_tokens' must be int"),
        "admission": AR("inflight budget 1 exhausted"),
        "backends": AF([BF("a", attempts=2, kinds=["ConnectionError"]), BF("b", skipped=True)]),
        "closed": SC("service is closed"),
        "other": RuntimeError("boom"),
    }


@pytest.mark.parametrize("kind", ["protocol", "admission", "backends", "closed", "other"])
def test_map_exception_matches_reference(kind):
    assert terrors.map_exception(_exceptions("port")[kind]) == \
        jerrors.map_exception(_exceptions("reference")[kind])


def test_fixed_error_shapes_match_reference():
    assert terrors.not_found("/x") == jerrors.not_found("/x")
    assert terrors.method_not_allowed("PUT", "POST") == jerrors.method_not_allowed("PUT", "POST")
    assert terrors.draining_unavailable() == jerrors.draining_unavailable()
    assert terrors.draining_unavailable()[0] == 503


# -- the port's drain: the reference's drain assertions ---------------------------


def test_drain_with_an_idle_keepalive_client_is_clean_and_quick():
    P = PKGS["port"]
    runner = _serve(P, _service(P))
    with P["gw"].GatewayClient("127.0.0.1", runner.gateway.port) as http:
        assert http.completion("before drain").status == 200  # the connection stays open
        t0 = time.perf_counter()
        assert runner.stop()
        assert time.perf_counter() - t0 < 2.0
        with pytest.raises(Exception):  # listener and connection closed
            http.completion("after drain")


def test_drain_resolves_every_inflight_request():
    P = PKGS["port"]
    backend = _gated(P)
    runner = _serve(P, _service(P, backend))
    port = runner.gateway.port
    results = []

    def one(i):
        with P["gw"].GatewayClient("127.0.0.1", port, timeout=30.0) as c:
            results.append(c.completion(f"inflight during drain {i}"))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    assert backend.entered.wait(timeout=10)  # requests are inside the service
    stopper = threading.Thread(target=lambda: results.append(runner.stop()))
    stopper.start()
    time.sleep(0.1)  # the drain now waits on the gated backend
    backend.gate.set()
    for t in threads + [stopper]:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(r.status for r in results if hasattr(r, "status")) == [200] * 4
    assert True in [r for r in results if isinstance(r, bool)]


# -- the astream facade the gateway streams through --------------------------------


def test_astream_reassembles_byte_identical_to_sync():
    P = PKGS["port"]
    service = _service(P)
    try:
        prompt = "a multi token answer  with doubled spaces\nand a newline"
        sync = service.submit(T.CacheRequest(prompt)).result()

        async def collect(n):
            return [c async for c in service.astream(T.CacheRequest(prompt), chunk_tokens=n)]

        one, grouped = asyncio.run(collect(1)), asyncio.run(collect(3))
        assert "".join(c.text for c in one) == sync.text == "".join(c.text for c in grouped)
        assert len(grouped) < len(one)
        assert [c.index for c in one] == list(range(len(one)))
        assert [c.final for c in one] == [False] * (len(one) - 1) + [True]
        assert one[0].response.status == "hit"
    finally:
        service.close()


def test_astream_shed_raises_before_first_chunk():
    P = PKGS["port"]
    backend = _gated(P)
    service = _service(P, backend, max_inflight=1)
    try:
        blocker = service.submit(T.CacheRequest("occupy the only slot"))
        assert backend.entered.wait(timeout=10)

        async def go():
            await service.astream(T.CacheRequest("shed me")).__anext__()

        with pytest.raises(TRejected):
            asyncio.run(go())
        backend.gate.set()
        blocker.result(timeout=10)
    finally:
        service.close()
