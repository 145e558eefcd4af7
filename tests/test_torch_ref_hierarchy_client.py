"""The reference's ``tests/test_hierarchy_client.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

L1/L2 hierarchy (§4) and the enhanced client (§5).
"""
import time

import pytest

from repro_torch.core import (
    EnhancedClient,
    GenerativeCache,
    HierarchicalCache,
    MockLLM,
    ModelCostInfo,
    NgramHashEmbedder,
    ThresholdPolicy,
)
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


Q1 = "What is an application-level denial of service attack?"
Q2 = "What are the most effective techniques for defending against denial-of-service attacks?"


@pytest.fixture
def emb():
    return NgramHashEmbedder()


def _gc(emb, **kw):
    kw.setdefault("threshold", 0.85)
    kw.setdefault("t_single", 0.45)
    kw.setdefault("t_combined", 1.0)
    return GenerativeCache(emb, **kw)


def test_l2_hit_promotes_to_l1(emb):
    l1, l2 = _gc(emb, capacity=16), _gc(emb, capacity=64)
    h = HierarchicalCache(l1, l2)
    l2.insert(Q1, "A1")
    r = h.lookup(Q1)
    assert r.hit and r.level.startswith("L2")
    assert h.lookup(Q1).level.startswith("L1")  # promoted


def test_peer_l2_cooperation(emb):
    l1, l2, peer = _gc(emb), _gc(emb), _gc(emb)
    h = HierarchicalCache(l1, l2, peers=[peer])
    peer.insert(Q1, "A1")
    r = h.lookup(Q1)
    assert r.hit and "peer" in r.level


def test_privacy_hints_keep_personal_out_of_l2(emb):
    l1, l2 = _gc(emb), _gc(emb)
    h = HierarchicalCache(l1, l2)
    h.insert("What are my test results for patient id 1234?", "personal", cache_l2=False)
    assert len(l1.store) == 1
    assert len(l2.store) == 0


def test_generative_across_levels(emb):
    """Q1 cached in L1, Q2 in L2 -> combined generative hit pools both."""
    l1, l2 = _gc(emb), _gc(emb)
    h = HierarchicalCache(l1, l2)
    l1.insert(Q1, "A1")
    l2.insert(Q2, "A2")
    q3 = ("What is an application-level denial of service attack, and what are the "
          "most effective techniques for defending against such attacks?")
    r = h.lookup(q3)
    assert r.hit and r.generative and "multi-level" in r.level
    assert "A1" in r.response and "A2" in r.response


def test_client_cache_roundtrip(emb):
    client = EnhancedClient(cache=_gc(emb))
    client.register_backend(MockLLM("m1"))
    r1 = client.query(Q1)
    assert not r1.from_cache
    r2 = client.query(Q1)
    assert r2.from_cache and r2.cost_usd == 0.0
    assert client.stats.cache_hits == 1 and client.stats.llm_calls == 1


def test_client_force_fresh_adds_second_response(emb):
    cache = _gc(emb)
    client = EnhancedClient(cache=cache)
    client.register_backend(MockLLM("m1", responder=lambda p: f"r{time.perf_counter_ns()}"))
    client.query(Q1)
    r = client.query(Q1, force_fresh=True)  # §5.2: user explicitly wants a new response
    assert not r.from_cache
    assert len(cache.store) == 2  # both responses cached for the same query


def test_client_failover(emb):
    from repro_torch.resilience import RetryPolicy

    client = EnhancedClient(
        cache=_gc(emb),
        retry_policy=RetryPolicy(max_attempts=2, base_backoff_s=0.0, jitter=0.0),
    )
    client.register_backend(MockLLM("dead", fail=True))
    client.register_backend(MockLLM("alive"))
    r = client.query("hello there")
    assert r.model == "alive"
    assert client.stats.llm_errors == 2  # both attempts against the dead backend
    assert client.stats.retries == 1


def test_client_parallel_dispatch(emb):
    client = EnhancedClient(cache=None)
    client.register_backend(MockLLM("slow", latency_s=0.05))
    prompts = [f"question {i}" for i in range(8)]
    t0 = time.perf_counter()
    rs = client.query_many(prompts, use_cache=False)
    elapsed = time.perf_counter() - t0
    assert len(rs) == 8
    assert elapsed < 8 * 0.05  # parallel speedup (paper §5.2)


def test_client_broadcast_multiple_llms(emb):
    client = EnhancedClient(cache=None)
    client.register_backend(MockLLM("m1"))
    client.register_backend(MockLLM("m2"))
    out = client.broadcast("same question")
    assert set(out) == {"m1", "m2"}


def test_model_escalation_on_dissatisfaction(emb):
    client = EnhancedClient(cache=None)
    client.register_backend(MockLLM("cheap"), ModelCostInfo(0.5, 1.5, 1))
    client.register_backend(MockLLM("pricey"), ModelCostInfo(60, 120, 10))
    r = client.query("q1", use_cache=False)
    assert r.model == "cheap"
    client.feedback(r, satisfied=False)
    r2 = client.query("q2", use_cache=False)
    assert r2.model == "pricey"
    client.feedback(r2, satisfied=True)
    assert client.query("q3", use_cache=False).model == "cheap"


def test_cost_accounting(emb):
    client = EnhancedClient(cache=_gc(emb))
    client.register_backend(MockLLM("m"), ModelCostInfo(1.0, 2.0, 1))
    r = client.query("a question with some words")
    assert r.cost_usd > 0
    assert client.stats.total_cost_usd == pytest.approx(r.cost_usd)


def test_max_tokens_limits_response(emb):
    client = EnhancedClient(cache=None)
    client.register_backend(MockLLM("m", responder=lambda p: "word " * 100))
    r = client.query("q", max_tokens=5, use_cache=False)
    assert len(r.text.split()) <= 5
