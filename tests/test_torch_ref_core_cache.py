"""The reference's ``tests/test_core_cache.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

Core cache behavior: semantic cache, generative caching (§3), eviction,
persistence, GPTCache-like baseline parity.
"""
import numpy as np
import pytest

from repro_torch.core import (
    GPTCacheLike,
    GenerativeCache,
    InMemoryVectorStore,
    NgramHashEmbedder,
    SemanticCache,
)
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


Q1 = "What is an application-level denial of service attack?"
Q2 = "What are the most effective techniques for defending against denial-of-service attacks?"
Q3 = (
    "What is an application-level denial of service attack, and what are the most "
    "effective techniques for defending against such attacks?"
)


@pytest.fixture
def emb():
    return NgramHashEmbedder()


def test_exact_match_hits(emb):
    c = SemanticCache(emb, threshold=0.9)
    c.insert(Q1, "A1")
    r = c.lookup(Q1)
    assert r.hit and r.response == "A1" and r.similarity > 0.999


def test_paraphrase_hits_unrelated_misses(emb):
    c = SemanticCache(emb, threshold=0.7)
    c.insert(Q1, "A1")
    assert c.lookup("Please explain what an application-level denial of service attack is.").hit
    assert not c.lookup("What is the best recipe for chocolate cake?").hit


def test_generative_q1_q2_q3(emb):
    """The paper's §3 worked example: Q3 synthesized from Q1 + Q2."""
    c = GenerativeCache(emb, threshold=0.9, t_single=0.45, t_combined=1.0)
    c.insert(Q1, "A1: an app-level DoS attack explanation")
    c.insert(Q2, "A2: defenses against DoS")
    r = c.lookup(Q3)
    assert r.hit and r.generative
    assert r.combined_similarity > 1.0
    assert len(r.sources) == 2
    assert "A1" in r.response and "A2" in r.response
    # synthesized answer was cached: a Q3 paraphrase now hits
    r2 = c.lookup(
        "What is an application level denial of service attack and what are "
        "effective techniques for defending against those attacks?"
    )
    assert r2.hit


def test_generative_thresholds_order(emb):
    c = GenerativeCache(emb, threshold=0.8, t_single=0.6, t_combined=1.4)
    assert c.t_single < c.threshold < c.t_combined


def test_generative_primary_vs_secondary(emb):
    for mode in ("primary", "secondary"):
        c = GenerativeCache(emb, threshold=0.9, t_single=0.45, t_combined=1.0, mode=mode)
        c.insert(Q1, "A1")
        c.insert(Q2, "A2")
        assert c.lookup(Q3).hit, mode


def test_generative_miss_below_combined(emb):
    c = GenerativeCache(emb, threshold=0.9, t_single=0.45, t_combined=10.0)
    c.insert(Q1, "A1")
    c.insert(Q2, "A2")
    assert not c.lookup(Q3).hit


def test_eviction_lru(emb):
    store = InMemoryVectorStore(emb.dim, capacity=2, eviction="lru")
    c = SemanticCache(emb, threshold=0.95, store=store)
    c.insert("query one about topic alpha", "A")
    c.insert("query two about topic beta", "B")
    c.lookup("query one about topic alpha")  # touch A
    c.insert("query three about topic gamma", "C")  # evicts B (LRU)
    assert c.lookup("query one about topic alpha").hit
    assert not c.lookup("query two about topic beta").hit


def test_eviction_fifo(emb):
    store = InMemoryVectorStore(emb.dim, capacity=2, eviction="fifo")
    c = SemanticCache(emb, threshold=0.95, store=store)
    c.insert("first question about dogs", "A")
    c.insert("second question about cats", "B")
    c.insert("third question about fish", "C")
    assert not c.lookup("first question about dogs").hit
    assert c.lookup("second question about cats").hit


def test_persistence_roundtrip(tmp_path, emb):
    c = SemanticCache(emb, threshold=0.9)
    c.insert(Q1, "A1")
    c.insert(Q2, "A2")
    c.save(str(tmp_path / "cache"))
    c2 = SemanticCache(emb, threshold=0.9)
    c2.load_store(str(tmp_path / "cache"))
    assert c2.lookup(Q1).hit
    assert c2.lookup(Q2).response == "A2"


def test_load_store_preserves_flags_and_class(tmp_path, emb):
    """A save/load cycle must not silently rebuild the store with default
    constructor flags: use_pallas (and any store subclass) survive."""
    c = SemanticCache(emb, threshold=0.9, use_pallas=True, capacity=64)
    c.insert(Q1, "A1")
    c.save(str(tmp_path / "pallas"))
    c.load_store(str(tmp_path / "pallas"))
    assert c.store.use_pallas
    assert c.store.capacity == 64
    assert c.lookup(Q1).hit

    class TracingStore(InMemoryVectorStore):
        pass

    c2 = SemanticCache(emb, threshold=0.9, store=TracingStore(emb.dim, 32))
    c2.insert(Q2, "A2")
    c2.save(str(tmp_path / "custom"))
    c2.load_store(str(tmp_path / "custom"))
    assert type(c2.store) is TracingStore
    assert c2.lookup(Q2).response == "A2"


def test_insert_batch_matches_sequential_inserts(emb):
    a, b = SemanticCache(emb, threshold=0.9), SemanticCache(emb, threshold=0.9)
    pairs = [(Q1, "A1"), (Q2, "A2"), (Q3, "A3")]
    for q, ans in pairs:
        a.insert(q, ans)
    keys = b.insert_batch([q for q, _ in pairs], [ans for _, ans in pairs])
    assert len(keys) == 3 and b.stats.adds == 3
    for q, ans in pairs:
        assert a.lookup(q).response == b.lookup(q).response == ans


def test_warm_start(emb):
    c = SemanticCache(emb, threshold=0.9)
    c.warm_start([(Q1, "A1"), (Q2, "A2")])
    assert c.lookup(Q1).hit and c.lookup(Q2).hit


def test_gptcache_like_same_decisions(emb):
    ours = SemanticCache(emb, threshold=0.8)
    baseline = GPTCacheLike(emb, threshold=0.8)
    pairs = [(Q1, "A1"), (Q2, "A2"), ("how do transformers work", "A3")]
    for q, a in pairs:
        v = emb.embed_one(q)
        ours.insert(q, a, vec=v)
        baseline.insert(q, a, vec=v)
    for probe in [Q1, "explain transformers", "recipe for pancakes"]:
        v = emb.embed_one(probe)
        r1, r2 = ours.lookup(probe, vec=v), baseline.lookup(probe, vec=v)
        assert r1.hit == r2.hit
        assert abs(r1.similarity - r2.similarity) < 1e-4


def test_pallas_backed_store_matches_jnp(emb):
    a = SemanticCache(emb, threshold=0.8, use_pallas=True, capacity=512)
    b = SemanticCache(emb, threshold=0.8, use_pallas=False, capacity=512)
    for i in range(20):
        q = f"question number {i} about subject {i % 5}"
        v = emb.embed_one(q)
        a.insert(q, f"A{i}", vec=v)
        b.insert(q, f"A{i}", vec=v)
    for probe in ["question number 3 about subject 3", "unrelated cooking query"]:
        v = emb.embed_one(probe)
        ra, rb = a.lookup(probe, vec=v), b.lookup(probe, vec=v)
        assert ra.hit == rb.hit
        assert abs(ra.similarity - rb.similarity) < 1e-4


def test_remove_entry(emb):
    c = SemanticCache(emb, threshold=0.9)
    key = c.insert(Q1, "A1")
    assert c.lookup(Q1).hit
    assert c.store.remove(key)
    assert not c.lookup(Q1).hit
