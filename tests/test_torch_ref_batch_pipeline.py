"""The reference's ``tests/test_batch_pipeline.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

Batch parity: the batched pipeline (embed_batch / lookup_batch /
search_batch / sharded lookup / complete_batch / coalescer) must return
results identical to N sequential single-query calls on the same snapshot,
for both the jnp and use_pallas=True (interpret) search paths.
"""
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro_torch.configs.contriever import smoke as contriever_smoke
from repro_torch.core import (
    EnhancedClient,
    GenerativeCache,
    InMemoryVectorStore,
    MockLLM,
    NgramHashEmbedder,
    SemanticCache,
    ThresholdPolicy,
)
from repro_torch.core.adaptive import ModelCostInfo
from repro_torch.core.embeddings import ContrieverEncoder
from repro_torch.serving.coalescer import BatchCoalescer
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


QUERIES = [
    "What is an application-level denial of service attack?",
    "How do I defend against denial of service attacks?",
    "What is the best recipe for chocolate cake?",
    "Explain how transformers work",
    "what is an application level denial of service attack",
    "How does the attention mechanism work in transformers?",
]


def _fill(store_kwargs, n=40, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    store = InMemoryVectorStore(dim, **store_kwargs)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    for i, v in enumerate(vecs):
        store.add(v, f"q{i}", f"a{i}")
    return store, vecs


@pytest.mark.parametrize("use_pallas", [False, True])
def test_search_batch_matches_search(use_pallas):
    store, vecs = _fill({"capacity": 64, "use_pallas": use_pallas})
    rng = np.random.default_rng(1)
    probes = np.concatenate([vecs[:4], rng.normal(size=(4, 32)).astype(np.float32)])
    batch = store.search_batch(probes, k=4)
    for q, row in zip(probes, batch):
        seq = store.search(q, k=4)
        assert [e.key for _, e in row] == [e.key for _, e in seq]
        np.testing.assert_allclose(
            [s for s, _ in row], [s for s, _ in seq], atol=1e-6
        )


def _two_caches(factory):
    emb = NgramHashEmbedder()
    a, b = factory(emb), factory(emb)
    pairs = [(QUERIES[0], "A0"), (QUERIES[2], "A2"), (QUERIES[3], "A3")]
    for q, ans in pairs:
        v = emb.embed_one(q)
        a.insert(q, ans, vec=v)
        b.insert(q, ans, vec=v)
    return a, b


def _assert_result_parity(rb, rs):
    assert rb.hit == rs.hit
    assert rb.generative == rs.generative
    assert rb.response == rs.response
    assert rb.similarity == pytest.approx(rs.similarity, abs=1e-6)
    assert rb.combined_similarity == pytest.approx(rs.combined_similarity, abs=1e-6)
    assert rb.threshold_used == pytest.approx(rs.threshold_used, abs=1e-9)
    assert [e.key for _, e in rb.sources] == [e.key for _, e in rs.sources]


def test_semantic_lookup_batch_parity():
    batched, seq = _two_caches(lambda e: SemanticCache(e, threshold=0.7))
    for rb, q in zip(batched.lookup_batch(QUERIES), QUERIES):
        _assert_result_parity(rb, seq.lookup(q))
    assert batched.stats.lookups == len(QUERIES)
    assert batched.stats.hits == seq.stats.hits


@pytest.mark.parametrize("mode", ["primary", "secondary"])
def test_generative_lookup_batch_parity(mode):
    batched, seq = _two_caches(
        lambda e: GenerativeCache(e, threshold=0.85, t_single=0.4, t_combined=1.0,
                                  mode=mode, cache_synthesized=False)
    )
    for rb, q in zip(batched.lookup_batch(QUERIES), QUERIES):
        _assert_result_parity(rb, seq.lookup(q))


def test_lookup_batch_vectorized_thresholds_parity():
    policy = ThresholdPolicy(base=0.75)
    batched, seq = _two_caches(
        lambda e: SemanticCache(e, threshold=0.75, policy=policy)
    )
    contexts = [
        {"model_info": ModelCostInfo(60.0, 120.0, 20.0)},  # pricey -> lower t_s
        None,
        {"connectivity": 0.2},  # offline-ish -> lower t_s
        {"user_threshold_offset": 0.1},
        None,
        {"max_tokens": 64, "model_info": ModelCostInfo(0.5, 1.5, 3.0)},
    ]
    for rb, (q, c) in zip(batched.lookup_batch(QUERIES, contexts), zip(QUERIES, contexts)):
        _assert_result_parity(rb, seq.lookup(q, c))


def test_pallas_lookup_batch_parity():
    emb = NgramHashEmbedder()
    caches = [
        SemanticCache(emb, threshold=0.7, capacity=128, use_pallas=p)
        for p in (True, False)
    ]
    for q in QUERIES[:3]:
        v = emb.embed_one(q)
        for c in caches:
            c.insert(q, f"ans:{q[:10]}", vec=v)
    ra, rb_ = (c.lookup_batch(QUERIES) for c in caches)
    for x, y in zip(ra, rb_):
        assert x.hit == y.hit
        assert x.similarity == pytest.approx(y.similarity, abs=1e-4)


def test_sharded_search_batch_matches_single_and_inmemory():
    jax = pytest.importorskip("jax")
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(device="cpu", shape=(len(jax.devices()),), axes=("data",))
    dim, n = 16, 12
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    sharded = ShardedVectorStore(mesh, dim=dim, capacity=16, k=3)
    local = InMemoryVectorStore(dim, capacity=16)
    for i, v in enumerate(vecs):
        sharded.add(v, f"q{i}", f"a{i}")
        local.add(v, f"q{i}", f"a{i}")
    probes = vecs[:5]
    batch = sharded.search_batch(probes)
    for q, row in zip(probes, batch):
        single = sharded.search_batch(q[None])[0]
        assert [(p[0]) for _, p in row] == [(p[0]) for _, p in single]
        np.testing.assert_allclose([s for s, _ in row], [s for s, _ in single], atol=1e-6)
        ref = local.search(q, k=3)
        np.testing.assert_allclose(
            [s for s, _ in row], [s for s, _ in ref], atol=1e-5
        )
        assert [p[0] for _, p in row] == [e.query for _, e in ref]
    # thresholded lookup_batch: strict > on the best candidate, else None
    hits = sharded.lookup_batch(probes, 0.99)
    assert [h[1][0] for h in hits] == [f"q{i}" for i in range(5)]  # self-hits
    assert sharded.lookup_batch(probes, 1.1) == [None] * 5
    per_query_thr = [0.99, 1.1, 0.99, 1.1, 0.99]
    mixed = sharded.lookup_batch(probes, per_query_thr)
    assert [h is None for h in mixed] == [False, True, False, True, False]


def test_sharded_add_batch_matches_sequential():
    jax = pytest.importorskip("jax")
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(device="cpu", shape=(len(jax.devices()),), axes=("data",))
    dim, n = 16, 12
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    qs, rs = [f"q{i}" for i in range(n)], [f"a{i}" for i in range(n)]
    seq = ShardedVectorStore(mesh, dim=dim, capacity=8, k=3)  # wraps round-robin
    bat = ShardedVectorStore(mesh, dim=dim, capacity=8, k=3)
    idx_seq = [seq.add(v, q, r) for v, q, r in zip(vecs, qs, rs)]
    idx_bat = bat.add_batch(vecs, qs, rs)
    assert idx_seq == idx_bat
    assert seq.payloads == bat.payloads
    assert seq.size == bat.size and seq._rr == bat._rr
    np.testing.assert_allclose(np.asarray(seq._db), np.asarray(bat._db), atol=0)
    assert np.array_equal(np.asarray(seq._valid), np.asarray(bat._valid))
    probes = vecs[-3:]
    for row_s, row_b in zip(seq.search_batch(probes), bat.search_batch(probes)):
        assert [(s, p) for s, p in row_s] == [(s, p) for s, p in row_b]
    # odd-sized batches ride the power-of-two bucket padding unchanged
    extra = rng.normal(size=(3, dim)).astype(np.float32)
    assert bat.add_batch(extra, ["x0", "x1", "x2"], ["y0", "y1", "y2"]) == \
        [seq.add(v, f"x{i}", f"y{i}") for i, v in enumerate(extra)]
    assert seq.payloads == bat.payloads
    np.testing.assert_allclose(np.asarray(seq._db), np.asarray(bat._db), atol=0)


def test_embed_batch_matches_per_text_embedding():
    enc = ContrieverEncoder(contriever_smoke())
    texts = QUERIES[:3]  # batch of 3 pads to a bucket of 4
    batched = enc.embed_batch(texts)
    singles = np.stack([enc.embed_one(t) for t in texts])
    assert batched.shape == singles.shape
    np.testing.assert_allclose(batched, singles, atol=1e-5)


def test_embed_batch_empty():
    emb = NgramHashEmbedder()
    out = emb.embed_batch([])
    assert out.shape == (0, emb.dim)


def test_complete_batch_partitions_hits_and_misses():
    emb = NgramHashEmbedder()
    cache = GenerativeCache(emb, threshold=0.85, t_single=0.45, t_combined=1.0)
    client = EnhancedClient(cache=cache)
    backend = MockLLM("m1")
    client.register_backend(backend)
    prompts = QUERIES[:4]
    r1 = client.complete_batch(prompts)
    assert [r.from_cache for r in r1] == [False] * 4
    assert backend.calls == 4
    r2 = client.complete_batch(prompts)
    assert [r.from_cache for r in r2] == [True] * 4
    assert backend.calls == 4  # hits never reach the backend
    assert [r.text for r in r2] == [r.text for r in r1]
    assert client.stats.requests == 8 and client.stats.cache_hits == 4


def test_complete_batch_matches_sequential_query_decisions():
    def build():
        emb = NgramHashEmbedder()
        c = EnhancedClient(cache=GenerativeCache(
            emb, threshold=0.85, t_single=0.45, t_combined=1.0))
        c.register_backend(MockLLM("m1"))
        return c

    a, b = build(), build()
    warm = QUERIES[:3]
    a.complete_batch(warm)
    for q in warm:
        b.query(q)
    probes = [QUERIES[0], QUERIES[4], "completely unrelated gardening question"]
    ra = a.complete_batch(probes)
    rb = [b.query(q) for q in probes]
    assert [r.from_cache for r in ra] == [r.from_cache for r in rb]
    assert [r.text for r in ra] == [r.text for r in rb]


def test_complete_batch_failover():
    from repro_torch.resilience import RetryPolicy

    emb = NgramHashEmbedder()
    client = EnhancedClient(
        cache=SemanticCache(emb, threshold=0.9),
        retry_policy=RetryPolicy(max_attempts=2, base_backoff_s=0.0, jitter=0.0),
    )
    client.register_backend(MockLLM("dead", fail=True))
    client.register_backend(MockLLM("alive"))
    rs = client.complete_batch(["hello", "world"])
    assert [r.model for r in rs] == ["alive", "alive"]
    # errors are counted per failover ATTEMPT on the batch, never per prompt:
    # 2 attempts against the dead backend, regardless of batch width
    assert client.stats.llm_errors == 2
    assert client.stats.retries == 1


def test_coalescer_batches_concurrent_requests():
    calls = []

    def handler(items):
        calls.append(len(items))
        return [x * 2 for x in items]

    with BatchCoalescer(handler, max_batch=8, max_wait_ms=50.0) as co:
        with ThreadPoolExecutor(max_workers=16) as pool:
            outs = list(pool.map(co, range(32)))
    assert outs == [x * 2 for x in range(32)]
    assert co.stats.batches == len(calls)
    assert co.stats.batched_items == 32
    assert max(calls) > 1  # concurrency actually coalesced


def test_coalescer_propagates_handler_errors():
    def handler(items):
        raise ValueError("boom")

    with BatchCoalescer(handler, max_batch=4, max_wait_ms=1.0) as co:
        fut = co.submit("x")
        with pytest.raises(ValueError, match="boom"):
            fut.result(timeout=5)


def test_coalescer_rejects_after_close():
    co = BatchCoalescer(lambda items: items, max_batch=2)
    co.close()
    with pytest.raises(RuntimeError):
        co.submit(1)


def test_coalescer_single_request_not_stalled():
    with BatchCoalescer(lambda items: items, max_batch=64, max_wait_ms=10.0) as co:
        t0 = time.perf_counter()
        assert co("solo") == "solo"
        assert time.perf_counter() - t0 < 2.0  # released at max_wait, not never
