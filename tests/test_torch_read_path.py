"""The port's fused read (embed -> banked top-k -> decide -> touch) against
the reference package's fused read program, on a 3-level hierarchy (L1, L2,
one peer), with and without entry lifecycle (TTL + staleness).

Vectors and lifecycle stamps are dyadic (multiples of 1/4) under the dot
metric, so every score and sum is exact in float32 and the comparison is
bitwise: equal scores, equal winner/hit/generative masks, equal indices
wherever the score is finite, and equal bank counters after the read. The
reference runs its Pallas kernel in interpret mode (``use_pallas=True``)."""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import read_path as jrp
from repro.kernels.similarity_topk import ops as jops
from repro_torch.core import read_path as trp
from repro_torch.kernels.similarity_topk import ops as tops

torch.set_num_threads(1)

DIM = 16
CAPS = (16, 32, 24)
NOW = 8.0


def _dyadic(rng, n):
    return rng.integers(0, 5, size=(n, DIM)).astype(np.float32) / 4


def _hierarchy(P, rng_seed, **kw):
    rng = np.random.default_rng(rng_seed)
    emb = P.NgramHashEmbedder(DIM)
    levels = []
    for li, cap in enumerate(CAPS):
        c = P.GenerativeCache(
            emb, threshold=9.0, t_single=5.0, t_combined=16.0, capacity=cap,
            metric="dot", use_pallas=True, max_sources=4 if li != 1 else 3, **kw,
        )
        n = cap - 3
        c.insert_batch([f"L{li}q{i}" for i in range(n)], [f"L{li}a{i}" for i in range(n)],
                       vecs=_dyadic(rng, n))
        levels.append(c)
    h = P.HierarchicalCache(levels[0], levels[1], peers=[levels[2]])
    h.ensure_bank()
    return h


def _pair():
    return _hierarchy(J, 7), _hierarchy(T, 7, device="cpu")


def _queries(n=12):
    rng = np.random.default_rng(11)
    return [f"probe {i}" for i in range(n)], _dyadic(rng, n)


def _specs(P_rp, h):
    levels = [c for _, c in h._levels()]
    return [P_rp.level_spec(c, min(c.max_sources, c.store.capacity)) for c in levels]


def _set_lifecycle(h):
    bank = h._shared_bank
    rng = np.random.default_rng(5)
    created = rng.integers(0, 16, size=(bank.L, bank.cap)) / 4
    ttl = rng.integers(1, 64, size=(bank.L, bank.cap)) / 4
    expires = np.where(rng.random((bank.L, bank.cap)) < 0.7, created + ttl, np.inf)
    bank.set_lifecycle(created, expires)
    for lane, w in enumerate((0.25, 0.5, 1.0)):
        bank.set_staleness(lane, w)


def _assert_decisions_equal(dj, dt):
    np.testing.assert_array_equal(dj.winner, dt.winner)
    np.testing.assert_array_equal(dj.hit, dt.hit)
    np.testing.assert_array_equal(dj.generative, dt.generative)
    np.testing.assert_array_equal(dj.scores, dt.scores)
    finite = np.isfinite(dj.scores)
    np.testing.assert_array_equal(dj.idx[finite], dt.idx[finite])
    np.testing.assert_array_equal(dj.vecs, dt.vecs)
    assert dt.idx.dtype == np.int32 and dt.winner.dtype == np.int32


def _assert_counters_equal(hj, ht):
    for a, b in zip(hj._shared_bank.counters_host(), ht._shared_bank.counters_host()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lifecycle", [False, True])
def test_fused_read_matches_reference_bitwise(lifecycle, monkeypatch):
    hj, ht = _pair()
    if lifecycle:
        for h in (hj, ht):
            _set_lifecycle(h)
        monkeypatch.setattr(J.StoreBank, "rel_now", staticmethod(lambda: NOW))
        monkeypatch.setattr(T.StoreBank, "rel_now", staticmethod(lambda: NOW))
    texts, qv = _queries()
    L = len(CAPS)
    thr = np.full((len(texts), L), 9.0)
    thr[::3] = 7.5  # per-query thresholds differ
    dj = jrp.fused_read(hj._shared_bank, hj.l1.embedder, texts, thr, _specs(jrp, hj), vecs=qv)
    dt = trp.fused_read(ht._shared_bank, ht.l1.embedder, texts, thr, _specs(trp, ht), vecs=qv)
    _assert_decisions_equal(dj, dt)
    # the data exercises every class: misses, semantic and generative hits
    assert (dt.winner == L).any() and (dt.winner < L).any()
    assert dt.generative.any() and (dt.hit & ~dt.generative).any()
    _assert_counters_equal(hj, ht)
    assert ht._shared_bank.lifecycle_active() == lifecycle
    # a second read sees the touched counters and agrees again
    dj = jrp.fused_read(hj._shared_bank, hj.l1.embedder, texts[:5], thr[:5],
                        _specs(jrp, hj), vecs=qv[:5])
    dt = trp.fused_read(ht._shared_bank, ht.l1.embedder, texts[:5], thr[:5],
                        _specs(trp, ht), vecs=qv[:5])
    _assert_decisions_equal(dj, dt)
    _assert_counters_equal(hj, ht)


def test_lookup_batch_results_and_stats_match():
    """The hierarchy's whole lookup (fused read + host materialization +
    promotions and synthesized writebacks) gives the same results."""
    hj, ht = _pair()
    texts, qv = _queries()
    for _ in range(2):  # the second round reads what the first wrote back
        rj = hj.lookup_batch(texts, vecs=qv)
        rt = ht.lookup_batch(texts, vecs=qv)
        for a, b in zip(rj, rt):
            assert (a.hit, a.level, a.generative, a.response) == (
                b.hit, b.level, b.generative, b.response)
            assert a.similarity == b.similarity
            assert a.combined_similarity == b.combined_similarity
    for (_, cj), (_, ct) in zip(hj._levels(), ht._levels()):
        assert (cj.stats.lookups, cj.stats.hits, cj.stats.generative_hits, cj.stats.adds) == (
            ct.stats.lookups, ct.stats.hits, ct.stats.generative_hits, ct.stats.adds)
    _assert_counters_equal(hj, ht)


def test_one_read_is_one_dispatch_and_no_host_hop():
    _, ht = _pair()
    texts, qv = _queries(5)
    bank = ht._shared_bank
    tops.reset_dispatch_count()
    before = (bank.dispatches, bank.host_hops, bank.counter_scatters)
    thr = np.full((len(texts), len(CAPS)), 9.0)
    trp.fused_read(bank, ht.l1.embedder, texts, thr, _specs(trp, ht), vecs=qv)
    assert tops.dispatch_count() == 1  # the whole read: ONE kernel call
    assert bank.dispatches - before[0] == 1
    assert bank.host_hops - before[1] == 0
    assert bank.counter_scatters - before[2] == 0  # touches rode the read
    ht.lookup_batch(texts, vecs=qv)  # the same through the hierarchy
    assert tops.dispatch_count() == 2 and bank.dispatches - before[0] == 2
    assert bank.host_hops - before[1] == 0


def test_embed_in_program_with_carried_contriever():
    """Token ids in, decisions out: the smoke Contriever encoder runs inside
    the read on both sides (weights carried over), cosine lanes."""
    import jax

    from repro.configs import contriever as jcfg
    from repro.core import embeddings as jemb
    from repro_torch.configs import contriever as tcfg
    from repro_torch.core import embeddings as temb

    jenc = jemb.ContrieverEncoder(jcfg.smoke(), seed=1)
    tenc = temb.encoder_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jenc.params), tcfg.smoke(), device="cpu"
    )
    docs = [f"document number {i} about topic {i % 5}" for i in range(20)]
    probes = docs[:3] + ["document about topic 3", "nothing alike at all"]

    def build(P, enc, **kw):
        c = P.SemanticCache(enc, threshold=0.99, capacity=32, use_pallas=True, **kw)
        c.insert_batch(docs, [f"A{i}" for i in range(20)])
        return c

    cj, ct = build(J, jenc), build(T, tenc, device="cpu")
    spec_j = jrp.level_spec(cj, 1)
    spec_t = trp.level_spec(ct, 1)
    thr = np.full((len(probes), 1), 0.99)
    dj = jrp.fused_read(cj.store._bank, jenc, probes, thr, [spec_j])
    dt = trp.fused_read(ct.store._bank, tenc, probes, thr, [spec_t])
    np.testing.assert_allclose(dj.vecs, dt.vecs, atol=1e-5)
    np.testing.assert_allclose(dj.scores, dt.scores, atol=2e-5)
    np.testing.assert_array_equal(dj.winner, dt.winner)
    np.testing.assert_array_equal(dj.hit, dt.hit)
    assert dt.hit[:3, 0].all()  # exact repeats hit their own entry
    np.testing.assert_array_equal(dt.idx[:3, 0, 0], [0, 1, 2])
    assert jops.dispatch_count() > 0  # the reference went through its kernel
