"""The reference's ``tests/test_hierarchy_batch.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

Batched hierarchy (§4): lookup_batch decision parity with the sequential
walk, batched promotion/writeback placement, the insert privacy matrix
(promote x inclusive x privacy hints over L1 + L2 + peers), the cross-level
generative pool ordering/cap fixes, and the client's batched hierarchy path.
"""
import numpy as np
import pytest

from repro_torch.core import (
    EnhancedClient,
    GenerativeCache,
    HierarchicalCache,
    MockLLM,
    NgramHashEmbedder,
)
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


Q1 = "What is an application-level denial of service attack?"
Q2 = "What are the most effective techniques for defending against denial-of-service attacks?"
Q3 = ("What is an application-level denial of service attack, and what are the "
      "most effective techniques for defending against such attacks?")
QA = "How does the attention mechanism work in transformers?"
QB = "What is the best recipe for chocolate cake?"


@pytest.fixture
def emb():
    return NgramHashEmbedder()


def _gc(emb, **kw):
    kw.setdefault("threshold", 0.85)
    kw.setdefault("t_single", 0.45)
    kw.setdefault("t_combined", 1.0)
    return GenerativeCache(emb, **kw)


def _fresh_hier(emb, **kw) -> HierarchicalCache:
    """L1 holds QA, L2 holds Q1, peer0 holds Q2, peer1 holds QB."""
    l1, l2, p0, p1 = (_gc(emb) for _ in range(4))
    l1.insert(QA, "ATT")
    l2.insert(Q1, "A1")
    p0.insert(Q2, "A2")
    p1.insert(QB, "CAKE")
    return HierarchicalCache(l1, l2, peers=[p0, p1], **kw)


PROBES = [
    QA,                                   # L1 semantic hit
    Q1,                                   # L2 hit (promotes)
    Q2,                                   # peer hit (promotes)
    Q3,                                   # cross-level generative (Q1 + Q2)
    "completely unrelated gardening question",  # miss everywhere
]


def test_lookup_batch_parity_with_sequential_snapshot(emb):
    """Batched decisions must match B sequential lookups, each against a
    fresh snapshot of the same hierarchy (levels, responses, scores)."""
    batch = _fresh_hier(emb).lookup_batch(PROBES)
    for q, rb in zip(PROBES, batch):
        rs = _fresh_hier(emb).lookup(q)
        assert rb.hit == rs.hit
        assert rb.level == rs.level
        assert rb.generative == rs.generative
        assert rb.response == rs.response
        assert rb.similarity == pytest.approx(rs.similarity, abs=1e-6)
        assert rb.combined_similarity == pytest.approx(rs.combined_similarity, abs=1e-6)
        assert rb.threshold_used == pytest.approx(rs.threshold_used, abs=1e-9)
        assert [(e.query, e.response) for _, e in rb.sources] == \
               [(e.query, e.response) for _, e in rs.sources]
        np.testing.assert_allclose([s for s, _ in rb.sources],
                                   [s for s, _ in rs.sources], atol=1e-6)
    levels = [r.level for r in batch]
    assert levels[0].startswith("L1") and levels[1].startswith("L2:")
    assert "peer" in levels[2] and levels[3] == "multi-level:generative"
    assert not batch[4].hit


def test_lookup_batch_promotes_lower_level_hits(emb):
    h = _fresh_hier(emb)
    first = h.lookup_batch(PROBES)
    assert first[1].level.startswith("L2:")
    # L2/peer winners (and the synthesized answer) landed in L1 in one scatter
    again = h.lookup_batch(PROBES[:4])
    assert all(r.level.startswith("L1") for r in again)


def test_lookup_batch_no_promotion_when_disabled(emb):
    h = _fresh_hier(emb, promote=False)
    h.lookup_batch([Q1, Q2])
    assert len(h.l1.store) == 1  # only the seeded QA entry
    assert h.lookup_batch([Q1])[0].level.startswith("L2:")


def test_lookup_batch_does_not_write_levels_below_the_winner(emb):
    """Sequentially, levels below a hit are never probed — a lower level must
    not accrue synthesized entries from queries an upper level served."""
    l1, l2 = _gc(emb), _gc(emb)
    l1.insert(Q3, "DIRECT")
    l2.insert(Q1, "A1")
    l2.insert(Q2, "A2")
    h = HierarchicalCache(l1, l2)
    r = h.lookup_batch([Q3])[0]
    assert r.hit and r.level == "L1:semantic"
    assert len(l2.store) == 2  # no synthesized writeback into the shared level

    # but when L2 wins with a synthesized answer, it does cache it — and
    # in-batch duplicates synthesize (and write back) exactly once
    h2 = HierarchicalCache(_gc(emb), l2_ := _gc(emb))
    l2_.insert(Q1, "A1")
    l2_.insert(Q2, "A2")
    r2, r2dup = h2.lookup_batch([Q3, Q3])
    assert r2.hit and r2.generative and r2.level == "L2:generative"
    assert r2dup.response == r2.response
    assert len(l2_.store) == 3  # ONE synthesized answer cached in the winning level
    assert len(h2.l1.store) == 1  # and promoted into L1 once


def test_lookup_batch_dedupes_promotions_of_repeated_queries(emb):
    """A coalesced batch of identical queries must promote once, like the
    sequential walk — not flush L1 with clones of the same entry."""
    h = _fresh_hier(emb)
    rs = h.lookup_batch([Q1] * 8)
    assert all(r.hit and r.level.startswith("L2:") for r in rs)
    assert len(h.l1.store) == 2  # seeded QA + ONE promoted copy of Q1


def test_lookup_batch_empty_and_stats(emb):
    h = _fresh_hier(emb)
    assert h.lookup_batch([]) == []
    h.lookup_batch(PROBES)
    # L1 was looked up for every query; L2 only for those L1 missed
    assert h.l1.stats.lookups == len(PROBES)
    assert h.l2.stats.lookups == len(PROBES) - 1  # QA stopped at L1
    assert h.l2.stats.hits == 1  # Q1 only; hits below winning levels retracted


@pytest.mark.parametrize("promote", [True, False])
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("cache_l1,cache_l2", [
    (True, True), (True, False), (False, True), (False, False),
])
def test_insert_privacy_matrix(emb, promote, inclusive, cache_l1, cache_l2):
    """Privacy hints always win — inclusivity must never copy an entry into a
    level the caller excluded (the §4 leak), and peers are never written."""
    l1, l2, peer = _gc(emb), _gc(emb), _gc(emb)
    h = HierarchicalCache(l1, l2, peers=[peer], inclusive=inclusive, promote=promote)
    h.insert("personal query one", "R1", cache_l1=cache_l1, cache_l2=cache_l2)
    assert len(l1.store) == (1 if cache_l1 else 0)
    assert len(l2.store) == (1 if cache_l2 else 0)
    assert len(peer.store) == 0
    h.insert_batch(["personal query two", "personal query three"], ["R2", "R3"],
                   cache_l1=cache_l1, cache_l2=cache_l2)
    assert len(l1.store) == (3 if cache_l1 else 0)
    assert len(l2.store) == (3 if cache_l2 else 0)
    assert len(peer.store) == 0


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("inclusive", [False, True])
def test_inclusive_mirrors_peer_winners_into_l2(emb, inclusive, batched):
    """inclusive=True: a peer hit is promoted into L1 AND copied into our L2
    (it came from a shared level, so nothing private is exposed); L2 winners
    are never duplicated back into L2."""
    l1, l2, peer = _gc(emb), _gc(emb), _gc(emb)
    h = HierarchicalCache(l1, l2, peers=[peer], inclusive=inclusive)
    peer.insert(Q1, "A1")
    l2.insert(QB, "CAKE")
    if batched:
        rs = h.lookup_batch([Q1, QB])
    else:
        rs = [h.lookup(Q1), h.lookup(QB)]
    assert "peer" in rs[0].level and rs[1].level.startswith("L2:")
    assert len(l1.store) == 2  # both winners promoted
    assert len(l2.store) == (2 if inclusive else 1)  # peer winner mirrored iff inclusive


def _vec_with_cos(rng, probe, cos, dim):
    r = rng.normal(size=dim).astype(np.float32)
    r -= (r @ probe) * probe
    r /= np.linalg.norm(r)
    return (cos * probe + np.sqrt(1.0 - cos * cos) * r).astype(np.float32)


def test_cross_level_pool_reports_best_score_first(emb):
    """The pooled candidate set is sorted best-first: the reported similarity
    is the strongest match, not whichever level was scanned first."""
    dim = emb.dim
    rng = np.random.default_rng(0)
    probe = rng.normal(size=dim).astype(np.float32)
    probe /= np.linalg.norm(probe)
    weak = _vec_with_cos(rng, probe, 0.5, dim)
    strong = _vec_with_cos(rng, probe, 0.7, dim)

    def build():
        l1, l2 = _gc(emb, t_combined=1.1), _gc(emb, t_combined=1.1)
        l1.insert("weak entry", "WEAK", vec=weak)
        l2.insert("strong entry", "STRONG", vec=strong)
        return HierarchicalCache(l1, l2)

    for r in (build().lookup("the probe", vec=probe),
              build().lookup_batch(["the probe"], vecs=probe[None])[0]):
        assert r.hit and r.generative
        assert r.similarity == pytest.approx(0.7, abs=1e-3)
        scores = [s for s, _ in r.sources]
        assert scores == sorted(scores, reverse=True)


def test_cross_level_pool_capped_at_l1_max_sources(emb):
    """N levels x k weak matches must not clear t_combined when no capped
    pool would: the pool is limited to L1's max_sources best candidates."""
    dim = emb.dim
    rng = np.random.default_rng(1)
    probe = rng.normal(size=dim).astype(np.float32)
    probe /= np.linalg.norm(probe)
    l1 = _gc(emb, t_combined=1.2, max_sources=2)
    l2, p0, p1 = (_gc(emb, t_combined=1.2) for _ in range(3))
    for i, cache in enumerate([l1, l2, p0, p1]):
        cache.insert(f"weak {i}", f"W{i}", vec=_vec_with_cos(rng, probe, 0.55, dim))
    h = HierarchicalCache(l1, l2, peers=[p0, p1])
    # uncapped: 4 x 0.55 = 2.2 > 1.2 would be a spurious hit; capped: 1.1 < 1.2
    assert not h.lookup("the probe", vec=probe).hit
    assert not h.lookup_batch(["the probe"], vecs=probe[None])[0].hit


class _CountingLLM(MockLLM):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.batch_calls = 0

    def generate_batch(self, prompts, max_tokens=256, temperature=0.0):
        self.batch_calls += 1
        return super().generate_batch(prompts, max_tokens, temperature)


def test_complete_batch_hierarchy_one_dispatch_and_privacy(emb):
    h = _fresh_hier(emb)
    client = EnhancedClient(hierarchy=h)
    backend = _CountingLLM("m1")
    client.register_backend(backend)
    novel = ["a brand new question about databases", "another novel question about compilers"]
    out = client.complete_batch([Q1] + novel, cache_l2=False)
    assert [r.from_cache for r in out] == [True, False, False]
    assert out[0].cache_result.level.startswith("L2:")
    assert backend.batch_calls == 1  # whole miss set in ONE batched dispatch
    assert len(h.l2.store) == 1  # privacy hint kept misses out of the shared level
    # promotion of Q1 + the two miss backfills all landed in L1
    assert len(h.l1.store) == 4
    out2 = client.complete_batch([Q1] + novel, cache_l2=False)
    assert all(r.from_cache for r in out2)
    assert backend.batch_calls == 1  # hits never reach the backend


def test_complete_batch_hierarchy_backfills_l2_by_default(emb):
    h = _fresh_hier(emb)
    client = EnhancedClient(hierarchy=h)
    client.register_backend(MockLLM("m1"))
    client.complete_batch(["a brand new question about databases"])
    assert len(h.l2.store) == 2  # seeded Q1 + the backfilled miss


def test_complete_batch_hierarchy_matches_sequential_query(emb):
    def build():
        c = EnhancedClient(hierarchy=_fresh_hier(NgramHashEmbedder()))
        c.register_backend(MockLLM("m1"))
        return c

    a, b = build(), build()
    ra = a.complete_batch(PROBES)
    rb = [b.query(q) for q in PROBES]
    assert [r.from_cache for r in ra] == [r.from_cache for r in rb]
    assert [r.text for r in ra] == [r.text for r in rb]
    assert a.stats.cache_hits == b.stats.cache_hits
    assert a.stats.llm_calls == b.stats.llm_calls


def test_batched_lookup_bumps_bookkeeping_only_on_probed_levels(emb):
    """Eviction hygiene: the batched path searches every level up front, but
    LRU/LFU counters must only move on levels the sequential walk would have
    probed — L1 serving a query leaves L2's recency/frequency untouched."""
    l1, l2 = _gc(emb), _gc(emb)
    l1.insert(Q1, "A1-l1")
    l2.insert(Q1, "A1-l2")
    h = HierarchicalCache(l1, l2)
    l2_counts = l2.store._access_count.copy()
    l2_recency = l2.store._last_access.copy()
    l1_counts = l1.store._access_count.copy()

    rs = h.lookup_batch([Q1])
    assert rs[0].hit and rs[0].level.startswith("L1")
    # L1 was probed: its counters moved; L2 was only searched speculatively
    assert np.any(l1.store._access_count != l1_counts)
    assert np.array_equal(l2.store._access_count, l2_counts)
    assert np.array_equal(l2.store._last_access, l2_recency)


def test_batched_lookup_bumps_all_levels_down_to_the_winner(emb):
    """A query L2 serves was preceded by an L1 probe: both levels bump."""
    l1, l2 = _gc(emb), _gc(emb)
    l1.insert(QB, "CAKE")  # unrelated: L1 misses Q1
    l2.insert(Q1, "A1-l2")
    h = HierarchicalCache(l1, l2, promote=False)
    l1_counts = l1.store._access_count.copy()
    l2_counts = l2.store._access_count.copy()

    rs = h.lookup_batch([Q1])
    assert rs[0].hit and rs[0].level.startswith("L2")
    assert np.any(l2.store._access_count != l2_counts)
    # L1's candidates (if any cleared the search) may bump; the L2 winner must
    assert l1.store._access_count.sum() >= l1_counts.sum()


def test_batched_lookup_bookkeeping_matches_sequential_walk(emb):
    """Same queries, same pre-state: the batched walk leaves each level's
    access counters exactly where B sequential lookups would. (Primary mode:
    a secondary-mode sequential miss probes twice — k=1 then the generative
    search — while the batched path reuses one candidate set, so exact bump
    parity only holds where the sequential walk searches once per level.)"""
    def build():
        l1, l2 = (_gc(emb, mode="primary", t_combined=0.9) for _ in range(2))
        l1.insert(QA, "ATT")
        l2.insert(Q1, "A1")
        return HierarchicalCache(l1, l2, generative_across_levels=False)

    queries = [QA, Q1]  # QA: L1 hit; Q1: L1 miss -> L2 hit
    seq = build()
    for q in queries:
        seq.lookup(q)
    bat = build()
    bat.lookup_batch(queries)
    np.testing.assert_array_equal(
        seq.l1.store._access_count, bat.l1.store._access_count
    )
    np.testing.assert_array_equal(
        seq.l2.store._access_count, bat.l2.store._access_count
    )
