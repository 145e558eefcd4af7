"""The reference's ``tests/test_tiers.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

Entry lifecycle + capacity tiers: TTL/expiry masks beat thresholds on
every read path (host, fused, sharded), eviction demotes into the host-RAM
tier and tier-1 hits promote back byte-identical, snapshots warm-start new
deployments, clear(older_than) prunes all three tiers, freed slots carry no
stale metadata, and the int32 insertion clock rebases before overflow.
"""
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro_torch.core import NgramHashEmbedder, SemanticCache  # noqa: E402
from repro_torch.core.store_bank import _TICK_COMPACT_AT  # noqa: E402
from repro_torch.core.tiers import HostRamTier, SnapshotTier, TierEntry  # noqa: E402
from repro_torch.core.vector_store import InMemoryVectorStore  # noqa: E402
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


DIM = 16


def unit(i: int, dim: int = DIM) -> np.ndarray:
    v = np.zeros(dim, np.float32)
    v[i % dim] = 1.0
    return v


def rand_units(n: int, dim: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, dim)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# -- TTL / expiry on the read paths -------------------------------------------


def test_expired_entry_never_served_host_path():
    s = InMemoryVectorStore(DIM, capacity=4)
    s.add(unit(0), "qa", "ra", ttl_s=0.05)
    kb = s.add(unit(1), "qb", "rb")
    time.sleep(0.1)
    got = s.search(unit(0), k=2)
    # the exact match is expired: it may not appear at ANY rank
    assert [e.key for _, e in got] == [kb]
    # entry object still present until pruned, but marked expired
    assert s._entries[s._key_to_slot[0]].expired()


def test_expiry_mask_beats_threshold_fused_decide():
    """Fused read program: an expired row cannot win even when its raw
    similarity clears the threshold — and the hot path stays ONE dispatch
    with ZERO host hops."""
    emb = NgramHashEmbedder()
    cache = SemanticCache(emb, threshold=0.5, capacity=8)
    # warm-up: compile the lifecycle program + scatter jits OUTSIDE the TTL
    # window (first-call compilation costs far more than a short TTL)
    cache.insert("warmup entry", "warm", ttl_s=3600.0)
    cache.lookup_batch(["warmup entry"])
    cache.insert("the quick brown fox", "stale answer", ttl_s=0.6)
    cache.insert("completely different topic entirely", "live answer")
    r = cache.lookup_batch(["the quick brown fox"])[0]
    assert r.hit and r.response == "stale answer"  # alive: raw score wins
    time.sleep(0.8)
    bank = cache.store._bank
    d0, h0 = bank.dispatches, bank.host_hops
    r = cache.lookup_batch(["the quick brown fox"])[0]
    assert not r.hit  # raw cosine is 1.0 > threshold, but the row is dead
    assert bank.dispatches == d0 + 1  # still one fused dispatch per batch
    assert bank.host_hops == h0  # and still zero host hops on the hot path


def test_staleness_penalty_raises_effective_bar():
    """An aging entry loses staleness_weight * clip(age/ttl, 0, 1): fresh it
    hits, near end-of-life the same raw score no longer clears t_s."""
    emb = NgramHashEmbedder()
    store = InMemoryVectorStore(emb.dim, capacity=8, staleness_weight=0.5)
    cache = SemanticCache(emb, threshold=0.8, store=store)
    cache.insert("warmup entry", "warm")  # compile the lifecycle program
    cache.lookup_batch(["warmup entry"])
    cache.insert("how do rockets work", "rocket answer", ttl_s=2.0)
    r = cache.lookup_batch(["how do rockets work"])[0]
    assert r.hit  # age ~0: effective score ~= raw ~= 1.0
    time.sleep(1.0)
    r = cache.lookup_batch(["how do rockets work"])[0]
    # age/ttl ~= 0.5 -> effective ~= 1.0 - 0.25 = 0.75 < 0.8
    assert not r.hit
    # host search path applies the same penalty
    sc = store.search_batch(emb.embed_one("how do rockets work")[None], k=1)[0]
    assert sc and sc[0][0] < 0.8


def test_expired_slot_reclaimed_before_live_eviction():
    s = InMemoryVectorStore(DIM, capacity=3, eviction="lru")
    ka = s.add(unit(0), "qa", "ra", ttl_s=0.05)
    kb = s.add(unit(1), "qb", "rb")
    kc = s.add(unit(2), "qc", "rc")
    time.sleep(0.1)
    kd = s.add(unit(3), "qd", "rd")  # must reclaim the dead slot, not evict
    live = {e.key for e in s._entries if e is not None}
    assert live == {kb, kc, kd}


# -- demotion / promotion ------------------------------------------------------


def test_demote_promote_roundtrip_preserves_keys_vectors_counters():
    tier = HostRamTier(DIM, capacity=16)
    s = InMemoryVectorStore(DIM, capacity=2, eviction="lru", tier1=tier)
    vecs = rand_units(4, DIM)
    ka = s.add(vecs[0], "qa", "ra")
    s.add(vecs[1], "qb", "rb")
    for _ in range(3):
        s.search(vecs[0], k=1)  # access_count(a) = 3
    count_a = int(s._access_count[s._key_to_slot[ka]])
    assert count_a == 3
    s.add(vecs[2], "qc", "rc")
    s.add(vecs[3], "qd", "rd")  # a and b demoted
    assert ka not in s._key_to_slot and len(tier) == 2
    sc, slots = tier.search(vecs[0], k=1)
    assert sc[0, 0] == pytest.approx(1.0, abs=1e-5)
    e, vec = tier.pop(int(slots[0, 0]))
    assert (e.key, e.query, e.response, e.access_count) == (ka, "qa", "ra", 3)
    np.testing.assert_allclose(vec, vecs[0], atol=1e-6)
    s._restore_batch(vec[None], [e])
    # identity fully restored: key, vector, response, AND the access count
    idx = s._key_to_slot[ka]
    assert s._entries[idx].response == "ra"
    assert int(s._access_count[idx]) == 3
    score, entry = s.search(vecs[0], k=1)[0]
    assert score == pytest.approx(1.0, abs=1e-5) and entry.key == ka


def test_tier1_hit_promotes_through_cache_lookup():
    emb = NgramHashEmbedder()
    tier = HostRamTier(emb.dim, capacity=32)
    store = InMemoryVectorStore(emb.dim, capacity=2, tier1=tier)
    cache = SemanticCache(emb, threshold=0.85, store=store)
    cache.insert("oldest question", "oldest answer")
    cache.insert("middle question", "middle answer")
    cache.insert("newest question", "newest answer")  # demotes oldest
    assert len(tier) == 1
    r = cache.lookup("oldest question")
    assert r.hit and r.level == "tier1"
    assert r.response == "oldest answer"
    assert cache.stats.tier1_hits == 1
    # promoted out of the ring; the evicted tier-0 victim demoted into it
    assert {e.response for e, _ in tier.snapshot_entries()} != {"oldest answer"}
    r2 = cache.lookup("oldest question")  # now a plain tier-0 hit
    assert r2.hit and r2.level == "semantic"


def test_working_set_4x_device_capacity_stays_servable():
    """The acceptance bar: a working set 4x the device bank keeps serving —
    evicted entries answer from tier 1, promoted hits are byte-identical to
    their pre-demotion responses, expired entries never appear."""
    emb = NgramHashEmbedder()
    cap = 16
    tier = HostRamTier(emb.dim, capacity=8 * cap)
    store = InMemoryVectorStore(emb.dim, capacity=cap, tier1=tier)
    cache = SemanticCache(emb, threshold=0.85, store=store)
    n = 4 * cap
    queries = [f"question number {i} about subject {i * 7 + 1}" for i in range(n)]
    responses = [f"answer payload {i}" for i in range(n)]
    cache.insert_batch(queries, responses)
    assert len(store) == cap and len(tier) == n - cap
    rng = np.random.default_rng(1)
    order = rng.permutation(n)
    served = {}
    for start in range(0, n, 16):
        chunk = [int(i) for i in order[start:start + 16]]
        rs = cache.lookup_batch([queries[i] for i in chunk])
        for i, r in zip(chunk, rs):
            assert r.hit, f"query {i} unservable with 4x working set"
            served[i] = r.response
    assert served == {i: responses[i] for i in range(n)}  # byte-identical
    assert cache.stats.tier1_hits > 0  # some answers really came from tier 1


# -- tier 2: snapshot export / import ------------------------------------------


def test_snapshot_export_import_warm_start_parity(tmp_path):
    tier = HostRamTier(DIM, capacity=16)
    s = InMemoryVectorStore(DIM, capacity=2, tier1=tier)
    vecs = rand_units(4, DIM, seed=3)
    for i in range(4):  # 2 land in tier 0, 2 demote to tier 1
        s.add(vecs[i], f"q{i}", f"r{i}")
    s.search(vecs[3], k=1)  # access_count(3) = 1
    snap = SnapshotTier(str(tmp_path / "snap"))
    assert snap.export_from(s) == 4
    assert snap.count() == 4
    fresh = InMemoryVectorStore(DIM, capacity=2, tier1=HostRamTier(DIM, 16))
    assert snap.import_into(fresh) == 4
    # newest entries stayed in tier 0; access counts rode along
    t0_responses = {e.response for e in fresh._entries if e is not None}
    assert t0_responses == {"r2", "r3"}
    idx3 = next(i for i, e in enumerate(fresh._entries)
                if e is not None and e.response == "r3")
    assert int(fresh._access_count[idx3]) == 1
    # every entry is servable in the warm-started store, same responses
    for i in range(4):
        sc, slots = fresh.tier1.search(vecs[i], k=1)
        if float(sc[0, 0]) > 0.99:
            e = fresh.tier1.get(int(slots[0, 0]))
            assert e.response == f"r{i}"
        else:
            score, entry = fresh.search(vecs[i], k=1)[0]
            assert score == pytest.approx(1.0, abs=1e-5)
            assert entry.response == f"r{i}"


def test_snapshot_skips_expired_entries(tmp_path):
    s = InMemoryVectorStore(DIM, capacity=4)
    s.add(unit(0), "dead", "dead answer", ttl_s=0.05)
    s.add(unit(1), "live", "live answer")
    time.sleep(0.1)
    snap = SnapshotTier(str(tmp_path / "snap"))
    assert snap.export_from(s) == 1
    fresh = InMemoryVectorStore(DIM, capacity=4)
    assert snap.import_into(fresh) == 1
    assert [e.response for e in fresh._entries if e is not None] == ["live answer"]


# -- clear(older_than) across all three tiers ----------------------------------


def test_clear_older_than_prunes_all_three_tiers(tmp_path):
    tier = HostRamTier(DIM, capacity=16)
    s = InMemoryVectorStore(DIM, capacity=2, tier1=tier)
    vecs = rand_units(5, DIM, seed=5)
    for i in range(3):  # q0 demotes to tier 1
        s.add(vecs[i], f"old{i}", f"r{i}")
    # backdate the old generation (created stamps are host-side truth)
    cutoff_age = 100.0
    for e in s._entries:
        if e is not None:
            e.created_at -= 200.0
    for te, _ in list(tier.snapshot_entries()):
        te.created_at -= 200.0
    snap = SnapshotTier(str(tmp_path / "snap"))
    snap.export_from(s)
    s.add(vecs[3], "new3", "r3")  # old1 demotes but keeps its backdate? no:
    # (old1 was re-stamped above while in tier 0, so its demoted copy is old)
    s.add(vecs[4], "new4", "r4")
    dropped = s.clear(older_than=cutoff_age)
    live_t0 = {e.query for e in s._entries if e is not None}
    assert live_t0 == {"new3", "new4"}
    assert dropped >= 1
    # tier 1 pruned through the cascade: only fresh demotions may remain
    for te, _ in tier.snapshot_entries():
        assert time.time() - te.created_at <= cutoff_age
    # tier 2 clears its files
    assert snap.count() == 3
    assert snap.clear() == 3
    assert snap.count() == 0
    assert not os.path.exists(os.path.join(snap.path, "snapshot.npz"))


def test_clear_all_and_expired_always_qualify():
    s = InMemoryVectorStore(DIM, capacity=4)
    s.add(unit(0), "a", "ra", ttl_s=0.05)
    s.add(unit(1), "b", "rb")
    time.sleep(0.1)
    # huge cutoff: nothing is "old", but the expired entry still goes
    assert s.clear(older_than=1e9) == 1
    assert len(s) == 1
    assert s.clear() == 1  # no cutoff: everything
    assert len(s) == 0


# -- persistence with lifecycle state ------------------------------------------


def test_save_load_mixed_live_expired(tmp_path):
    s = InMemoryVectorStore(DIM, capacity=4, default_ttl_s=None)
    s.add(unit(0), "dead", "dead answer", ttl_s=0.05)
    kb = s.add(unit(1), "live", "live answer", ttl_s=3600.0)
    s.add(unit(2), "immortal", "forever answer")
    time.sleep(0.1)
    s.save(str(tmp_path / "store"))
    s2 = InMemoryVectorStore.load(str(tmp_path / "store"))
    assert len(s2) == 3  # all rows reload...
    got = s2.search(unit(0), k=3)
    assert all(e.query != "dead" for _, e in got)  # ...but dead stays dead
    score, e = s2.search(unit(1), k=1)[0]
    assert e.key == kb and e.response == "live answer"
    assert np.isfinite(e.expires_at) and e.expires_at > time.time()
    _, e = s2.search(unit(2), k=1)[0]
    assert e.expires_at == float("inf")
    assert s2.clear(older_than=1e9) == 1  # the expired row prunes on demand


def test_save_load_preserves_ttl_knobs(tmp_path):
    s = InMemoryVectorStore(DIM, capacity=4, default_ttl_s=60.0, staleness_weight=0.25)
    s.add(unit(0), "q", "r")
    s.save(str(tmp_path / "store"))
    s2 = InMemoryVectorStore.load(str(tmp_path / "store"))
    assert s2.default_ttl_s == 60.0
    assert s2.staleness_weight == 0.25
    assert s2._bank.lifecycle_active()


# -- freed-slot metadata hygiene (satellite bugfix) ----------------------------


def test_freed_slot_reinsert_matches_fresh_insert_inmemory():
    """remove() + slot-reusing insert must leave NO stale recency/frequency/
    TTL metadata: the recycled slot's counters match a fresh-slot insert."""
    s = InMemoryVectorStore(DIM, capacity=4, eviction="lfu")
    s.add(unit(0), "a", "ra")
    kb = s.add(unit(1), "b", "rb", ttl_s=5.0)
    for _ in range(4):
        s.search(unit(1), k=1)  # b: access_count 4, finite expiry
    idx_b = s._key_to_slot[kb]
    assert s.remove(kb)
    bank = s._bank
    # freed: the whole metadata row is reset
    assert int(s._access_count[idx_b]) == 0
    assert int(s._last_access[idx_b]) == 0
    assert int(s._insert_seq[idx_b]) == 0
    assert bank.h_expires[0, idx_b] == np.inf
    kd = s.add(unit(2), "d", "rd")  # reuses b's slot
    assert s._key_to_slot[kd] == idx_b
    kf = s.add(unit(3), "f", "rf")  # fresh slot, same moment
    idx_f = s._key_to_slot[kf]
    # parity: recycled slot is indistinguishable from the fresh one
    assert int(s._access_count[idx_b]) == int(s._access_count[idx_f]) == 0
    assert bank.h_expires[0, idx_b] == bank.h_expires[0, idx_f] == np.inf
    # no TTL inherited: d outlives b's would-be expiry window
    assert not s._entries[idx_b].expired(now=time.time() + 3600)


def test_freed_slot_reinsert_matches_fresh_insert_sharded():
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(device="cpu", shape=(len(jax.devices()),), axes=("data",))
    s = ShardedVectorStore(mesh, dim=DIM, capacity=4, k=2, eviction="lfu")
    s.add(unit(0), "a", "ra")
    kb = s.add(unit(1), "b", "rb", ttl_s=5.0)
    for _ in range(4):
        s.search_batch(unit(1)[None], k=1)
    idx_b = s._key_to_slot[kb]
    assert s.remove(kb)
    bank = s.bank
    lane, within = divmod(idx_b, s.cap_local)
    last, cnt, seq = bank.counters_host()
    assert int(cnt[lane, within]) == 0
    assert int(last[lane, within]) == 0
    assert int(seq[lane, within]) == 0
    assert bank.h_expires[lane, within] == np.inf
    kd = s.add(unit(2), "d", "rd")  # reuses the freed slot
    assert s._key_to_slot[kd] == idx_b
    _, cnt, _ = bank.counters_host()
    assert int(cnt[lane, within]) == 0  # no inherited frequency
    assert bank.h_expires[lane, within] == np.inf  # no inherited TTL
    # the recycled entry is served (valid mask really flipped back on)
    got = s.search_batch(unit(2)[None], k=1)[0]
    assert got and got[0][1][0] == "d"


# -- int32 insertion-clock overflow (satellite bugfix) -------------------------


def test_insert_seq_rebases_before_int32_overflow():
    """FIFO victim ordering survives the insertion clock running into the
    int32 ceiling: the claim path rank-rebases instead of wrapping."""
    s = InMemoryVectorStore(DIM, capacity=3, eviction="fifo")
    ka = s.add(unit(0), "a", "ra")
    kb = s.add(unit(1), "b", "rb")
    s._seq = _TICK_COMPACT_AT  # fast-forward ~2B inserts
    kc = s.add(unit(2), "c", "rc")  # triggers compact_seqs in the claim path
    assert s._seq < _TICK_COMPACT_AT  # clock restarted near zero
    kd = s.add(unit(3), "d", "rd")  # full: fifo must evict a (oldest)
    live = {e.key for e in s._entries if e is not None}
    assert live == {kb, kc, kd}
    ke = s.add(unit(4), "e", "re")  # then b
    live = {e.key for e in s._entries if e is not None}
    assert live == {kc, kd, ke}


def test_sharded_insert_seq_rebases_before_int32_overflow():
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(device="cpu", shape=(len(jax.devices()),), axes=("data",))
    s = ShardedVectorStore(mesh, dim=DIM, capacity=3, k=2, eviction="fifo")
    s.add(unit(0), "a", "ra")
    s.add(unit(1), "b", "rb")
    s._seq = _TICK_COMPACT_AT
    s.add(unit(2), "c", "rc")
    assert s._seq < _TICK_COMPACT_AT
    s.add(unit(3), "d", "rd")  # fifo evicts a
    live = {p[0] for p in s.payloads if p is not None}
    assert live == {"b", "c", "d"}


# -- sharded store TTL ---------------------------------------------------------


def test_sharded_ttl_expiry_and_clear():
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(device="cpu", shape=(len(jax.devices()),), axes=("data",))
    s = ShardedVectorStore(mesh, dim=DIM, capacity=4, k=2)
    s.add(unit(0), "dead", "dead answer", ttl_s=0.05)
    s.add(unit(1), "live", "live answer")
    time.sleep(0.1)
    got = s.search_batch(unit(0)[None], k=2)[0]
    assert all(p[0] != "dead" for _, p in got)  # expired never served
    assert s.clear(older_than=1e9) == 1  # expired always qualifies
    got = s.search_batch(unit(1)[None], k=1)[0]
    assert got and got[0][1][0] == "live"


# -- hierarchy + service integration -------------------------------------------


def test_hierarchy_consults_level_tiers_on_miss():
    from repro_torch.core import GenerativeCache, HierarchicalCache

    emb = NgramHashEmbedder()
    l1_store = InMemoryVectorStore(emb.dim, capacity=2,
                                   tier1=HostRamTier(emb.dim, 32))
    l2_store = InMemoryVectorStore(emb.dim, capacity=2,
                                   tier1=HostRamTier(emb.dim, 32))
    l1 = GenerativeCache(emb, threshold=0.85, t_single=0.45, t_combined=1.0,
                         store=l1_store)
    l2 = GenerativeCache(emb, threshold=0.85, t_single=0.45, t_combined=1.0,
                         store=l2_store)
    h = HierarchicalCache(l1, l2)
    for i in range(3):  # overflow L2 so its first entry demotes to its tier
        l2.insert(f"shared question {i} topic {i * 3}", f"shared answer {i}")
    assert len(l2_store.tier1) == 1
    rs = h.lookup_batch(["shared question 0 topic 0"])
    assert rs[0].hit
    assert rs[0].level == "L2:tier1"
    assert rs[0].response == "shared answer 0"
    # promoted into L1 like any lower-level winner
    r2 = h.lookup_batch(["shared question 0 topic 0"])
    assert r2[0].hit and r2[0].level.startswith("L1:")


def test_service_ttl_backfill_and_clear():
    from repro_torch.core import CacheRequest, EnhancedClient, GenerativeCache, MockLLM
    from repro_torch.core.request import GENERATED, HIT
    from repro_torch.serving.service import CacheService

    emb = NgramHashEmbedder()
    cache = GenerativeCache(emb, threshold=0.85, t_single=0.45, t_combined=1.0)
    client = EnhancedClient(cache=cache)
    client.register_backend(MockLLM("backend"))
    svc = CacheService(client)
    r1 = svc.complete([CacheRequest("what is a cache", ttl_s=0.2)])[0]
    assert r1.status == GENERATED
    r2 = svc.complete([CacheRequest("what is a cache")])[0]
    assert r2.status == HIT  # backfilled answer serves while alive
    time.sleep(0.3)
    r3 = svc.complete([CacheRequest("what is a cache")])[0]
    assert r3.status == GENERATED  # TTL carried through backfill: it expired
    n = len(cache.store)
    assert svc.clear() == n  # prune API surfaced on the service
    assert len(cache.store) == 0
