"""The port's ShardedVectorStore against the reference's.

One scripted sequence — adds past capacity under lru, lfu and fifo, batched
adds with metas and TTLs, fused and host searches and lookups with and
without touches, deferred ``touch_keys``, removes and freed-slot reuse, a
clock that expires TTL'd entries, ``clear(older_than=...)`` — drives a store
of each package. Payloads, keys, global ids, counters, lifecycle stamps and
the cursor state must be equal; scores are equal under the dot metric with
dyadic vectors, and within 2e-5 under cosine (random vectors). The clock is
pinned (``StoreBank.rel_now``) so the stamps of both runs agree.

At one position both packages run in this process. At 8 positions (a
("data",) mesh, and (pod 2 x data 4)) the reference runs once, in a
subprocess with 8 forced host devices: this file re-executes itself and
writes the reference outputs to an npz; the port replays the sequence on 8
CPU positions. ``make_banked_lookup`` / ``make_sharded_lookup`` are held to
the reference in their hierarchical and flat merges on inputs full of exact
ties and holes.

The assertions of tests/test_sharded_tier1.py and
tests/test_sharded_eviction.py follow, as cases of the port (the
reference's restore path raises on this jax — see ROADMAP queue C — so the
port is held to those tests' assertions, not to the reference's outputs).
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

DIM = 16
CAP = 8
CLOCK = [1000.0]
EIGHT = {"data8": ((8,), ("data",)), "pod2xdata4": ((2, 4), ("pod", "data"))}
SCRIPTS = [("dot", "lru"), ("dot", "lfu"), ("dot", "fifo"), ("cosine", "lru")]


def _ref_ns():
    from repro.core import store_bank
    from repro.distributed import sharded_store
    from repro.launch.mesh import make_test_mesh

    return SimpleNamespace(
        sb=store_bank, ss=sharded_store, name="ref",
        mesh=lambda shape, axes: make_test_mesh(shape=shape, axes=axes),
        np=np.asarray,
    )


def _port_ns():
    from repro_torch.core import store_bank
    from repro_torch.distributed import sharded_store
    from repro_torch.launch.mesh import make_test_mesh

    return SimpleNamespace(
        sb=store_bank, ss=sharded_store, name="port",
        mesh=lambda shape, axes: make_test_mesh(shape, axes, device="cpu"),
        np=lambda t: t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
    )


class _Clock:
    """Pin ``StoreBank.rel_now`` of one package to ``CLOCK``."""

    def __init__(self, ns, start=1000.0):
        self.cls, self.start = ns.sb.StoreBank, start

    def __enter__(self):
        self.saved = self.cls.__dict__["rel_now"]
        self.cls.rel_now = staticmethod(lambda: CLOCK[0])
        CLOCK[0] = self.start

    def __exit__(self, *exc):
        self.cls.rel_now = self.saved


def _tick(dt):
    CLOCK[0] += dt


def _vecs(metric, n, seed):
    rng = np.random.default_rng(seed)
    if metric == "cosine":
        return rng.standard_normal((n, DIM)).astype(np.float32)
    v = np.zeros((n, DIM), np.float32)  # dyadic coordinates: exact sums, exact ties
    for i in range(n):
        v[i, i % DIM] = 1.0
        v[i, (3 * i + 1) % DIM] += rng.integers(0, 4) * 0.25
    return v


def _rows(rows):
    """search_batch rows -> (scores nan-padded [Q, k], payload JSON)."""
    k = max([len(r) for r in rows] + [1])
    s = np.full((len(rows), k), np.nan, np.float64)
    for i, r in enumerate(rows):
        s[i, : len(r)] = [x[0] for x in r]
    return s, np.array(json.dumps([[list(x[1]) for x in r] for r in rows]))


def _best(found):
    """lookup_batch output -> (scores with nan for a miss, payload JSON)."""
    s = np.array([np.nan if f is None else f[0] for f in found], np.float64)
    return s, np.array(json.dumps([None if f is None else list(f[1]) for f in found]))


def _state(ns, s):
    last, cnt, seq = s.bank.counters_host()
    return {
        "last": np.array(last), "cnt": np.array(cnt), "seq": np.array(seq),
        "created": np.array(s.bank.h_created), "expires": np.array(s.bank.h_expires),
        "valid": ns.np(s.bank.valid), "db.x": ns.np(s.bank.buf),
        "host": np.array(json.dumps({
            "payloads": [None if p is None else list(p) for p in s.payloads],
            "metas": s._metas, "slot_key": s._slot_key, "free": s._free,
            "size": s.size, "rr": s._rr, "seq": s._seq, "tick": s.bank._tick,
            "next_key": s._next_key, "len": len(s),
        })),
    }


def store_script(ns, mesh, metric, eviction):
    """The scripted sequence on one store; returns name -> array."""
    out = {}

    def put(tag, value):
        if isinstance(value, dict):
            for k, x in value.items():
                out[f"{tag}|{k}"] = x
        else:
            out[tag] = np.asarray(value)

    v = _vecs(metric, 24, seed=3)
    q = np.concatenate([v[[0, 6, 9, 2]], (v[1] + v[5])[None] * 0.5, np.zeros((1, DIM), np.float32)])
    thr = np.asarray([0.5, 0.9, 0.0, 2.0, 0.25, -1.0], np.float32)
    with _Clock(ns):
        s = ns.ss.ShardedVectorStore(mesh, dim=DIM, capacity=CAP, k=3, metric=metric,
                                     eviction=eviction, staleness_weight=0.25)
        keys = [s.add(v[i], f"q{i}", f"a{i}", ttl_s=40.0 if i % 3 == 0 else None)
                for i in range(5)]
        _tick(2)
        keys += s.add_batch(v[5:11], [f"q{i}" for i in range(5, 11)],
                            [f"a{i}" for i in range(5, 11)],
                            metas=[{"i": i} if i % 2 else None for i in range(5, 11)],
                            ttls=[None, 30.0, None, 60.0, None, None])  # past capacity
        put("fill", _state(ns, s))
        _tick(3)
        sc, pl = _rows(s.search_batch(q, k=2))
        put("sb1.s", sc)
        put("sb1", pl)
        s.touch_keys([keys[6], keys[6], keys[9], 12345])
        _tick(1)
        sc, pl = _best(s.lookup_batch(q, thr))
        put("lb1.s", sc)
        put("lb1", pl)
        put("touched", _state(ns, s))
        put("removed", [s.remove(keys[9]), s.remove(keys[10]), s.remove(keys[0]), s.remove(999)])
        _tick(5)
        keys += s.add_batch(v[11:16], [f"q{i}" for i in range(11, 16)],
                            [f"a{i}" for i in range(11, 16)])  # freed slots first, then evicts
        put("reuse", _state(ns, s))
        _tick(30)  # the 30 s TTLs are past, the 40 s ones age
        sc, ix = s.search(q)
        put("search.s", sc)
        put("search.i", ix)
        sc, ix = s.search_host(q)
        put("search_host.s", sc)
        put("search_host.i", ix)
        sc, pl = _rows(s.search_batch_host(q, k=3, touch=True))
        put("sbh.s", sc)
        put("sbh", pl)
        sc, pl = _rows(s.search_batch(q, touch=False))
        put("sbnt.s", sc)
        put("sbnt", pl)
        sc, pl = _best(s.lookup_batch_host(q, thr))
        put("lbh.s", sc)
        put("lbh", pl)
        put("searched", _state(ns, s))
        _tick(5)
        keys.append(s.add(v[16], "q16", "a16"))  # takes the most-expired slot
        put("cleared_n", s.clear(older_than=20.0))
        put("cleared", _state(ns, s))
        keys += s.add_batch(v[17:24], [f"q{i}" for i in range(17, 24)],
                            [f"a{i}" for i in range(17, 24)])
        sc, pl = _rows(s.search_batch(q))
        put("sb2.s", sc)
        put("sb2", pl)
        put("final", _state(ns, s))
        put("keys", keys)
    return out


def lookup_script(ns, mesh):
    """make_sharded_lookup / make_banked_lookup, hierarchical and flat, on a
    db of repeated dyadic rows with holes: ties everywhere."""
    n = int(np.prod([mesh.shape[a] for a in ("pod", "data") if a in mesh.axis_names]))
    N = 4 * n
    rng = np.random.default_rng(5)
    pool = _vecs("dot", 3, seed=7)
    db = pool[rng.integers(0, 3, N)]
    valid = rng.random(N) < 0.7
    q = np.concatenate([pool, np.zeros((1, DIM), np.float32)])
    out = {}
    for metric in ("dot", "cosine"):
        for hier in (True, False):
            tag = f"{metric}|{'hier' if hier else 'flat'}"
            f = ns.ss.make_sharded_lookup(mesh, k=6, metric=metric, hierarchical=hier)
            s, i = f(db, valid, q)
            out[f"{tag}|flat.s"], out[f"{tag}|flat.i"] = ns.np(s), ns.np(i)
            fb = ns.ss.make_banked_lookup(mesh, k=6, metric=metric, hierarchical=hier)
            s, i = fb(db.reshape(n, 4, DIM), valid.reshape(n, 4), q)
            out[f"{tag}|banked.s"], out[f"{tag}|banked.i"] = ns.np(s), ns.np(i)
    return out


def run_all(ns, meshes):
    out = {}
    for mname, (shape, axes) in meshes.items():
        mesh = ns.mesh(shape, axes)
        for metric, eviction in SCRIPTS:
            for k, x in store_script(ns, mesh, metric, eviction).items():
                out[f"{mname}|{metric}-{eviction}|{k}"] = x
        for k, x in lookup_script(ns, mesh).items():
            out[f"{mname}|lookup|{k}"] = x
    return out


def _assert_same(got, want, prefix, cosine=False):
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and sorted(k for k in got if k.startswith(prefix)) == keys
    for k in keys:
        a, b = got[k], want[k]
        assert a.shape == b.shape, k
        loose = (cosine or "cosine" in k) and (k.endswith(".s") or k.endswith(".x"))
        if loose:
            same_inf = np.isinf(b) | np.isnan(b)
            np.testing.assert_array_equal(a[same_inf], b[same_inf], err_msg=k)
            np.testing.assert_allclose(a[~same_inf], b[~same_inf], atol=2e-5, rtol=0, err_msg=k)
        elif a.dtype.kind in "US":
            assert str(a) == str(b), k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("metric,eviction", SCRIPTS)
def test_one_position_matches_reference(metric, eviction):
    jr, tp = _ref_ns(), _port_ns()
    want = store_script(jr, jr.mesh((1,), ("data",)), metric, eviction)
    got = store_script(tp, tp.mesh((1,), ("data",)), metric, eviction)
    _assert_same(got, want, "", cosine=metric == "cosine")


def test_one_position_lookups_match_reference():
    jr, tp = _ref_ns(), _port_ns()
    want = lookup_script(jr, jr.mesh((1,), ("data",)))
    got = lookup_script(tp, tp.mesh((1,), ("data",)))
    _assert_same(got, want, "")


@pytest.fixture(scope="module")
def eight_device_reference(tmp_path_factory):
    """The reference's outputs on 8 forced host devices, computed once in a
    subprocess that runs this file as a script."""
    out = tmp_path_factory.mktemp("sharded_store") / "reference.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    env["JAX_PLATFORMS"] = "cpu"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.path.join(root, "src")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                       cwd=root, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def eight_position_port():
    return run_all(_port_ns(), EIGHT)


@pytest.mark.parametrize("mesh_name", sorted(EIGHT))
@pytest.mark.parametrize("script", [f"{m}-{e}" for m, e in SCRIPTS] + ["lookup"])
def test_eight_positions_match_reference(eight_device_reference, eight_position_port,
                                         mesh_name, script):
    _assert_same(eight_position_port, eight_device_reference, f"{mesh_name}|{script}|")


# -- tests/test_sharded_tier1.py and tests/test_sharded_eviction.py, on the port --


def unit(i: int, dim: int = 8) -> np.ndarray:
    x = np.zeros(dim, np.float32)
    x[i] = 1.0
    return x


def _store(capacity=3, eviction="lru", tier_cap=None, k=3, **kw):
    from repro_torch.core.tiers import HostRamTier
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((1,), ("data",), device="cpu")
    tier = HostRamTier(8, capacity=tier_cap) if tier_cap else None
    s = ShardedVectorStore(mesh, dim=8, capacity=capacity, k=k, eviction=eviction, tier1=tier, **kw)
    return s, tier


def _live_queries(s):
    return {p[0] for p in s.payloads if p is not None}


def test_eviction_demotes_victim_into_tier1():
    s, tier = _store(capacity=3, tier_cap=16)
    keys = [s.add(unit(i), f"q{i}", f"a{i}") for i in range(3)]
    s.search_batch(unit(0)[None], k=1)  # touch q0 -> q1 is the LRU victim
    s.add(unit(3), "q3", "a3")
    assert len(tier) == 1
    sc, slots = tier.search(unit(1), k=1)
    e = tier.get(int(slots[0, 0]))
    assert sc[0, 0] == pytest.approx(1.0, abs=1e-5)
    assert (e.key, e.query, e.response) == (keys[1], "q1", "a1")
    assert 0 <= e.meta["home_shard"] < s.n_shards


def test_demotion_preserves_stamps_and_access_count():
    s, tier = _store(capacity=3, tier_cap=16, default_ttl_s=3600.0)
    for i in range(3):
        s.add(unit(i), f"q{i}", f"a{i}")
    for _ in range(3):  # bump q0's frequency counter, then evict it anyway
        s.search_batch(unit(0)[None], k=1)
    s.search_batch(unit(1)[None], k=1)
    s.search_batch(unit(2)[None], k=1)
    s.add(unit(3), "q3", "a3")  # q0 touched first -> the LRU victim
    victims = [e for e, _ in tier.snapshot_entries()]
    assert len(victims) == 1
    e = victims[0]
    assert e.access_count == 3
    assert e.expires_at - e.created_at == pytest.approx(3600.0, abs=5.0)


def test_promote_restores_identity_and_prefers_home_slot():
    from repro_torch.core.tiers import TierEntry

    s, tier = _store(capacity=4, tier_cap=16)
    keys = [s.add(unit(i), f"q{i}", f"a{i}") for i in range(4)]
    for _ in range(2):
        s.search_batch(unit(0)[None], k=1)
    home_idx = s._key_to_slot[keys[0]]
    s.remove(keys[0])  # frees the slot without demoting (explicit delete)
    assert len(tier) == 0
    s._restore_batch(unit(0)[None], [TierEntry(
        key=keys[0], query="q0", response="a0",
        meta={"home_shard": home_idx // s.cap_local},
        created_at=s.bank.to_abs(0.0) + 5.0, expires_at=float("inf"), access_count=7,
    )])
    idx = s._key_to_slot[keys[0]]
    assert idx == home_idx  # freed home-lane slot reused, nobody evicted
    assert s.payloads[idx] == ("q0", "a0")
    assert len(s) == 4 and all(p is not None for p in s.payloads[:4])
    lane, within = s._lane_within(idx)
    assert int(s.bank.access_count[lane, within]) == 7
    sc, idxs = s.search(unit(0)[None])
    assert sc[0, 0] == pytest.approx(1.0, abs=1e-5) and int(idxs[0, 0]) == idx


def test_demote_restore_roundtrip_via_tier_pop():
    s, tier = _store(capacity=2, tier_cap=16)
    ka = s.add(unit(0), "qa", "ra")
    s.add(unit(1), "qb", "rb")
    s.search_batch(unit(0)[None], k=1)  # count 1 on qa
    s.add(unit(2), "qc", "rc")  # evicts qb; qa survives
    s.add(unit(3), "qd", "rd")  # now qa demotes too
    assert ka not in s._key_to_slot and len(tier) == 2
    sc, slots = tier.search(unit(0), k=1)
    e, vec = tier.pop(int(slots[0, 0]))
    s._restore_batch(vec[None], [e])
    idx = s._key_to_slot[ka]
    assert s.payloads[idx] == ("qa", "ra")
    lane, within = s._lane_within(idx)
    assert int(s.bank.access_count[lane, within]) == 1
    assert len(tier) == 2  # restoring displaced a live entry: it demoted, not dropped


def test_clear_cascades_into_tier1():
    s, tier = _store(capacity=2, tier_cap=16)
    for i in range(4):
        s.add(unit(i), f"q{i}", f"a{i}")
    assert len(tier) == 2
    assert s.clear() == 4 and len(s) == 0 and len(tier) == 0


def test_consult_tier1_promotes_through_semantic_cache():
    from repro_torch.core.embeddings import NgramHashEmbedder
    from repro_torch.core.semantic_cache import SemanticCache
    from repro_torch.core.tiers import HostRamTier
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_test_mesh

    emb = NgramHashEmbedder(dim=8)
    tier = HostRamTier(8, capacity=16)
    store = ShardedVectorStore(make_test_mesh((1,), ("data",), device="cpu"), dim=8,
                               capacity=2, k=2, tier1=tier)
    cache = SemanticCache(emb, threshold=0.85, store=store)
    va = emb.embed(["oldest question"])[0]
    store.add(va, "oldest question", "oldest answer")
    store.add(emb.embed(["middle question"])[0], "middle question", "middle answer")
    store.add(emb.embed(["newest question"])[0], "newest question", "newest answer")
    assert len(tier) == 1  # oldest demoted
    out = cache.consult_tier1(["oldest question"], np.asarray(va)[None], [0.85], [0])
    assert 0 in out
    r = out[0]
    assert r.hit and r.level == "tier1" and r.response == "oldest answer"
    # promoted out of the ring; the entry it displaced demoted into it
    assert {e.response for e, _ in tier.snapshot_entries()} != {"oldest answer"}
    sc, _ = store.search(np.asarray(va)[None])
    assert sc[0, 0] == pytest.approx(1.0, abs=1e-4)  # back on device


def test_lru_evicts_least_recently_accessed():
    s, _ = _store(eviction="lru")
    for i in range(3):
        s.add(unit(i), f"q{i}", f"a{i}")
    s.search_batch(unit(0)[None], k=1)  # touch entry 0; entry 1 is now LRU
    s.add(unit(3), "q3", "a3")
    assert _live_queries(s) == {"q0", "q2", "q3"}


def test_lfu_evicts_least_frequently_accessed():
    s, _ = _store(eviction="lfu")
    for i in range(3):
        s.add(unit(i), f"q{i}", f"a{i}")
    for _ in range(2):
        s.search_batch(unit(0)[None], k=1)
    s.search_batch(unit(2)[None], k=1)
    s.add(unit(3), "q3", "a3")  # entry 1 has count 0
    assert _live_queries(s) == {"q0", "q2", "q3"}


def test_fifo_ignores_recency():
    s, _ = _store(eviction="fifo")
    for i in range(3):
        s.add(unit(i), f"q{i}", f"a{i}")
    s.search_batch(unit(0)[None], k=1)  # recency must not save entry 0
    s.add(unit(3), "q3", "a3")
    s.add(unit(4), "q4", "a4")
    assert _live_queries(s) == {"q2", "q3", "q4"}


def test_touch_false_defers_to_touch_keys():
    s, _ = _store(eviction="lru")
    keys = [s.add(unit(i), f"q{i}", f"a{i}") for i in range(3)]
    before = s.bank.access_count.copy()
    recency = s.bank.last_access.copy()
    s.search_batch(unit(0)[None], k=1, touch=False)
    assert np.array_equal(s.bank.access_count, before)
    assert np.array_equal(s.bank.last_access, recency)
    s.touch_keys([keys[0]])
    assert s.bank.access_count.sum() == before.sum() + 1
    s.add(unit(3), "q3", "a3")  # entry 1 is LRU after the deferred bump
    assert _live_queries(s) == {"q0", "q2", "q3"}


def test_touch_keys_skips_retired_keys():
    s, _ = _store(eviction="lru")
    k0 = s.add(unit(0), "q0", "a0")
    s.remove(k0)
    s.touch_keys([k0, 999])  # no crash, no counter movement
    assert s.bank.access_count.sum() == 0


def test_removed_slot_reused_before_eviction():
    s, _ = _store(eviction="lru")
    keys = [s.add(unit(i), f"q{i}", f"a{i}") for i in range(3)]
    s.remove(keys[1])
    s.add(unit(4), "q4", "a4")  # freed slot recycled: nothing live evicted
    assert _live_queries(s) == {"q0", "q2", "q4"}


@pytest.mark.parametrize("eviction", ["lru", "lfu", "fifo"])
def test_sharded_eviction_matches_inmemory_victims(eviction):
    from repro_torch.core.vector_store import InMemoryVectorStore

    s, _ = _store(capacity=4, eviction=eviction)
    m = InMemoryVectorStore(8, capacity=4, eviction=eviction, device="cpu")
    for i in range(4):
        s.add(unit(i), f"q{i}", f"a{i}")
        m.add(unit(i), f"q{i}", f"a{i}")
    for probe in (0, 0, 3):
        s.search_batch(unit(probe)[None], k=1)
        m.search_batch(unit(probe)[None], k=1)
    for i in range(4, 7):
        s.add(unit(i), f"q{i}", f"a{i}")
        m.add(unit(i), f"q{i}", f"a{i}")
    assert _live_queries(s) == {e.query for e in m._entries if e is not None}


@pytest.mark.parametrize("eviction", ["lru", "lfu", "fifo"])
def test_sharded_add_batch_evicts_like_sequential(eviction):
    a, _ = _store(capacity=4, eviction=eviction)
    b, _ = _store(capacity=4, eviction=eviction)
    rows = np.stack([unit(i % 8) for i in range(10)])
    qs = [f"q{i}" for i in range(10)]
    rs = [f"a{i}" for i in range(10)]
    keys_a = [a.add(v, q, r) for v, q, r in zip(rows, qs, rs)]
    keys_b = b.add_batch(rows, qs, rs)
    assert keys_a == keys_b
    assert a.payloads == b.payloads
    np.testing.assert_array_equal(a._db.numpy(), b._db.numpy())


def test_sharded_bank_writes_land_on_their_position():
    """``ShardedBank`` keeps ``StoreBank``'s host state and write paths: a
    lane write (``set_rows``) and a scatter by global slot land in the
    owning position's part, with their counters; a write through the
    gathered global view raises instead of being lost; the bank cannot be
    adopted."""
    from repro_torch.distributed.sharded_store import ShardedBank

    bank = ShardedBank(8, 8, 3, [torch.device("cpu")] * 4, metric="dot")
    assert [p.buf.shape for p in bank.parts] == [(2, 3, 8)] * 4 and bank.lanes_loc == 2
    assert bank._mirror[0].shape == (8, 3) and bank.h_expires.shape == (8, 3)
    bank.note_insert(5, 1, 7)
    bank.set_rows(5, [1], unit(3)[None])  # lane 5 = position 2, its lane 1
    bank.note_insert(0, 2, 8)
    bank.scatter_rows([2], unit(4)[None])  # global slot 2 = lane 0, row 2
    part = bank.parts[2]
    np.testing.assert_array_equal(part.buf[1, 1].numpy(), unit(3))
    assert bool(part.valid[1, 1]) and int(part.d_insert_seq[1, 1]) == 7
    assert bool(bank.parts[0].valid[0, 2]) and int(bank.parts[0].d_insert_seq[0, 2]) == 8
    assert int(bank.valid.sum()) == 2 and int(bank.insert_seq[5, 1]) == 7
    with pytest.raises(RuntimeError):
        bank.buf[0, 0] = 1.0
    with pytest.raises(RuntimeError):
        bank.d_access_count.add_(1)
    assert int(bank.d_access_count.sum()) == 0
    with pytest.raises(TypeError):
        ShardedBank.adopt([])


if __name__ == "__main__":
    # the 8-device reference run (see ``eight_device_reference``)
    import jax

    assert len(jax.devices()) == 8, jax.devices()
    np.savez(sys.argv[1], **run_all(_ref_ns(), EIGHT))
