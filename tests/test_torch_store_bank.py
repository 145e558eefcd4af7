"""The port's StoreBank / InMemoryVectorStore against the reference package:
the same scatters, duplicate touches, frees and tick/sequence compactions
leave equal counters and pick equal victims under lru/lfu/fifo, and store
snapshots cross between the packages both ways."""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import store_bank as jsb
from repro.core.vector_store import InMemoryVectorStore as JStore
from repro_torch.core import store_bank as tsb
from repro_torch.core.vector_store import InMemoryVectorStore as TStore

torch.set_num_threads(1)

DIM = 8


def _vecs(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIM)).astype(np.float32)


def _pair(cap, eviction, **kw):
    return JStore(DIM, capacity=cap, eviction=eviction, **kw), TStore(
        DIM, capacity=cap, eviction=eviction, device="cpu", **kw
    )


def _assert_same_state(js, ts):
    for a, b in zip(js._bank.counters_host(), ts._bank.counters_host()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(js._valid), ts._valid.numpy())
    np.testing.assert_allclose(np.asarray(js._buf), ts._buf.numpy(), atol=1e-6)
    assert js._bank._tick == ts._bank._tick
    assert js._seq == ts._seq
    assert js._victim() == ts._victim()
    assert [e and e.query for e in js._entries] == [e and e.query for e in ts._entries]


def _drive(store, vecs):
    """One traffic script: inserts past capacity, searches that touch
    (duplicates inside one join), deferred key touches with repeats,
    removes, and re-inserts into freed slots."""
    keys = store.add_batch(vecs[:6], [f"q{i}" for i in range(6)], [f"a{i}" for i in range(6)])
    store.search_batch(vecs[[0, 0, 3]], k=2)  # duplicate touches in one scatter
    store.touch_keys([keys[1], keys[1], keys[4]])
    store.add_batch(vecs[6:9], ["q6", "q7", "q8"], ["a6", "a7", "a8"])  # evicts
    store.remove(keys[2]) if keys[2] in store._key_to_slot else None
    store.remove(keys[5]) if keys[5] in store._key_to_slot else None
    store.search_batch(vecs[[7, 8]], k=3)
    store.add(vecs[9], "q9", "a9")
    store.touch_keys([keys[0], keys[3]])
    return store


@pytest.mark.parametrize("eviction", ["lru", "lfu", "fifo"])
def test_same_traffic_same_counters_and_victims(eviction):
    js, ts = _pair(5, eviction)
    vecs = _vecs(12, seed=1)
    _drive(js, vecs)
    _drive(ts, vecs)
    _assert_same_state(js, ts)
    # a further batch that wraps capacity evicts the same slots
    for s in (js, ts):
        s.add_batch(vecs[9:12], ["x", "y", "z"], ["ax", "ay", "az"])
    _assert_same_state(js, ts)


@pytest.mark.parametrize("eviction", ["lru", "lfu", "fifo"])
def test_tick_and_seq_compaction(eviction):
    """Compaction near int32 saturation rank-rebases ticks and insertion
    sequence numbers identically and keeps the victim order."""
    js, ts = _pair(4, eviction)
    vecs = _vecs(10, seed=2)
    for s in (js, ts):
        s.add_batch(vecs[:4], list("abcd"), list("ABCD"))
        s.search_batch(vecs[[1, 1]], k=1)
        s._bank._tick = jsb._TICK_COMPACT_AT  # the next tick compacts
        s._seq = jsb._TICK_COMPACT_AT  # the next claim compacts
    assert tsb._TICK_COMPACT_AT == jsb._TICK_COMPACT_AT
    for s in (js, ts):
        s.search_batch(vecs[[2]], k=2)
        s.add(vecs[5], "e", "E")
        s.touch_keys([0, 0])
    _assert_same_state(js, ts)
    assert ts._bank._tick < 100 and ts._seq < 100


def test_multi_lane_duplicate_touches_add_and_take_max():
    jb = jsb.StoreBank(DIM, [4, 6, 3])
    tb = tsb.StoreBank(DIM, [4, 6, 3], device="cpu")
    lanes = [0, 1, 1, 1, 2, 0]
    idxs = [3, 5, 5, 0, 2, 3]
    for b in (jb, tb):
        b.touch_slots(lanes, idxs)
        b.touch_slots([1, 1], [5, 2])
        b.free_slots([2], [2])
        b._mirror = None  # force the device -> host read
    for a, c in zip(jb.counters_host(), tb.counters_host()):
        np.testing.assert_array_equal(a, c)
    assert tb.counters_host()[1][1, 5] == 3  # two in one scatter + one more
    assert tb.counter_scatters == jb.counter_scatters == 2
    assert tb.free_scatters == jb.free_scatters == 1


def test_prepare_scatter_last_write_wins():
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    out_rows, out_idx, extra = tsb.prepare_scatter([5, 2, 5, 7], rows, np.array([10, 11, 12, 13]))
    j_rows, j_idx, j_extra = jsb.prepare_scatter([5, 2, 5, 7], rows, np.array([10, 11, 12, 13]))
    n = len(out_idx)  # the reference pads to a power-of-two bucket by repeats
    np.testing.assert_array_equal(out_idx, j_idx[:n])
    np.testing.assert_array_equal(out_rows, j_rows[:n])
    np.testing.assert_array_equal(extra, j_extra[:n])
    assert dict(zip(out_idx.tolist(), extra.tolist())) == {5: 12, 2: 11, 7: 13}


def test_lifecycle_rescore_matches():
    jb = jsb.StoreBank(DIM, [4, 4])
    tb = tsb.StoreBank(DIM, [4, 4], device="cpu")
    created = np.array([[0.0, 1.0, 2.0, 3.0], [0.5, 0.5, 0.5, 0.5]])
    expires = np.array([[10.0, np.inf, 2.5, 8.0], [1.0, np.inf, 5.0, 20.0]])
    for b in (jb, tb):
        b.set_lifecycle(created, expires)
        b.set_staleness(0, 0.25)
        b.set_staleness(1, 0.5)
    scores = np.array([[[0.9, 0.8, 0.7, -np.inf], [0.95, 0.6, 0.5, 0.4]]], np.float32)
    idx = np.array([[[0, 2, 3, 1], [0, 2, 3, 1]]], np.int32)
    lanes = np.arange(2)[None, :, None]
    sj = jb.lifecycle_rescore(scores, lanes, idx, now=4.0)
    st = tb.lifecycle_rescore(scores, lanes, idx, now=4.0)
    np.testing.assert_array_equal(sj, st)
    for a, b in zip(jsb.StoreBank.resort_desc(sj, idx), tsb.StoreBank.resort_desc(st, idx)):
        np.testing.assert_array_equal(a, b)


def _snapshot_state(store):
    s, i = store._bank.search_lane(store._lane, _vecs(5, seed=9), 3)
    return s, i


def _filled(cls, **kw):
    store = cls(DIM, capacity=6, eviction="lfu", default_ttl_s=3600.0, **kw)
    vecs = _vecs(8, seed=3)
    keys = store.add_batch(vecs, [f"q{i}" for i in range(8)], [f"a{i}" for i in range(8)])
    store.touch_keys([keys[3], keys[3], keys[7]])
    store.remove(keys[4])
    return store


def _read_snapshot(path):
    z = np.load(os.path.join(path, "vectors.npz"))
    with open(os.path.join(path, "manifest.json")) as f:
        return {k: z[k] for k in z.files}, json.load(f)


def test_snapshot_jax_to_port_and_back(tmp_path):
    js = _filled(JStore)
    js.save(str(tmp_path / "j"))
    ts = TStore.load(str(tmp_path / "j"), device="cpu")
    sj, ij = _snapshot_state(js)
    st, it = _snapshot_state(ts)
    np.testing.assert_allclose(sj, st, atol=1e-6)
    np.testing.assert_array_equal(ij, it)
    assert ts._victim() == js._victim()
    assert [e and (e.key, e.query, e.created_at, e.expires_at) for e in ts._entries] == [
        e and (e.key, e.query, e.created_at, e.expires_at) for e in js._entries
    ]
    # the port writes the same snapshot back: same arrays, same manifest
    ts.save(str(tmp_path / "t"))
    (za, ma), (zb, mb) = _read_snapshot(tmp_path / "j"), _read_snapshot(tmp_path / "t")
    assert ma == mb
    assert za.keys() == zb.keys()
    for k in za:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k])


def test_snapshot_port_to_jax(tmp_path):
    ts = _filled(TStore, device="cpu")
    ts.save(str(tmp_path / "t"))
    js = JStore.load(str(tmp_path / "t"))
    sj, ij = _snapshot_state(js)
    st, it = _snapshot_state(ts)
    np.testing.assert_allclose(sj, st, atol=1e-6)
    np.testing.assert_array_equal(ij, it)
    assert js._victim() == ts._victim()
    assert js._next_key == ts._next_key and js.size == ts.size
    for a, b in zip(js._bank.counters_host(), ts._bank.counters_host()):
        np.testing.assert_array_equal(a, b)


def test_adopt_stacks_lanes_on_one_device():
    a = TStore(DIM, capacity=3, device="cpu")
    b = TStore(DIM, capacity=5, metric="dot", device="cpu")
    a.add_batch(_vecs(2, 5), ["x", "y"], ["X", "Y"])
    b.add_batch(_vecs(4, 6), list("abcd"), list("ABCD"))
    bank = tsb.StoreBank.adopt([a, b])
    assert bank.buf.shape == (2, 5, DIM) and bank.metrics == ("cosine", "dot")
    assert a._bank is bank and b._lane == 1
    assert bank.valid.sum().item() == 6
    assert a.search(_vecs(1, 5)[0], k=1)[0][1].query == "x"


def _assert_nothing_valid_past_capacity(bank):
    for lane, cap in enumerate(bank.capacities):
        assert not bank.valid[lane, cap:].any(), (lane, cap)


def test_no_row_past_a_lane_capacity_is_ever_valid(tmp_path):
    """The search reads only [0, capacity) of each lane (``lane_rows``), which
    is exact because no insert, free, adopt or snapshot load sets ``valid``
    past a lane's capacity: a bank of capacities (16, 64) through inserts
    that wrap capacity, slot frees, an adoption and a snapshot round trip."""
    a = TStore(DIM, capacity=16, device="cpu")
    b = TStore(DIM, capacity=64, metric="dot", device="cpu")
    a.add_batch(_vecs(40, 11), [f"a{i}" for i in range(40)], [f"A{i}" for i in range(40)])
    b.add_batch(_vecs(50, 12), [f"b{i}" for i in range(50)], [f"B{i}" for i in range(50)])
    bank = tsb.StoreBank.adopt([a, b])
    assert bank.capacities == [16, 64] and bank.buf.shape == (2, 64, DIM)
    _assert_nothing_valid_past_capacity(bank)
    keys = a.add_batch(_vecs(30, 13), [f"c{i}" for i in range(30)], [f"C{i}" for i in range(30)])
    b.add_batch(_vecs(20, 14), [f"d{i}" for i in range(20)], [f"D{i}" for i in range(20)])
    _assert_nothing_valid_past_capacity(bank)
    assert int(bank.valid[0].sum()) == 16 and int(bank.valid[1].sum()) == 64
    for key in keys[-3:]:
        a.remove(key)
    bank.free_slots([1, 1], [0, 63])
    _assert_nothing_valid_past_capacity(bank)
    a.add_batch(_vecs(5, 15), list("vwxyz"), list("VWXYZ"))
    _assert_nothing_valid_past_capacity(bank)
    a.save(str(tmp_path / "a"))
    a2 = TStore.load(str(tmp_path / "a"), device="cpu")
    assert a2.capacity == 16 and not a2._bank.valid[0, 16:].any()
    bank2 = tsb.StoreBank.adopt([a2, b])
    _assert_nothing_valid_past_capacity(bank2)
    assert torch.equal(bank2.valid[0, :16], bank.valid[0, :16])


def test_searches_hand_the_kernel_each_lane_capacity(monkeypatch):
    """``read_path._search`` and ``StoreBank.search_lanes`` pass the bank's
    capacities as ``lane_rows``; ``search_lane`` passes the lane's own
    [capacity, D] rows. A ``topk=`` recorder sees every call."""
    from repro_torch.core import read_path as trp
    from repro_torch.kernels.similarity_topk import kernel as tk
    from repro_torch.kernels.similarity_topk import ops as tops

    seen = []

    def recorder(db, valid, q, k, lane_rows=None):
        seen.append((tuple(db.shape), lane_rows))
        return tk.similarity_topk_lanes_plain(db, valid, q, k, lane_rows)

    core = tops._similarity_topk_lanes
    monkeypatch.setattr(tops, "_similarity_topk_lanes",
                        lambda *a, **kw: core(*a, topk=recorder, **kw))
    a = TStore(DIM, capacity=16, use_pallas=True, device="cpu")
    b = TStore(DIM, capacity=64, use_pallas=True, device="cpu")
    a.add_batch(_vecs(10, 21), [f"a{i}" for i in range(10)], [f"A{i}" for i in range(10)])
    b.add_batch(_vecs(30, 22), [f"b{i}" for i in range(30)], [f"B{i}" for i in range(30)])
    bank = tsb.StoreBank.adopt([a, b])
    q = _vecs(3, 23)
    s_plain, i_plain = tsb.fused_search_body(bank.buf, bank.valid, torch.from_numpy(q), 4,
                                             bank.metrics, bank.prenorm)
    s, i = bank.search_lanes(q, 4)
    assert seen[-1] == ((2, 64, DIM), (16, 64))
    np.testing.assert_allclose(s, s_plain.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(i, i_plain.numpy())
    trp._search(bank, torch.from_numpy(q), bank.valid, 4, use_kernel=True)
    assert seen[-1] == ((2, 64, DIM), (16, 64))
    got = a.search_batch(q, k=4)
    assert seen[-1] == ((1, 16, DIM), None)  # the single-store form: the lane's 16 rows
    assert [len(g) for g in got] == [4, 4, 4]
