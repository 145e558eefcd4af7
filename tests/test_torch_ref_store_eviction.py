"""The reference's ``tests/test_store_eviction.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

InMemoryVectorStore slot management: all three eviction policies under
wraparound, O(1) remove via the key->slot map, and freed-slot reuse (a removed
slot must be recycled before any live entry is evicted).
"""
import numpy as np
import pytest

from repro_torch.core.vector_store import InMemoryVectorStore
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


DIM = 8


def unit(i: int) -> np.ndarray:
    v = np.zeros(DIM, np.float32)
    v[i] = 1.0
    return v


def keys_of(store, q, k=8):
    return [e.key for _, e in store.search(q, k=k)]


@pytest.fixture
def full3():
    def make(eviction):
        s = InMemoryVectorStore(DIM, capacity=3, eviction=eviction)
        ks = [s.add(unit(i), f"q{i}", f"a{i}") for i in range(3)]
        return s, ks

    return make


def test_lru_evicts_least_recently_accessed(full3):
    s, (k0, k1, k2) = full3("lru")
    s.search(unit(0), k=1)  # touch entry 0; entry 1 is now least recent
    k3 = s.add(unit(3), "q3", "a3")
    live = {e.key for e in s._entries if e is not None}
    assert live == {k0, k2, k3}


def test_lfu_evicts_least_frequently_accessed(full3):
    s, (k0, k1, k2) = full3("lfu")
    for _ in range(2):
        s.search(unit(0), k=1)
    s.search(unit(2), k=1)
    k3 = s.add(unit(3), "q3", "a3")  # entry 1 has count 0
    live = {e.key for e in s._entries if e is not None}
    assert live == {k0, k2, k3}


def test_fifo_ignores_recency(full3):
    s, (k0, k1, k2) = full3("fifo")
    s.search(unit(0), k=1)  # recency must not save entry 0 under FIFO
    k3 = s.add(unit(3), "q3", "a3")
    k4 = s.add(unit(4), "q4", "a4")
    live = {e.key for e in s._entries if e is not None}
    assert live == {k2, k3, k4}


@pytest.mark.parametrize("eviction", ["lru", "lfu", "fifo"])
def test_wraparound_keeps_capacity_and_serves_survivors(eviction):
    s = InMemoryVectorStore(DIM, capacity=3, eviction=eviction)
    keys = [s.add(unit(i % DIM), f"q{i}", f"a{i}") for i in range(7)]
    assert len(s) == 3
    # the most recent insert always survives its own add
    assert keys[-1] in {e.key for e in s._entries if e is not None}


@pytest.mark.parametrize("eviction", ["lru", "lfu", "fifo"])
def test_remove_frees_slot_for_reuse(eviction):
    s = InMemoryVectorStore(DIM, capacity=3, eviction=eviction)
    ka = s.add(unit(0), "a", "A")
    kb = s.add(unit(1), "b", "B")
    kc = s.add(unit(2), "c", "C")
    slot_b = s._key_to_slot[kb]
    assert s.remove(kb)
    assert len(s) == 2
    # the freed slot is recycled: no live entry is evicted by the next add
    kd = s.add(unit(3), "d", "D")
    assert s._key_to_slot[kd] == slot_b
    live = {e.key for e in s._entries if e is not None}
    assert live == {ka, kc, kd}
    assert s._tail == 3  # no extra slot consumed


def test_remove_unknown_and_double_remove():
    s = InMemoryVectorStore(DIM, capacity=3)
    k = s.add(unit(0), "a", "A")
    assert not s.remove(999)
    assert s.remove(k)
    assert not s.remove(k)
    assert len(s) == 0
    assert s.search(unit(0), k=2) == []


def test_multiple_removes_then_wraparound_evicts_live_last():
    s = InMemoryVectorStore(DIM, capacity=3, eviction="lru")
    ka = s.add(unit(0), "a", "A")
    kb = s.add(unit(1), "b", "B")
    kc = s.add(unit(2), "c", "C")
    s.remove(ka)
    s.remove(kc)
    kd = s.add(unit(3), "d", "D")
    ke = s.add(unit(4), "e", "E")
    assert len(s) == 3  # both freed slots reused, b survived
    kf = s.add(unit(5), "f", "F")  # now full: LRU evicts b (oldest access)
    live = {e.key for e in s._entries if e is not None}
    assert live == {kd, ke, kf}


def test_removed_entry_not_returned_by_search():
    s = InMemoryVectorStore(DIM, capacity=4)
    k0 = s.add(unit(0), "a", "A")
    s.add(unit(1), "b", "B")
    assert s.remove(k0)
    assert k0 not in keys_of(s, unit(0))


def test_persistence_roundtrip_preserves_free_slots(tmp_path):
    s = InMemoryVectorStore(DIM, capacity=3, eviction="lru")
    ka = s.add(unit(0), "a", "A")
    kb = s.add(unit(1), "b", "B")
    slot_a = s._key_to_slot[ka]
    s.remove(ka)
    s.save(str(tmp_path / "store"))
    s2 = InMemoryVectorStore.load(str(tmp_path / "store"))
    assert len(s2) == 1
    assert s2._key_to_slot == {kb: s._key_to_slot[kb]}
    # freed slot survives the roundtrip and is reused first
    kc = s2.add(unit(2), "c", "C")
    assert s2._key_to_slot[kc] == slot_a
    assert {e.key for e in s2._entries if e is not None} == {kb, kc}


def _assert_stores_identical(a, b):
    np.testing.assert_allclose(np.asarray(a._buf), np.asarray(b._buf), atol=0)
    assert np.array_equal(np.asarray(a._valid), np.asarray(b._valid))
    assert [(e.key, e.query, e.response) if e else None for e in a._entries] == \
           [(e.key, e.query, e.response) if e else None for e in b._entries]
    assert a._key_to_slot == b._key_to_slot
    assert a.size == b.size and a._tail == b._tail and a._next_key == b._next_key


@pytest.mark.parametrize("eviction", ["lru", "lfu", "fifo"])
def test_add_batch_matches_sequential_adds_under_wraparound(eviction):
    """One multi-row scatter must leave the store entry-for-entry identical to
    N sequential adds — including policy eviction once the batch wraps."""
    a = InMemoryVectorStore(DIM, capacity=4, eviction=eviction)
    b = InMemoryVectorStore(DIM, capacity=4, eviction=eviction)
    rows = np.stack([unit(i % DIM) for i in range(11)])
    qs = [f"q{i}" for i in range(11)]
    rs = [f"a{i}" for i in range(11)]
    keys_a = [a.add(v, q, r) for v, q, r in zip(rows, qs, rs)]
    keys_b = b.add_batch(rows, qs, rs)
    assert keys_a == keys_b
    _assert_stores_identical(a, b)


@pytest.mark.parametrize("eviction", ["lru", "lfu", "fifo"])
def test_add_batch_reuses_freed_slots_before_evicting(eviction):
    a = InMemoryVectorStore(DIM, capacity=3, eviction=eviction)
    b = InMemoryVectorStore(DIM, capacity=3, eviction=eviction)
    for s in (a, b):
        k0 = s.add(unit(0), "a", "A")
        s.add(unit(1), "b", "B")
        s.add(unit(2), "c", "C")
        s.remove(k0)
    rows = np.stack([unit(3), unit(4)])
    keys_a = [a.add(v, q, r) for v, q, r in zip(rows, ["d", "e"], ["D", "E"])]
    keys_b = b.add_batch(rows, ["d", "e"], ["D", "E"])
    assert keys_a == keys_b
    _assert_stores_identical(a, b)
    assert b._tail == 3  # freed slot recycled, no extra slot consumed


def test_add_batch_empty_and_single():
    s = InMemoryVectorStore(DIM, capacity=4)
    assert s.add_batch(np.zeros((0, DIM), np.float32), [], []) == []
    assert len(s) == 0
    (k,) = s.add_batch(unit(1)[None], ["q"], ["a"], metas=[{"m": 1}])
    assert s._entries[s._key_to_slot[k]].meta == {"m": 1}
    assert keys_of(s, unit(1)) == [k]


def test_add_batch_then_search_serves_new_entries():
    s = InMemoryVectorStore(DIM, capacity=8)
    s.add_batch(np.stack([unit(0), unit(1)]), ["a", "b"], ["A", "B"])
    assert [e.response for _, e in s.search(unit(1), k=1)] == ["B"]


def test_search_batch_updates_recency_like_search():
    s = InMemoryVectorStore(DIM, capacity=3, eviction="lru")
    k0 = s.add(unit(0), "a", "A")
    k1 = s.add(unit(1), "b", "B")
    k2 = s.add(unit(2), "c", "C")
    s.search_batch(np.stack([unit(0), unit(2)]), k=1)  # batched touch of 0 and 2
    k3 = s.add(unit(3), "d", "D")  # must evict entry 1
    live = {e.key for e in s._entries if e is not None}
    assert live == {k0, k2, k3}


# -- ShardedVectorStore: key->slot map + freed-slot reuse (ported remove path) --


def _sharded(capacity=8, k=3, dim=DIM):
    jax = pytest.importorskip("jax")
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(device="cpu", shape=(len(jax.devices()),), axes=("data",))
    return ShardedVectorStore(mesh, dim=dim, capacity=capacity, k=k)


def test_sharded_remove_frees_slot_for_reuse():
    s = _sharded()
    keys = [s.add(unit(i), f"q{i}", f"a{i}") for i in range(3)]
    assert len(s) == 3
    victim_slot = s._key_to_slot[keys[1]]
    assert s.remove(keys[1])
    assert len(s) == 2
    assert s.payloads[victim_slot] is None
    # removed entry is no longer served
    rows = s.search_batch(unit(1)[None])[0]
    assert all(p != ("q1", "a1") for _, p in rows)
    # the freed slot is recycled before the round-robin cursor advances
    k_new = s.add(unit(5), "q5", "a5")
    assert s._key_to_slot[k_new] == victim_slot
    assert len(s) == 3
    top = s.search_batch(unit(5)[None])[0]
    assert top and top[0][1] == ("q5", "a5")


def test_sharded_remove_unknown_and_double():
    s = _sharded()
    k0 = s.add(unit(0), "q0", "a0")
    assert not s.remove(9999)
    assert s.remove(k0)
    assert not s.remove(k0)  # idempotent
    assert len(s) == 0


def test_sharded_add_batch_reuses_freed_slots():
    s = _sharded(capacity=8)
    keys = [s.add(unit(i), f"q{i}", f"a{i}") for i in range(4)]
    freed = [s._key_to_slot[keys[1]], s._key_to_slot[keys[2]]]
    s.remove(keys[1])
    s.remove(keys[2])
    new_keys = s.add_batch(
        np.stack([unit(5), unit(6)]), ["q5", "q6"], ["a5", "a6"]
    )
    # both freed slots were recycled (LIFO pop order) before cursor growth
    assert sorted(s._key_to_slot[k] for k in new_keys) == sorted(freed)
    assert len(s) == 4


def test_sharded_wraparound_retires_overwritten_keys():
    s = _sharded(capacity=4)
    keys = [s.add(unit(i % DIM), f"q{i}", f"a{i}") for i in range(6)]  # wraps
    assert len(s) == 4
    # the two overwritten entries' keys are gone from the map
    assert keys[0] not in s._key_to_slot and keys[1] not in s._key_to_slot
    assert all(k in s._key_to_slot for k in keys[2:])
    # removing a retired key is a no-op
    assert not s.remove(keys[0])
