"""The port's sharded read path (repro_torch.distributed.sharded_read) and its
hooks in the hierarchy and the service.

``ShardedReadBank``: a replicated hot L1 (InMemory) and a key-sharded L2 over
the mesh, with the reference tests' dyadic dot-metric fixtures (numpy, torch
and XLA float32 cannot diverge by rounding). Its ``fused_read`` must equal

- the port's own ``host_reference_read`` (the numpy mirror): winners,
  hit/generative classes, candidate scores/slots and the counter deltas,
  at 1 and 8 CPU positions, with the router, the lifecycle with the clock
  pinned, and ``shard_mask``; one read is ONE dispatch and ZERO host hops;
- the reference's ``fused_read`` on the same scripted sequence: at one
  position in this process, at 8 positions (("data",) and pod 2 x data 4)
  through one subprocess with 8 forced host devices (this file runs itself
  as a script there and writes the reference's outputs to an npz). The port
  runs it on both of its routes: the kernel route (``use_pallas=True``: B1
  over the hot lanes, B2 per position — their plain versions on the CPU)
  and the plain one. Cosine fixtures hold scores within 2e-5.

Then the hierarchy through tier a0 and ``CacheService`` over a sharded
hierarchy: a seeded ``squad_like_qa`` replay with ``MockLLM``, against the
reference's statuses, responses, hit levels and stats.
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
INF = float("inf")
CLOCK = [1000.0]
EIGHT = {"data8": ((8,), ("data",)), "pod2xdata4": ((2, 4), ("pod", "data"))}


def unit(i, scale=1.0):
    v = np.zeros(DIM, np.float32)
    v[i] = np.float32(scale)
    return v


def _ref_ns():
    from repro.core import store_bank
    from repro.core.read_path import LevelSpec
    from repro.core.vector_store import InMemoryVectorStore
    from repro.distributed import sharded_read, sharded_store
    from repro.launch.mesh import make_test_mesh

    return SimpleNamespace(
        sb=store_bank, sr=sharded_read, LevelSpec=LevelSpec,
        mesh=lambda shape, axes: make_test_mesh(shape=shape, axes=axes),
        mem=lambda cap, metric: InMemoryVectorStore(DIM, cap, metric, "lru"),
        sharded=lambda mesh, **kw: sharded_store.ShardedVectorStore(mesh, dim=DIM, **kw),
        np=np.asarray,
    )


def _port_ns(kernel=True):
    from repro_torch.core import store_bank
    from repro_torch.core.read_path import LevelSpec
    from repro_torch.core.vector_store import InMemoryVectorStore
    from repro_torch.distributed import sharded_read, sharded_store
    from repro_torch.launch.mesh import make_test_mesh

    return SimpleNamespace(
        sb=store_bank, sr=sharded_read, LevelSpec=LevelSpec,
        mesh=lambda shape, axes: make_test_mesh(shape, axes, device="cpu"),
        mem=lambda cap, metric: InMemoryVectorStore(DIM, cap, metric, "lru",
                                                    use_pallas=kernel, device="cpu"),
        sharded=lambda mesh, **kw: sharded_store.ShardedVectorStore(
            mesh, dim=DIM, use_pallas=kernel, **kw),
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
        return self

    def __exit__(self, *exc):
        self.cls.rel_now = self.saved


def _specs(ns):
    # L1 semantic (threshold-only), L2 generative (the §3 rule applies)
    return (ns.LevelSpec(False, True, 0.0, INF, 0, 4), ns.LevelSpec(True, True, 0.3, 1.0, 4, 5))


def _mixed_bank(ns, mesh, metric="dot", sh_ttl=None, staleness=0.0):
    """Replicated hot L1 (InMemory) + key-sharded L2 over the mesh, adopted
    into one ShardedReadBank. Dot fixtures (dyadic):

        L1:  unit(0), unit(1), unit(2)
        L2:  unit(10), unit(11), unit(12), unit(1)

    cosine fixtures: the same rows plus seeded noise."""
    rep = ns.mem(4, metric)
    sh = ns.sharded(mesh, capacity=16, k=5, metric=metric, default_ttl_s=sh_ttl,
                    staleness_weight=staleness)
    noise = np.random.default_rng(4).standard_normal((8, DIM)).astype(np.float32) * 0.1
    for j, i in enumerate(range(3)):
        rep.add(unit(i) + (noise[j] if metric == "cosine" else 0), f"l1-q{i}", f"l1-a{i}")
    for j, i in enumerate((10, 11, 12, 1)):
        sh.add(unit(i) + (noise[3 + j] if metric == "cosine" else 0), f"l2-q{i}", f"l2-a{i}")
    srb = ns.sr.ShardedReadBank(mesh, [("rep", rep), ("sh", sh)])
    return rep, sh, srb


def _queries():
    q = np.stack([
        unit(0),                               # L1 exact hit
        unit(10),                              # L2 exact hit
        unit(11, 0.75) + unit(12, 0.75),       # L2 generative (1.5 > t_comb)
        unit(13),                              # miss everywhere
        unit(0, 0.5),                          # below both thresholds: miss
        unit(1),                               # both levels score 1.0: L1 wins
    ])
    thr = np.full((len(q), 2), 0.9, np.float32)
    return q, thr


def _counters(ns, srb):
    return [(ns.np(b.d_last_access).copy(), ns.np(b.d_access_count).copy()) for b in srb.banks()]


def read_script(ns, mesh, metric="dot"):
    """The scripted reads on one mixed bank; returns name -> array."""
    out = {}

    def record(tag, dec):
        for f in ("scores", "idx", "winner", "hit", "generative"):
            out[f"{tag}|{f}" + (".s" if f == "scores" else "")] = np.asarray(getattr(dec, f))
        for bi, (last, cnt) in enumerate(_counters(ns, srb)):
            out[f"{tag}|bank{bi}|last"], out[f"{tag}|bank{bi}|cnt"] = last, cnt

    specs = _specs(ns)
    q, thr = _queries()
    with _Clock(ns):
        rep, sh, srb = _mixed_bank(ns, mesh, metric)
        record("read", srb.fused_read(None, [None] * len(q), thr, specs, vecs=q))
        router = np.ones((len(q), 2), bool)
        router[1, 1] = False
        router[5, 0] = False
        record("router", srb.fused_read(None, [None] * len(q), thr, specs, vecs=q,
                                        router=router))
        record("notouch", srb.fused_read(None, [None] * len(q), thr, specs, vecs=q,
                                         touch=False))
        mask = np.ones(srb.n_shards, bool)
        if srb.n_shards > 1:
            mask[int(out["read|idx"][1, 1, 0]) // (sh.capacity // srb.n_shards)] = False
        record("masked", srb.fused_read(None, [None] * len(q), thr, specs, vecs=q,
                                        shard_mask=mask))
        out["degraded_reads"] = np.asarray(srb.degraded_reads)
        out["dispatches"] = np.asarray([srb.dispatches, srb.host_hops, srb.counter_scatters]
                                       + [b.dispatches for b in srb.banks()]
                                       + [b.counter_scatters for b in srb.banks()])
        # lifecycle: TTL'd L2 with a staleness penalty, one row dead by now
        rep, sh, srb = _mixed_bank(ns, mesh, metric, sh_ttl=30.0, staleness=0.5)
        sh.add(unit(14), "l2-q14", "l2-a14", ttl_s=5.0)
        CLOCK[0] += 15.0
        ql = np.concatenate([q, unit(14)[None]])
        thl = np.concatenate([thr, np.full((1, 2), 0.9, np.float32)])
        record("lifecycle", srb.fused_read(None, [None] * len(ql), thl, specs, vecs=ql))
        # the store's own fused forms ride a single-member read
        s, i = sh.search(ql)
        out["search.s"], out["search|idx"] = s, i
        found = sh.lookup_batch(ql, np.full(len(ql), 0.4))
        out["lookup"] = np.array(json.dumps([None if f is None else list(f[1]) for f in found]))
        out["lookup.s"] = np.array([np.nan if f is None else f[0] for f in found])
    return out


def run_all(ns, meshes):
    out = {}
    for mname, (shape, axes) in meshes.items():
        mesh = ns.mesh(shape, axes)
        for metric in ("dot", "cosine"):
            for k, x in read_script(ns, mesh, metric).items():
                out[f"{mname}|{metric}|{k}"] = x
    return out


def _assert_same(got, want, prefix, cosine=False):
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and sorted(k for k in got if k.startswith(prefix)) == keys
    for k in keys:
        a, b = got[k], want[k]
        assert a.shape == b.shape, k
        if (cosine or "|cosine|" in k) and k.endswith(".s"):
            fixed = np.isinf(b) | np.isnan(b)
            np.testing.assert_array_equal(a[fixed], b[fixed], err_msg=k)
            np.testing.assert_allclose(a[~fixed], b[~fixed], atol=2e-5, rtol=0, err_msg=k)
        elif a.dtype.kind in "US":
            assert str(a) == str(b), k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


# -- against the reference -------------------------------------------------------


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel_route", "plain_route"])
@pytest.mark.parametrize("metric", ["dot", "cosine"])
def test_one_position_matches_reference(metric, kernel):
    jr, tp = _ref_ns(), _port_ns(kernel)
    want = read_script(jr, jr.mesh((1,), ("data",)), metric)
    got = read_script(tp, tp.mesh((1,), ("data",)), metric)
    _assert_same(got, want, "", cosine=metric == "cosine")


@pytest.fixture(scope="module")
def eight_device_reference(tmp_path_factory):
    """The reference's outputs on 8 forced host devices (reads and the
    service replay), computed once in a subprocess running this file."""
    out = tmp_path_factory.mktemp("sharded_read") / "reference.npz"
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
    return {kernel: run_all(_port_ns(kernel), EIGHT) for kernel in (True, False)}


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel_route", "plain_route"])
@pytest.mark.parametrize("metric", ["dot", "cosine"])
@pytest.mark.parametrize("mesh_name", sorted(EIGHT))
def test_eight_positions_match_reference(eight_device_reference, eight_position_port,
                                         mesh_name, metric, kernel):
    _assert_same(eight_position_port[kernel], eight_device_reference, f"{mesh_name}|{metric}|")


# -- the port against its own numpy mirror (the reference tests' assertions) -------


POSITIONS = [1, 8]


def _port_bank(n, **kw):
    tp = _port_ns()
    return tp, (*_mixed_bank(tp, tp.mesh((n,), ("data",)), **kw),)


def _expected_count_delta(ns, srb, ref):
    """+1 on every (query, level, col) cell the touch mask selects, landed
    at that level's bank slot."""
    deltas = [np.zeros(c.shape, np.int64) for _, c in _counters(ns, srb)]
    ri = 0
    for li, (kind, store) in enumerate(srb.members):
        if kind == "rep":
            bi, lane = 0, ri
            ri += 1
        else:
            bi, lane = 1 + srb.sh_stores.index(store), None
        for qi, col in zip(*np.nonzero(ref["tmask"][:, li])):
            slot = int(ref["idx"][qi, li, col])
            if lane is not None:
                deltas[bi][lane, slot] += 1
            else:
                deltas[bi].reshape(-1)[slot] += 1
    return deltas


@pytest.mark.parametrize("n", POSITIONS)
def test_fused_matches_host_reference_bitwise(n):
    from repro_torch.distributed.sharded_read import host_reference_read

    tp, (rep, sh, srb) = _port_bank(n)
    assert sh.n_shards == n
    q, thr = _queries()
    specs = _specs(tp)
    ref = host_reference_read(srb, q, thr, specs)
    before = _counters(tp, srb)
    dec = srb.fused_read(None, [None] * len(q), thr, specs, vecs=q)
    after = _counters(tp, srb)
    for f in ("winner", "hit", "generative", "scores", "idx"):
        np.testing.assert_array_equal(getattr(dec, f), ref[f], err_msg=f)
    np.testing.assert_array_equal(ref["winner"], [0, 1, 1, 2, 2, 0])
    assert bool(dec.generative[2, 1]) and not bool(dec.generative[1, 1])
    for (l0, c0), (l1, c1), exp in zip(before, after, _expected_count_delta(tp, srb, ref)):
        np.testing.assert_array_equal(c1.astype(np.int64) - c0.astype(np.int64), exp)
        touched = exp > 0
        assert (l1[touched] > l0[touched]).all()
        np.testing.assert_array_equal(l1[~touched], l0[~touched])
    assert sh.payloads[int(dec.idx[1, 1, 0])] == ("l2-q10", "l2-a10")


@pytest.mark.parametrize("n", POSITIONS)
def test_touch_false_leaves_counters(n):
    tp, (_, _, srb) = _port_bank(n)
    q, thr = _queries()
    before = _counters(tp, srb)
    srb.fused_read(None, [None] * len(q), thr, _specs(tp), vecs=q, touch=False)
    for (l0, c0), (l1, c1) in zip(before, _counters(tp, srb)):
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_array_equal(l0, l1)


@pytest.mark.parametrize("n", POSITIONS)
def test_router_masks_lane_visibility(n):
    from repro_torch.distributed.sharded_read import host_reference_read

    tp, (_, _, srb) = _port_bank(n)
    q, thr = _queries()
    router = np.ones((len(q), 2), bool)
    router[1, 1] = False  # hide L2 from the L2-exact-hit query
    router[5, 0] = False  # hide L1 from the tie query -> L2 must win it
    ref = host_reference_read(srb, q, thr, _specs(tp), router=router)
    dec = srb.fused_read(None, [None] * len(q), thr, _specs(tp), vecs=q, router=router,
                         touch=False)
    np.testing.assert_array_equal(dec.winner, ref["winner"])
    np.testing.assert_array_equal(dec.scores, ref["scores"])
    assert int(dec.winner[1]) == 2 and int(dec.winner[5]) == 1


@pytest.mark.parametrize("n", POSITIONS)
def test_lifecycle_pre_topk_parity(n):
    from repro_torch.core.store_bank import StoreBank
    from repro_torch.distributed.sharded_read import host_reference_read

    tp = _port_ns()
    with _Clock(tp):
        _, sh, srb = _mixed_bank(tp, tp.mesh((n,), ("data",)), sh_ttl=30.0, staleness=0.5)
        sh.add(unit(14), "l2-q14", "l2-a14", ttl_s=5.0)  # dead at now + 15
        assert srb.lifecycle_active()
        CLOCK[0] += 15.0
        q, thr = _queries()
        q = np.concatenate([q, unit(14)[None]])
        thr = np.concatenate([thr, np.full((1, 2), 0.9, np.float32)])
        ref = host_reference_read(srb, q, thr, _specs(tp), now=StoreBank.rel_now())
        dec = srb.fused_read(None, [None] * len(q), thr, _specs(tp), vecs=q, touch=False)
    np.testing.assert_array_equal(dec.scores, ref["scores"])
    np.testing.assert_array_equal(dec.winner, ref["winner"])
    # the penalty applied before the top-k: 1.0 - 0.5 * (15/30) = 0.75 < 0.9
    assert float(dec.scores[1, 1, 0]) == 0.75 and int(dec.winner[1]) == 2
    # the expired row is invisible, not merely penalized
    assert float(dec.scores[6, 1, 0]) < 0.0 and int(dec.winner[6]) == 2


@pytest.mark.parametrize("metric", ["dot", "cosine"])
def test_lifecycle_route_is_each_levels_own(metric, monkeypatch):
    """Only L2 carries TTLs and a staleness weight: L2 is scored by the plain
    route with its penalty before the top-k, while L1, which has no
    lifecycle, keeps the kernel route (one call of B1's core over the hot
    lanes, no B2). The read equals the reference's fused_read."""
    from repro_torch.kernels.similarity_topk import kernel as tk
    from repro_torch.kernels.similarity_topk import ops

    calls = {"lanes": 0, "single": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(tk, "similarity_topk_lanes_blocks",
                        counted("lanes", tk.similarity_topk_lanes_blocks))
    monkeypatch.setattr(ops, "similarity_topk", counted("single", ops.similarity_topk))
    jr, tp = _ref_ns(), _port_ns(kernel=True)
    outs = []
    for ns in (jr, tp):
        with _Clock(ns):
            _, sh, srb = _mixed_bank(ns, ns.mesh((1,), ("data",)), metric, sh_ttl=30.0,
                                     staleness=0.5)
            sh.add(unit(14), "l2-q14", "l2-a14", ttl_s=5.0)  # dead at now + 15
            CLOCK[0] += 15.0
            q, thr = _queries()
            q = np.concatenate([q, unit(14)[None]])
            thr = np.concatenate([thr, np.full((1, 2), 0.9, np.float32)])
            if ns is tp:
                assert not srb.rep_bank.lifecycle_active() and sh.bank.lifecycle_active()
                calls.update(lanes=0, single=0)
            dec = srb.fused_read(None, [None] * len(q), thr, _specs(ns), vecs=q)
        out = {f"{f}" + (".s" if f == "scores" else ""): np.asarray(getattr(dec, f))
               for f in ("scores", "idx", "winner", "hit", "generative")}
        for bi, (last, cnt) in enumerate(_counters(ns, srb)):
            out[f"bank{bi}|last"], out[f"bank{bi}|cnt"] = last, cnt
        outs.append(out)
    assert calls == {"lanes": 1, "single": 0}
    _assert_same(outs[1], outs[0], "", cosine=metric == "cosine")
    assert int(outs[1]["winner"][1]) == 2 and int(outs[1]["winner"][0]) == 0


@pytest.mark.parametrize("n", POSITIONS)
def test_store_fused_matches_host_paths(n):
    tp = _port_ns()
    s = tp.sharded(tp.mesh((n,), ("data",)), capacity=8, k=3, metric="dot")
    for i in range(5):
        s.add(unit(i), f"q{i}", f"a{i}")
    q = np.stack([unit(0), unit(4), unit(2, 0.5), unit(7)])
    fs, fi = s.search(q)
    hs, hi = s.search_host(q)
    np.testing.assert_array_equal(fs, hs)
    np.testing.assert_array_equal(fi, hi)
    assert s.search_batch(q, k=3, touch=False) == s.search_batch_host(q, k=3, touch=False)
    fl = s.lookup_batch(q, np.full(len(q), 0.9))
    assert fl == s.lookup_batch_host(q, np.full(len(q), 0.9))
    assert fl[0] == (1.0, ("q0", "a0")) and fl[3] is None


@pytest.mark.parametrize("n", POSITIONS)
def test_dispatch_and_host_hop_budget(n):
    tp, (_, _, srb) = _port_bank(n)
    q, thr = _queries()
    srb.fused_read(None, [None] * len(q), thr, _specs(tp), vecs=q)  # flush pending
    banks = srb.banks()
    d0 = [(b.dispatches, b.host_hops, b.counter_scatters) for b in banks]
    sd0 = (srb.dispatches, srb.host_hops, srb.counter_scatters)
    srb.fused_read(None, [None] * len(q), thr, _specs(tp), vecs=q)
    assert srb.dispatches - sd0[0] == 1  # ONE read
    assert srb.host_hops == sd0[1] == 0 and srb.counter_scatters == sd0[2]
    assert [(b.dispatches, b.host_hops, b.counter_scatters) for b in banks] == d0


@pytest.mark.parametrize("n", POSITIONS)
def test_shard_mask_degrades_to_survivors(n):
    from repro_torch.distributed.sharded_read import host_reference_read

    tp, (_, sh, srb) = _port_bank(n)
    q, thr = _queries()
    specs = _specs(tp)
    with pytest.raises(ValueError):
        srb.fused_read(None, [None] * len(q), thr, specs, vecs=q,
                       shard_mask=np.zeros(n, bool))
    if n == 1:
        ref = host_reference_read(srb, q, thr, specs)
        dec = srb.fused_read(None, [None] * len(q), thr, specs, vecs=q, touch=False,
                             shard_mask=np.ones(1, bool))
        np.testing.assert_array_equal(dec.winner, ref["winner"])
        assert not srb.degraded  # an all-alive mask is not a degraded read
        return
    clean = host_reference_read(srb, q, thr, specs)
    dead = int(clean["idx"][1, 1, 0]) // (sh.capacity // n)
    mask = np.ones(n, bool)
    mask[dead] = False
    ref = host_reference_read(srb, q, thr, specs, shard_mask=mask)
    before = _counters(tp, srb)
    dec = srb.fused_read(None, [None] * len(q), thr, specs, vecs=q, shard_mask=mask)
    after = _counters(tp, srb)
    assert srb.degraded and srb.degraded_reads == 1
    for f in ("winner", "hit", "generative"):
        np.testing.assert_array_equal(getattr(dec, f), ref[f])
    finite = np.isfinite(ref["scores"])
    np.testing.assert_array_equal(dec.scores[finite], ref["scores"][finite])
    np.testing.assert_array_equal(dec.idx[finite], ref["idx"][finite])
    assert bool(clean["hit"][1, 1]) and not bool(dec.hit[1, 1]) and bool(dec.hit[0, 0])
    for (_, c0), (_, c1), exp in zip(before, after, _expected_count_delta(tp, srb, ref)):
        np.testing.assert_array_equal(c1.astype(np.int64) - c0.astype(np.int64), exp)


def test_local_topk_routes_agree_with_several_lanes_per_position():
    """A position holding 2 lanes: B1 per lane plus the stable merge equals
    one top-k over the position's flattened slots, ties and holes included."""
    from repro_torch.distributed.sharded_read import _local_topk
    from repro_torch.distributed.sharded_store import ShardedBank

    bank = ShardedBank(DIM, 8, 6, [torch.device("cpu")] * 4, metric="dot")
    rows = np.stack([unit(i % 3) for i in range(48)])
    bank.scatter_rows([i for i in range(48) if i % 5], rows[[i for i in range(48) if i % 5]])
    q = torch.as_tensor(np.stack([unit(0), unit(1), unit(7)]))
    for part in bank.parts:
        for K in (3, 6, 9, 12):
            want = _local_topk(part, q, K, "dot", False, False, False, None)
            got = _local_topk(part, q, K, "dot", False, True, False, None)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- the hierarchy (tier a0) and the service -------------------------------------


def _hier(n=1):
    from repro_torch.core import GenerativeCache, HierarchicalCache
    from repro_torch.core.embeddings import NgramHashEmbedder
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_cache_mesh

    emb = NgramHashEmbedder(dim=DIM)
    mesh = make_cache_mesh(n, device="cpu")
    l1 = GenerativeCache(emb, threshold=0.6, t_single=0.45, t_combined=1.0, capacity=16,
                         device="cpu")
    l2 = GenerativeCache(emb, threshold=0.6, t_single=0.45, t_combined=1.0,
                         store=ShardedVectorStore(mesh, dim=emb.dim, capacity=16, k=4))
    return l1, l2, HierarchicalCache(l1, l2)


@pytest.mark.parametrize("n", POSITIONS)
def test_hierarchy_serves_through_sharded_bank(n):
    l1, l2, h = _hier(n)
    srb = h.ensure_sharded_bank()
    assert srb is not None and h.ensure_sharded_bank() is srb  # cached
    l1.insert("what is the capital of france", "Paris")
    l2.insert("how tall is the eiffel tower", "330 m")
    h.lookup_batch(["warm"])
    d0 = srb.dispatches
    res = h.lookup_batch([
        "what is the capital of france",
        "how tall is the eiffel tower",
        "unrelated quantum chromodynamics question",
    ])
    assert srb.dispatches - d0 == 1 and srb.host_hops == 0
    assert [r.hit for r in res] == [True, True, False]
    assert res[0].level.startswith("L1:") and res[1].level.startswith("L2:")
    d1 = srb.dispatches  # the L2 winner was promoted into L1
    res2 = h.lookup_batch(["how tall is the eiffel tower"])
    assert res2[0].level.startswith("L1:") and srb.dispatches - d1 == 1


def test_hierarchy_router_knob():
    from repro_torch.core import HierarchicalCache

    l1, l2, _ = _hier()
    l2.insert("who wrote les miserables", "Victor Hugo")
    h = HierarchicalCache(l1, l2, router=lambda qs, cs: np.array([[True, False]] * len(qs)))
    assert h.ensure_sharded_bank() is not None
    assert not h.lookup_batch(["who wrote les miserables"])[0].hit  # L2 routed away
    assert HierarchicalCache(l1, l2).lookup_batch(["who wrote les miserables"])[0].hit


def test_ineligible_levels_return_none():
    from repro_torch.core import GenerativeCache, HierarchicalCache
    from repro_torch.core.embeddings import NgramHashEmbedder
    from repro_torch.core.vector_store import InMemoryVectorStore
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_cache_mesh

    emb = NgramHashEmbedder(dim=DIM)
    l1 = GenerativeCache(emb, capacity=16, device="cpu")
    l2 = GenerativeCache(emb, capacity=16, device="cpu")
    assert HierarchicalCache(l1, l2).ensure_sharded_bank() is None  # no sharded level
    l2s = GenerativeCache(emb, store=ShardedVectorStore(make_cache_mesh(device="cpu"),
                                                        dim=emb.dim, capacity=16))
    assert HierarchicalCache(l1, l2s).ensure_sharded_bank() is not None

    class CustomStore(InMemoryVectorStore):
        def search_batch(self, q_vecs, k=4, touch=True):
            return super().search_batch(q_vecs, k=k, touch=touch)

    l1c = GenerativeCache(emb, store=CustomStore(emb.dim, 16, device="cpu"))
    assert HierarchicalCache(l1c, l2s).ensure_sharded_bank() is None
    other = GenerativeCache(emb, store=ShardedVectorStore(make_cache_mesh(device="cpu"),
                                                          dim=emb.dim, capacity=16))
    assert HierarchicalCache(l1, l2s, peers=[other]).ensure_sharded_bank() is None  # two meshes


# the service replay: same seeded traffic through each package's stack

KNOBS = (0.85, 0.45, 1.0)  # threshold, t_single, t_combined (n-gram embedder)


def _summary(resp):
    cr = resp.cache_result
    return [resp.status, resp.text, resp.from_cache, resp.model,
            None if cr is None else [cr.level, cr.generative, cr.hit]]


def service_replay(n_pos, port=False):
    """``CacheService(max_batch=8)`` over HierarchicalCache(L1 InMemory, L2
    ShardedVectorStore over ``n_pos`` positions), MockLLM on misses, a
    seeded ``squad_like_qa`` replay; returns the summaries and stats."""
    if port:
        from repro_torch import core as P
        from repro_torch.data.synthetic import squad_like_qa
        from repro_torch.distributed.sharded_store import ShardedVectorStore
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.serving.service import CacheService

        mesh = make_test_mesh((n_pos,), ("data",), device="cpu")
        kw, skw = {"device": "cpu", "use_pallas": True}, {"use_pallas": True}
    else:
        from repro import core as P
        from repro.data.synthetic import squad_like_qa
        from repro.distributed.sharded_store import ShardedVectorStore
        from repro.launch.mesh import make_test_mesh
        from repro.serving.service import CacheService

        mesh = make_test_mesh(shape=(n_pos,), axes=("data",))
        kw, skw = {"use_pallas": True}, {}
    t, ts, tc = KNOBS
    emb = P.NgramHashEmbedder()
    l1 = P.GenerativeCache(emb, threshold=t, t_single=ts, t_combined=tc, capacity=16, **kw)
    l2 = P.GenerativeCache(emb, threshold=t, t_single=ts, t_combined=tc,
                           store=ShardedVectorStore(mesh, dim=emb.dim, capacity=64, k=4, **skw))
    h = P.HierarchicalCache(l1, l2)
    client = P.EnhancedClient(cache=l1, hierarchy=h)
    client.register_backend(P.MockLLM("mock-llm"))
    service = CacheService(client, max_batch=8)
    data = squad_like_qa(10, 4, seed=2, with_aspects=True)
    warm = data[::3]  # a third of the answers are cached in the sharded L2
    h.l2.insert_batch([q for q, _, _ in warm], [a for _, a, _ in warm])
    out = []
    prompts = [q for q, _, _ in data]
    for b in range(0, len(prompts), 8):
        out.extend(service.complete([P.CacheRequest(p) for p in prompts[b : b + 8]]))
    for p in prompts[:3] + ["a question nobody asked before"]:
        out.append(service.submit(P.CacheRequest(p)).result(timeout=60))
    service.close()
    stats = {
        "client": [getattr(client.stats, k) for k in
                   ("requests", "cache_hits", "llm_calls", "llm_errors", "total_cost_usd")],
        "levels": [[getattr(c.stats, k) for k in
                    ("lookups", "hits", "generative_hits", "tier1_hits", "adds")]
                   for c in (h.l1, h.l2)],
        "service": [getattr(service.stats, k) for k in
                    ("submitted", "hits", "generated", "expired", "deduped")],
        "sharded_reads": int(h._sharded_bank is not None and h._sharded_bank.dispatches > 0),
        "l2_live": len(h.l2.store),
    }
    return {"summaries": [_summary(r) for r in out], "stats": stats}


@pytest.mark.parametrize("n", [1])
def test_service_replay_matches_reference(n):
    want = service_replay(n)
    got = service_replay(n, port=True)
    assert got == want
    levels = [s[4][0] for s in got["summaries"] if s[4] is not None]
    assert any("generative" in lv for lv in levels)
    assert any(lv.startswith("L2:") for lv in levels)
    assert any(s[0] == "generated" for s in got["summaries"])
    assert got["stats"]["sharded_reads"] == 1


def test_service_replay_eight_positions_matches_reference(eight_device_reference):
    got = service_replay(8, port=True)
    assert json.loads(str(eight_device_reference["service|data8"])) == json.loads(json.dumps(got))


if __name__ == "__main__":
    # the 8-device reference run (see ``eight_device_reference``)
    import jax

    assert len(jax.devices()) == 8, jax.devices()
    out = run_all(_ref_ns(), EIGHT)
    out["service|data8"] = np.array(json.dumps(service_replay(8)))
    np.savez(sys.argv[1], **out)
