"""The port's lanes top-k (plain version on the CPU) against the reference
package's Pallas kernel (interpret mode) and its jnp oracle.

Scores agree within atol = rtol = 2e-5, the reference kernel tests' own
tolerance (float32 sums taken in another order); indices are equal wherever
the score is finite. The CUDA legs (kernel against plain on the card) are in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.similarity_topk.ops import similarity_topk_lanes as jax_lanes
from repro.kernels.similarity_topk.ref import similarity_topk_lanes_ref as jax_lanes_ref
from repro_torch.kernels import backend
from repro_torch.kernels.similarity_topk import kernel as tk
from repro_torch.kernels.similarity_topk import ops as tops
from repro_torch.kernels.similarity_topk import ref as tref

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)

SHAPES = [
    # (N, D, Q, k), as in tests/test_kernels_similarity.py
    (256, 64, 1, 4),
    (1024, 256, 4, 8),
    (2048, 768, 8, 4),
    (700, 128, 3, 5),  # ragged N: not a multiple of any tile
    (128, 32, 16, 16),
]


def _inputs(L, N, D, Q, seed, p_valid=0.9):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((L, N, D)).astype(np.float32)
    valid = rng.random((L, N)) < p_valid
    q = rng.standard_normal((Q, D)).astype(np.float32)
    return db, valid, q


def _port(db, valid, q, k, metric, prenormalized=False):
    s, i = tops.similarity_topk_lanes(
        torch.from_numpy(db), torch.from_numpy(valid), torch.from_numpy(q), k=k,
        metric=metric, prenormalized=prenormalized,
    )
    return s.numpy(), i.numpy()


def _assert_match(s_port, i_port, s_ref, i_ref):
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    np.testing.assert_allclose(s_port, s_ref, **TOL)
    finite = np.isfinite(s_ref)
    np.testing.assert_array_equal(i_port[finite], i_ref[finite])


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_lanes_match_jax_kernel_and_ref(shape, L):
    N, D, Q, k = shape
    metric = "cosine" if (SHAPES.index(shape) + L) % 2 else "dot"
    db, valid, q = _inputs(L, N, D, Q, seed=N + D + L)
    s, i = _port(db, valid, q, k, metric)
    assert s.shape == (Q, L, k) and i.shape == (Q, L, k)
    sj, ij = jax_lanes(jnp.asarray(db), jnp.asarray(valid), jnp.asarray(q), k=k, metric=metric)
    _assert_match(s, i, sj, ij)
    sr, ir = jax_lanes_ref(jnp.asarray(db), jnp.asarray(valid), jnp.asarray(q), k, metric)
    _assert_match(s, i, sr, ir)
    # the port's own oracle agrees too
    so, io = tref.similarity_topk_lanes_ref(
        torch.from_numpy(db), torch.from_numpy(valid), torch.from_numpy(q), k, metric
    )
    _assert_match(s, i, so.numpy(), io.numpy())


def test_all_invalid_lane_is_neg_inf():
    db, valid, q = _inputs(3, 300, 64, 4, seed=1)
    valid[1] = False
    s, i = _port(db, valid, q, 4, "cosine")
    assert np.isneginf(s[:, 1]).all()
    assert np.isfinite(s[:, [0, 2]]).all()
    sj, ij = jax_lanes(jnp.asarray(db), jnp.asarray(valid), jnp.asarray(q), k=4)
    _assert_match(s, i, sj, ij)


def test_mixed_cosine_dot_lanes():
    """Mixed banks score raw dots against unit cosine rows and rescale the
    cosine lanes by 1/|q|: true cosines there, raw dots elsewhere."""
    db, valid, q = _inputs(3, 500, 64, 5, seed=2)
    db[0] /= np.linalg.norm(db[0], axis=-1, keepdims=True)  # cosine lanes hold unit rows
    db[2] /= np.linalg.norm(db[2], axis=-1, keepdims=True)
    metric = ("cosine", "dot", "cosine")
    s, i = _port(db, valid, q, 4, metric, prenormalized=True)
    sj, ij = jax_lanes(jnp.asarray(db), jnp.asarray(valid), jnp.asarray(q), k=4,
                       metric=metric, prenormalized=True)
    _assert_match(s, i, sj, ij)
    assert np.abs(s[:, [0, 2]]).max() <= 1.0 + 1e-5
    assert np.abs(s[:, 1]).max() > 1.0  # raw dots of unnormalized rows


def test_exact_ties_break_to_lower_index():
    """Duplicated dyadic rows give bitwise-equal scores; ties break to the
    lower index in both packages."""
    rng = np.random.default_rng(3)
    base = rng.integers(-4, 5, size=(40, 16)).astype(np.float32) / 4
    db = np.concatenate([base, base, base])[None].repeat(2, 0)  # rows r, r+40, r+80 tie
    valid = np.ones(db.shape[:2], bool)
    valid[1, :40] = False  # lane 1: the first copy is gone, ties move up
    q = rng.integers(-4, 5, size=(6, 16)).astype(np.float32) / 4
    s, i = _port(db, valid, q, 6, "dot")
    sj, ij = jax_lanes(jnp.asarray(db), jnp.asarray(valid), jnp.asarray(q), k=6, metric="dot")
    np.testing.assert_array_equal(s, np.asarray(sj))
    np.testing.assert_array_equal(i, np.asarray(ij))
    # every score appears three times (twice in lane 1): equal scores are
    # listed by ascending index, and the best of lane 0 is a first copy
    tied = s[..., 1:] == s[..., :-1]
    assert tied.any()
    assert (i[..., 1:][tied] > i[..., :-1][tied]).all()
    assert (i[:, 0, 0] < 40).all() and (i[:, 1, 0] >= 40).all()


def test_fewer_valid_rows_than_k_fill_with_neg_inf():
    db, valid, q = _inputs(2, 200, 32, 3, seed=4)
    valid[0] = False
    valid[0, [7, 150]] = True
    s, i = _port(db, valid, q, 4, "dot")
    assert np.isfinite(s[:, 0, :2]).all() and np.isneginf(s[:, 0, 2:]).all()
    assert set(i[0, 0, :2]) == {7, 150}


def test_cpu_tensor_takes_plain_version_and_cuda_wrapper_refuses_it():
    db, valid, q = _inputs(2, 256, 32, 2, seed=5)
    args = (torch.from_numpy(db), torch.from_numpy(valid), torch.from_numpy(q), 4)
    before = tk.launches
    s1, i1 = tk.similarity_topk_lanes_blocks(*args)
    s2, i2 = tk.similarity_topk_lanes_plain(*args)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    assert tk.launches == before  # the plain version is no kernel launch
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.similarity_topk_lanes_cuda(*args)
    with pytest.raises(ValueError):
        tk.similarity_topk_lanes_plain(args[0], args[1], args[2], 257)  # k > N
    with pytest.raises(TypeError):
        tk.similarity_topk_lanes_plain(args[0].double(), args[1], args[2], 4)


def test_dispatch_counter_and_block_n():
    tops.reset_dispatch_count()
    db, valid, q = _inputs(1, 128, 32, 1, seed=6)
    _port(db, valid, q, 2, "cosine")
    _port(db, valid, q, 2, "dot")
    assert tops.dispatch_count() == 2
    # the CUDA kernel's tile, read from its source without building it
    assert tops.default_block_n() == 128


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert backend.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            backend.resolve_device(None)
    assert backend.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_single_store_similarity_topk_matches_pallas_interpret(shape, metric):
    """B2: ``ops.similarity_topk``, the single-store form (the lanes kernel
    at L = 1), against the reference's ``similarity_topk`` (Pallas
    ``similarity_topk_blocks`` in interpret mode), as
    ``tests/test_kernels_similarity.py`` calls it."""
    from repro.kernels.similarity_topk.ops import similarity_topk as jax_single

    N, D, Q, k = shape
    db, valid, q = _inputs(1, N, D, Q, seed=N + 7)
    db, valid = db[0], valid[0]
    before = tops.dispatch_count()
    s, i = tops.similarity_topk(torch.from_numpy(db), torch.from_numpy(valid),
                                torch.from_numpy(q), k=k, metric=metric)
    assert tops.dispatch_count() == before + 1 and s.shape == (Q, k)
    s2, i2 = jax_single(jnp.asarray(db), jnp.asarray(valid), jnp.asarray(q), k=k, metric=metric)
    np.testing.assert_allclose(s.numpy(), np.asarray(s2), **TOL)
    live = np.isfinite(np.asarray(s2))
    np.testing.assert_array_equal(i.numpy()[live], np.asarray(i2)[live])


def test_single_store_bfloat16_and_all_invalid():
    from repro.kernels.similarity_topk.ops import similarity_topk as jax_single

    db, valid, q = _inputs(1, 300, 64, 2, seed=3)
    s, _ = tops.similarity_topk(torch.from_numpy(db[0]).bfloat16(), torch.from_numpy(valid[0]),
                                torch.from_numpy(q), k=4)
    s2, _ = jax_single(jnp.asarray(db[0], jnp.bfloat16), jnp.asarray(valid[0]),
                       jnp.asarray(q), k=4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s2), **TOL)
    s, _ = tops.similarity_topk(torch.ones(256, 64), torch.zeros(256, dtype=torch.bool),
                                torch.ones(2, 64), k=4)
    assert torch.isneginf(s).all()


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_store_search_reads_through_the_single_store_form(metric):
    """``InMemoryVectorStore.search`` on the kernel path is one call of B2's
    wrapper over the store's lane (unit cosine rows, so ``prenormalized``),
    and finds what the plain search finds; a CPU store launches nothing."""
    from repro_torch.core.vector_store import InMemoryVectorStore

    db, _, q = _inputs(1, 200, 32, 3, seed=21)
    stores = [InMemoryVectorStore(32, capacity=256, metric=metric, use_pallas=p, device="cpu")
              for p in (True, False)]
    for store in stores:
        store.add_batch(db[0], [f"q{j}" for j in range(200)], [f"a{j}" for j in range(200)])
    tops.reset_single_store_launches()
    before = tops.dispatch_count()
    got = stores[0].search_batch(q, k=5)
    assert tops.dispatch_count() == before + 1 and tops.single_store_launches == 0
    want = stores[1].search_batch(q, k=5)
    for g, w in zip(got, want):
        assert [e.query for _, e in g] == [e.query for _, e in w]
        np.testing.assert_allclose([s for s, _ in g], [s for s, _ in w], **TOL)
    s, _ = tops.similarity_topk(torch.from_numpy(db[0]), torch.ones(200, dtype=torch.bool),
                                torch.from_numpy(q), k=5, metric=metric)
    np.testing.assert_allclose(s.numpy(), [[s for s, _ in g] for g in got], **TOL)


LANE_ROWS_CASES = [
    # (caps, N, D, Q, k, metric): a bank of width N, lane l holding caps[l] rows
    ((16, 64), 64, 32, 3, 4, "cosine"),
    ((100, 700, 256), 700, 128, 8, 5, "dot"),
    ((3, 40), 40, 16, 2, 6, "dot"),  # lane 0 holds fewer rows than k
    ((1, 128), 128, 64, 1, 1, "cosine"),
]


@pytest.mark.parametrize("case", LANE_ROWS_CASES)
def test_lane_rows_match_jax_reference(case):
    """``_similarity_topk_lanes(..., lane_rows=caps)`` over a bank whose rows
    past each lane's capacity are invalid (the StoreBank invariant) gives the
    reference's ``_similarity_topk_lanes`` result, which reads every row."""
    from repro.kernels.similarity_topk.ops import _similarity_topk_lanes as jax_core

    caps, N, D, Q, k, metric = case
    db, valid, q = _inputs(len(caps), N, D, Q, seed=sum(caps))
    for lane, cap in enumerate(caps):
        valid[lane, cap:] = False
    s, i = tops._similarity_topk_lanes(
        torch.from_numpy(db), torch.from_numpy(valid), torch.from_numpy(q), k=k,
        metric=(metric,), prenormalized=False, lane_rows=caps)
    sj, ij = jax_core(jnp.asarray(db), jnp.asarray(valid), jnp.asarray(q), k=k,
                      metric=(metric,), block_n=None, interpret=True, prenormalized=False)
    _assert_match(s.numpy(), i.numpy(), sj, ij)
    live = np.isfinite(s.numpy())  # [Q, L, k]
    held = np.broadcast_to(np.asarray(caps)[None, :, None], live.shape)
    assert (i.numpy()[live] < held[live]).all()


def test_plain_ignores_rows_past_lane_rows():
    """Rows at or past ``lane_rows[l]`` count as invalid even where ``valid``
    is True: the plain version equals itself on a mask that drops them, tail
    indices included, and no live candidate lies past a lane's rows."""
    caps = (5, 90, 200)
    db, valid, q = _inputs(3, 200, 32, 4, seed=31, p_valid=1.0)
    args = (torch.from_numpy(db), torch.from_numpy(valid), torch.from_numpy(q), 8)
    s, i = tk.similarity_topk_lanes_plain(*args, lane_rows=caps)
    masked = valid.copy()
    for lane, cap in enumerate(caps):
        masked[lane, cap:] = False
    s2, i2 = tk.similarity_topk_lanes_plain(args[0], torch.from_numpy(masked), args[2], 8)
    assert torch.equal(s, s2) and torch.equal(i, i2)
    # lane 0 holds 5 rows: 5 live candidates, then NEG at rows 5, 6, 7
    assert (s[0, :, :5] > tk.NEG).all() and (s[0, :, 5:] == tk.NEG).all()
    assert (i[0, :, 5:] == torch.tensor([5, 6, 7], dtype=torch.int32)).all()
    live = s > tk.NEG
    assert (i[live] < torch.tensor(caps)[:, None, None].expand_as(i)[live]).all()
    # the same through the device-dispatching wrapper on a CPU tensor
    s3, i3 = tk.similarity_topk_lanes_blocks(*args, lane_rows=caps)
    assert torch.equal(s, s3) and torch.equal(i, i3)


@pytest.mark.parametrize("lane_rows", [(0, 200, 200), (201, 1, 1), (10, 10)])
def test_lane_rows_outside_the_bank_are_refused(lane_rows):
    db, valid, q = _inputs(3, 200, 32, 2, seed=32)
    with pytest.raises(ValueError, match="lane_rows"):
        tk.similarity_topk_lanes_plain(torch.from_numpy(db), torch.from_numpy(valid),
                                       torch.from_numpy(q), 4, lane_rows=lane_rows)


@pytest.mark.parametrize("lane_rows", [
    (16384, 131072),  # the main path's bank: the L1 lane, then the L2 lane
    (131072, 131072),
    (131072,),  # B2's single store
    (700, 700, 700),
    (1, 129, 4097),
])
def test_split_plan_covers_each_lane_with_no_empty_range(lane_rows):
    per, first = tk.split_plan(lane_rows)
    assert len(per) == len(lane_rows) and len(first) == len(lane_rows) + 1 and first[0] == 0
    for lane, rows in enumerate(lane_rows):
        nb = first[lane + 1] - first[lane]
        starts = [b * per[lane] for b in range(nb)]
        ends = [min(rows, s + per[lane]) for s in starts]
        assert nb >= 1 and per[lane] % tk.ROW_ALIGN == 0
        assert all(e > s for s, e in zip(starts, ends))  # no empty range
        assert starts[0] == 0 and ends[-1] == rows
        assert all(e == s for e, s in zip(ends, starts[1:]))  # contiguous
    if sum(lane_rows) >= 2 * 131072:
        assert abs(first[-1] - tk.WAVES * tk.SMS) <= 4
    if lane_rows == (16384, 131072):
        # about one block per SM, shared by the rows each lane holds
        assert abs(first[-1] - 132) <= 4
        assert 13 <= first[1] <= 17


def test_route_follows_q_k_and_shared_memory():
    for Q in (1, 2, 3, 4, 8, 16):
        assert tk.route(Q, 768, 4) == "stream"
        ns = tk.stream_stages(Q, 768, 4)
        assert ns in tk.STAGES and tk.stream_smem(Q, 768, 4, ns) <= tk.SMEM_LIMIT
    assert tk.stream_rows(8) == 4 and tk.stream_rows(9) == 2
    assert tk.list_len(4) == 6 and tk.list_len(tk.KMAX) == tk.KMAX  # k and a margin
    assert tk.route(16, 768, tk.KMAX) == "stream"
    assert tk.route(17, 768, 4) == "tile" and tk.route(64, 768, 4) == "tile"
    assert tk.route(1, 768, tk.KMAX + 1) == "tile"  # larger k: the tile kernel
    assert tk.route(1, 16384, 4) == "tile"  # rows too wide for its ring
