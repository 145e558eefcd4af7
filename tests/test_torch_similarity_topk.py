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
