"""CUDA legs of the port's tests: the Hopper similarity_topk kernel against
its plain version on the card, and the read path through the kernel against
the same read through the plain search.

They import torch and the port only, never JAX, so they also run where
JAX is absent; ``tests/conftest.py`` imports JAX, hence ``--noconftest``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips. Scores agree within
atol = rtol = 2e-5 (float32 sums in another order); indices are equal
wherever the score belongs to a valid row.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import backend
from repro_torch.kernels.similarity_topk import kernel as tk
from repro_torch.kernels.similarity_topk import ops as tops

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = dict(atol=2e-5, rtol=2e-5)

SHAPES = [
    # (N, D, Q, k), as in tests/test_kernels_similarity.py
    (256, 64, 1, 4),
    (1024, 256, 4, 8),
    (2048, 768, 8, 4),
    (700, 128, 3, 5),  # ragged N: not a multiple of the kernel's tile
    (128, 32, 16, 16),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100)")
    backend.full_fp32()
    return torch.device("cuda")


def _inputs(L, N, D, Q, seed, dev, p_valid=0.9):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((L, N, D)).astype(np.float32)
    valid = rng.random((L, N)) < p_valid
    q = rng.standard_normal((Q, D)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (db, valid, q))


def _assert_kernel_matches_plain(db, valid, q, k):
    before = tk.launches
    s1, i1 = tk.similarity_topk_lanes_cuda(db, valid, q, k)
    s2, i2 = tk.similarity_topk_lanes_plain(db, valid, q, k)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    s1, i1, s2, i2 = (t.cpu().numpy() for t in (s1, i1, s2, i2))
    np.testing.assert_allclose(s1, s2, **TOL)
    live = s2 > -1e38
    np.testing.assert_array_equal(i1[live], i2[live])
    return s1, i1


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(shape, dev):
    N, D, Q, k = shape
    _assert_kernel_matches_plain(*_inputs(3, N, D, Q, N, dev), k)


def test_kernel_ties_break_to_lower_index_and_invalid_lane(dev):
    rng = np.random.default_rng(3)
    base = rng.integers(-4, 5, size=(40, 16)).astype(np.float32) / 4
    db = np.concatenate([base, base, base])[None].repeat(3, 0)  # rows r, r+40, r+80 tie
    valid = np.ones(db.shape[:2], bool)
    valid[1, :40] = False
    valid[2] = False  # an all-invalid lane
    q = rng.integers(-4, 5, size=(6, 16)).astype(np.float32) / 4
    db, valid, q = (torch.from_numpy(a).to(dev) for a in (db, valid, q))
    s, i = _assert_kernel_matches_plain(db, valid, q, 6)
    assert (s[2] == tk.NEG).all()
    tied = s[:2, :, 1:] == s[:2, :, :-1]
    assert tied.any() and (i[:2, :, 1:][tied] > i[:2, :, :-1][tied]).all()
    # through the wrapper the sentinel becomes -inf
    so, _ = tops.similarity_topk_lanes(db, valid, q, k=6, metric="dot")
    assert torch.isneginf(so[:, 2]).all() and torch.isfinite(so[:, :2]).all()


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    db, valid, q = _inputs(2, 256, 32, 4, 5, dev)
    before = tk.launches
    with pytest.raises(TypeError):
        tk.similarity_topk_lanes_cuda(db.double(), valid, q, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tk.similarity_topk_lanes_cuda(db, valid, q.t().contiguous().t(), 4)
    with pytest.raises(ValueError, match="devices differ"):
        tk.similarity_topk_lanes_cuda(db, valid, q.cpu(), 4)
    assert tk.launches == before  # a refused call launches nothing


def test_read_path_through_kernel_matches_plain_search(dev):
    """The fused read on the card with the kernel (``use_pallas=True``) and
    with the plain search: dyadic dot-metric vectors make every score exact,
    so decisions, indices and counters are bitwise equal, and the kernel
    path launches the kernel once per read."""
    import repro_torch.core as T
    from repro_torch.core import read_path as trp

    dim, caps = 16, (16, 32, 24)

    def hierarchy(use_pallas):
        rng = np.random.default_rng(7)
        emb = T.NgramHashEmbedder(dim)
        levels = []
        for li, cap in enumerate(caps):
            c = T.GenerativeCache(emb, threshold=9.0, t_single=5.0, t_combined=16.0,
                                  capacity=cap, metric="dot", use_pallas=use_pallas,
                                  max_sources=4, device=dev)
            n = cap - 3
            vecs = rng.integers(0, 5, size=(n, dim)).astype(np.float32) / 4
            c.insert_batch([f"L{li}q{i}" for i in range(n)],
                           [f"L{li}a{i}" for i in range(n)], vecs=vecs)
            levels.append(c)
        h = T.HierarchicalCache(levels[0], levels[1], peers=[levels[2]])
        h.ensure_bank()
        return h

    rng = np.random.default_rng(11)
    texts = [f"probe {i}" for i in range(12)]
    qv = rng.integers(0, 5, size=(12, dim)).astype(np.float32) / 4
    thr = np.full((12, len(caps)), 9.0)
    thr[::3] = 7.5
    hk, hp = hierarchy(True), hierarchy(False)
    decisions = []
    for h in (hk, hp):
        bank = h._shared_bank
        specs = [trp.level_spec(c, c.max_sources) for _, c in h._levels()]
        before = tk.launches
        decisions.append(trp.fused_read(bank, h.l1.embedder, texts, thr, specs, vecs=qv))
        assert tk.launches - before == (1 if bank.use_pallas else 0)
    dk, dp = decisions
    for name in ("winner", "hit", "generative", "scores", "vecs"):
        np.testing.assert_array_equal(getattr(dk, name), getattr(dp, name))
    live = np.isfinite(dp.scores)
    np.testing.assert_array_equal(dk.idx[live], dp.idx[live])
    assert (dk.winner == len(caps)).any() and (dk.winner < len(caps)).any()
    for a, b in zip(hk._shared_bank.counters_host(), hp._shared_bank.counters_host()):
        np.testing.assert_array_equal(a, b)
