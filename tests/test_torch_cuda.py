"""CUDA legs of the port's tests: each Hopper kernel against its plain
version on the card (similarity_topk lanes B1 and its single-store form B2,
decode attention B3, flash attention B4 (with MLA's value width too), the
SSD chunked scan B5), the wrappers' refusals, the read path through the
kernel against the same read through the plain search, the MoE FFN's
routing on the card against the CPU's, and the serving engines (dense,
SSM and MoE) on the card against their CPU runs.

They import torch and the port only, never JAX, so they also run where
JAX is absent; ``tests/conftest.py`` imports JAX, hence ``--noconftest``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips. Scores agree within
atol = rtol = 2e-5 (float32 sums in another order); indices are equal
wherever the score belongs to a valid row. Attention outputs agree within
2e-5 in float32 and 2e-2 in bfloat16 (the reference kernel tests'). The
SSD scan agrees within 1e-4 in float32 (``tests/test_kernels_ssd.py``); in
bfloat16 its y within 2e-2 (one bfloat16 step of the same float32 sums in
another order) and its float32 state within 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import backend
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.similarity_topk import kernel as tk
from repro_torch.kernels.similarity_topk import ops as tops
from repro_torch.kernels.ssd_scan import kernel as sk

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


def _assert_kernel_matches_plain(db, valid, q, k, lane_rows=None):
    before = tk.launches
    s1, i1 = tk.similarity_topk_lanes_cuda(db, valid, q, k, lane_rows)
    s2, i2 = tk.similarity_topk_lanes_plain(db, valid, q, k, lane_rows)
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
    # lane_rows past the bank, missing a lane, or 0
    for rows in ((257, 256), (256,), (0, 256)):
        with pytest.raises(ValueError, match="lane_rows"):
            tk.similarity_topk_lanes_cuda(db, valid, q, 4, rows)
    # storage 4 bytes off a 16-byte boundary: no vector loads, no bulk copies
    flat = torch.empty(db.numel() + 4, device=dev)
    shifted = flat[1:1 + db.numel()].view(db.shape)
    shifted.copy_(db)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk.similarity_topk_lanes_cuda(shifted, valid, q, 4)
    with pytest.raises(ValueError, match="lanes"):
        many = torch.zeros((tk.MAX_LANES + 1, 16, 32), device=dev)
        tk.similarity_topk_lanes_cuda(many, torch.ones(many.shape[:2], dtype=torch.bool,
                                                       device=dev), q, 4)
    with pytest.raises(ValueError, match="tile kernel"):
        big = torch.zeros((1, 300, 32), device=dev)
        tk.similarity_topk_lanes_cuda(big, torch.ones((1, 300), dtype=torch.bool, device=dev),
                                      q, 129)
    assert tk.launches == before  # a refused call launches nothing


@pytest.mark.parametrize("k", [1, 4, 16, tk.KMAX, tk.KMAX + 1])
@pytest.mark.parametrize("Q", [1, 2, 3, 4, 8, 16, 17, 64])
def test_kernel_matches_plain_on_both_routes(Q, k, dev):
    """Both sides of the small-Q threshold (the streaming kernel at
    Q <= SMALL_Q and k <= KMAX, the tile kernel above) at the bank's width,
    with the main path's lane_rows form: lane 0 holds fewer rows than N and
    its rows past them are marked valid, which the kernel must not read."""
    db, valid, q = _inputs(2, 4096, 768, Q, Q * 100 + k, dev)
    _assert_kernel_matches_plain(db, valid, q, k, lane_rows=(1000, 4096))
    _assert_kernel_matches_plain(db, valid, q, k)


def test_stream_kernel_ties_across_blocks_invalid_lane_and_few_rows(dev):
    """Exact ties that fall in different blocks and warps (each dyadic row
    repeated one block and one warp stage apart), an all-invalid lane, a
    lane with fewer valid rows than k, and a lane holding fewer rows than k,
    all on the streaming route."""
    L, N, D, Q, k = 4, 4096, 64, 5, 8
    per = tk.split_plan((N,) * L)[0][0]
    rng = np.random.default_rng(12)
    db = rng.integers(-4, 5, size=(L, N, D)).astype(np.float32) / 4
    for r in range(0, 64):  # rows r, r + 16 and r + per hold the same vector
        db[:, r + 16] = db[:, r]
        db[:, r + per] = db[:, r]
    valid = rng.random((L, N)) < 0.9
    valid[1] = False  # an all-invalid lane
    valid[2] = False
    valid[2, [3, 3 + per, 2000]] = True  # fewer valid rows than k
    valid[3, :5] = True
    q = rng.integers(-4, 5, size=(Q, D)).astype(np.float32) / 4
    db, valid, q = (torch.from_numpy(a).to(dev) for a in (db, valid, q))
    assert tk.route(Q, D, k) == "stream"
    for rows in (None, (N, N, N, 5)):  # lane 3 holding 5 rows, fewer than k
        s, i = _assert_kernel_matches_plain(db, valid, q, k, lane_rows=rows)
        assert (s[1] == tk.NEG).all() and (s[2, :, 3:] == tk.NEG).all()
        tied = s[0, :, 1:] == s[0, :, :-1]
        assert tied.any() and (i[0, :, 1:][tied] > i[0, :, :-1][tied]).all()
    assert (s[3, :, 5:] == tk.NEG).all() and (i[3, :, 5:] == np.arange(5, 8)).all()


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


def test_single_store_form_launches_the_lanes_kernel_at_one_lane(dev):
    db, valid, q = _inputs(1, 700, 128, 3, 9, dev)
    before = (tk.launches, tops.single_store_launches)
    s, i = tops.similarity_topk(db[0], valid[0], q, k=5, metric="dot")
    assert (tk.launches, tops.single_store_launches) == (before[0] + 1, before[1] + 1)
    s2, i2 = tops._similarity_topk_lanes(db, valid, q, k=5, metric=("dot",),
                                         prenormalized=False,
                                         topk=tk.similarity_topk_lanes_plain)
    torch.cuda.synchronize()
    np.testing.assert_allclose(s.cpu().numpy(), s2[:, 0].cpu().numpy(), **TOL)
    np.testing.assert_array_equal(i.cpu().numpy(), i2[:, 0].cpu().numpy())


def test_store_search_launches_the_single_store_form(dev):
    """``InMemoryVectorStore.search`` on the kernel path: one B2 launch per
    search, the same candidates as the plain search on the card."""
    from repro_torch.core.vector_store import InMemoryVectorStore

    rng = np.random.default_rng(10)
    rows = rng.standard_normal((600, 128)).astype(np.float32)
    qs = rng.standard_normal((3, 128)).astype(np.float32)
    stores = [InMemoryVectorStore(128, capacity=1024, use_pallas=p, device=dev)
              for p in (True, False)]
    for store in stores:
        store.add_batch(rows, [f"q{j}" for j in range(600)], [f"a{j}" for j in range(600)])
    before = tops.single_store_launches
    got = stores[0].search_batch(qs, k=5)
    assert tops.single_store_launches == before + 1
    want = stores[1].search_batch(qs, k=5)
    for g, w in zip(got, want):
        assert [e.query for _, e in g] == [e.query for _, e in w]
        np.testing.assert_allclose([s for s, _ in g], [s for s, _ in w], **TOL)


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_CASES = [
    # B, S, H, KH, Dh, window, softcap
    (1, 32, 16, 16, 64, 0, 0.0),  # the engine's prefill
    (1, 100, 8, 2, 64, 0, 0.0),  # ragged S, GQA
    (2, 512, 4, 1, 64, 128, 50.0),  # MQA + window + softcap
    (1, 128, 4, 4, 128, 0, 30.0),
    (2, 77, 4, 2, 16, 7, 0.0),
    # the wide heads: zamba2's shared attention (Dh 224, G = 1), gemma3's
    # (Dh 256, G = 2, local layers windowed), and G = 4 at both
    (1, 32, 32, 32, 224, 0, 0.0),
    (2, 100, 8, 2, 224, 48, 30.0),
    (1, 300, 8, 4, 256, 128, 0.0),
    (2, 77, 8, 2, 256, 0, 50.0),
]
DECODE_CASES = [
    # B, S, H, KH, Dh, window, softcap, lengths
    (4, 256, 16, 16, 64, 0, 0.0, (1, 17, 256, 40)),  # the engine's decode
    (2, 512, 8, 2, 64, 0, 0.0, (256, 170)),
    (2, 512, 4, 1, 64, 128, 50.0, (1, 512)),
    (2, 300, 4, 4, 128, 0, 0.0, (0, 299)),
    (4, 256, 32, 32, 224, 0, 0.0, (1, 17, 256, 40)),  # zamba2-7b's engine decode
    (2, 300, 8, 2, 224, 100, 30.0, (1, 300)),
    (4, 256, 8, 4, 256, 0, 0.0, (1, 17, 256, 40)),  # gemma3-4b's engine decode
    (2, 512, 8, 2, 256, 128, 50.0, (0, 512)),
]


def _randn(shape, dt, dev, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, dt)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(case, dt, dev):
    B, S, H, KH, Dh, window, cap = case
    q = _randn((B, S, H, Dh), dt, dev, 0)
    k, v = _randn((B, S, KH, Dh), dt, dev, 1), _randn((B, S, KH, Dh), dt, dev, 2)
    before = fk.launches
    got = fk.flash_attention_cuda(q, k, v, window=window, softcap=cap)
    want = fk.flash_attention_plain(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fk.launches == before + 1 and got.dtype == dt
    tol = ATTN_TOL[dt]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(case, dt, dev):
    B, S, H, KH, Dh, window, cap, lens = case
    q = _randn((B, H, Dh), dt, dev, 3)
    k, v = _randn((B, S, KH, Dh), dt, dev, 4), _randn((B, S, KH, Dh), dt, dev, 5)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = dk.launches
    got = dk.decode_attention_cuda(q, k, v, lengths, window=window, softcap=cap)
    want = dk.decode_attention_plain(q, k, v, lengths, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert dk.launches == before + 1 and got.dtype == dt
    tol = ATTN_TOL[dt]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


FLASH_SWEEP = [
    # (window, softcap, causal)
    (0, 0.0, True),
    (48, 30.0, True),  # a window and a softcap
    (0, 0.0, False),
]


@pytest.mark.parametrize("variant", FLASH_SWEEP)
@pytest.mark.parametrize("S", [1, 63, 65, 100, 2048])
@pytest.mark.parametrize("Dh", fk.HEAD_DIMS)
def test_flash_tensor_core_kernel_matches_plain(Dh, S, variant, dev):
    """bf16 (the tensor-core kernel) at every head width, S around and past
    the 64-row tile, GQA."""
    window, cap, causal = variant
    q = _randn((1, S, 4, Dh), torch.bfloat16, dev, 10)
    k, v = (_randn((1, S, 2, Dh), torch.bfloat16, dev, s) for s in (11, 12))
    before = fk.launches
    got = fk.flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=cap)
    want = fk.flash_attention_plain(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fk.launches == before + 1 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)


def _decode_matches_plain(B, S, H, KH, Dh, lens, dt, dev, window=0, cap=0.0, seed=13):
    q = _randn((B, H, Dh), dt, dev, seed)
    k, v = _randn((B, S, KH, Dh), dt, dev, seed + 1), _randn((B, S, KH, Dh), dt, dev, seed + 2)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = dk.launches
    got = dk.decode_attention_cuda(q, k, v, lengths, window=window, softcap=cap)
    want = dk.decode_attention_plain(q, k, v, lengths, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert dk.launches == before + 1 and got.dtype == dt
    tol = ATTN_TOL[dt]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)
    return got


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_decode_lengths_at_split_boundaries(dt, dev):
    """Lengths ending exactly at a split boundary, one row before and after
    it; 0, 1 and S (8192); a window straddling a boundary. A second call
    gives the same output (the kernel reset its split counters)."""
    B, S, H, Dh = 4, 8192, 16, 64
    ns, rows = dk.split_plan(B, H, S, Dh, dt)
    assert ns > 1
    for lens, window in (((rows, rows - 1, rows + 1, 2 * rows), 0),
                         ((0, 1, S, S - 1), 0),
                         ((rows + 300, 2 * rows + 10, S, 1), 700)):
        got = _decode_matches_plain(B, S, H, H, Dh, lens, dt, dev, window=window)
        again = dk.decode_attention_cuda(*(_randn(shape, dt, dev, s) for shape, s in
                                           (((B, H, Dh), 13), ((B, S, H, Dh), 14),
                                            ((B, S, H, Dh), 15))),
                                         torch.tensor(lens, dtype=torch.int32, device=dev),
                                         window=window)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        if lens[0] == 0:
            assert (got[0] == 0).all()


@pytest.mark.parametrize("heads", [(16, 8), (16, 4), (16, 2), (8, 1), (6, 2), (16, 1)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_decode_head_groups_over_splits(heads, dt, dev):
    """GQA at G = 2, 4 and 8, MQA (G = 8 and G = 16, two head chunks) and a
    group of 3, over a split cache."""
    H, KH = heads
    assert dk.num_splits(2, KH, 4096, 64, dt) > 1
    _decode_matches_plain(2, 4096, H, KH, 64, (4096, 1234), dt, dev, cap=30.0)


@pytest.mark.parametrize("heads", [(8, 8), (8, 4), (8, 2)])
@pytest.mark.parametrize("Dh", [224, 256])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_decode_wide_heads_over_splits(dt, Dh, heads, dev):
    """Dh 224 and 256 at G = 1, 2 and 4 over a split [4, 8192] cache:
    lengths at a split boundary and one row either side of it, 1 and S, and
    a window across a boundary."""
    H, KH = heads
    B, S = 4, 8192
    ns, rows = dk.split_plan(B, KH, S, Dh, dt)
    assert ns > 1
    for lens, window, cap in (((rows, rows - 1, rows + 1, S), 0, 0.0),
                              ((1, S, rows + 300, 2 * rows + 10), 700, 30.0)):
        _decode_matches_plain(B, S, H, KH, Dh, lens, dt, dev, window=window, cap=cap)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = _randn((1, 16, 4, 64), torch.float32, dev, 6)
    k = _randn((1, 16, 2, 64), torch.float32, dev, 7)
    lengths = torch.tensor([5], dtype=torch.int32, device=dev)
    f0, d0 = fk.launches, dk.launches
    with pytest.raises(TypeError):
        fk.flash_attention_cuda(q.double(), k.double(), k.double())
    with pytest.raises(TypeError):
        fk.flash_attention_cuda(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="devices differ"):
        fk.flash_attention_cuda(q, k.cpu(), k)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk.flash_attention_cuda(q.cpu(), k.cpu(), k.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        fk.flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                k[..., :48].contiguous())
    with pytest.raises(ValueError, match="head_dim"):  # a width outside HEAD_DIMS
        dk.decode_attention_cuda(q[:, 0, :, :48].contiguous(), k[..., :48].contiguous(),
                                 k[..., :48].contiguous(), lengths)
    with pytest.raises(TypeError, match="int32"):
        dk.decode_attention_cuda(q[:, 0], k, k, lengths.long())
    with pytest.raises(TypeError):
        dk.decode_attention_cuda(q[:, 0].bfloat16(), k, k, lengths)
    with pytest.raises(ValueError, match="devices differ"):
        dk.decode_attention_cuda(q[:, 0], k, k, lengths.cpu())
    for dt in (torch.float32, torch.bfloat16):  # the decode kernel's 16-byte loads
        qd, kd = q[:, 0].to(dt), k.to(dt)
        with pytest.raises(ValueError, match="16-byte aligned"):
            dk.decode_attention_cuda(_misaligned(qd), kd, kd, lengths)
        with pytest.raises(ValueError, match="16-byte aligned"):
            dk.decode_attention_cuda(qd, kd, _misaligned(kd), lengths)
    qb, kb = q.bfloat16(), k.bfloat16()  # the tensor-core kernel's 16-byte copies
    with pytest.raises(ValueError, match="16-byte aligned"):
        fk.flash_attention_cuda(qb, _misaligned(kb), kb)
    fk.flash_attention_cuda(_misaligned(q), k, k)  # float32: the scalar kernel takes it
    torch.cuda.synchronize()
    f0 += 1
    assert (fk.launches, dk.launches) == (f0, d0)  # a refused call launches nothing


def test_engine_on_the_card_matches_its_cpu_run(dev):
    """The smoke model in float32 through the engine on the card (kernels)
    and on the CPU (plain versions): the same greedy tokens, and one flash
    launch per layer and prefill, one decode launch per layer and step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True), dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3, 17, 8, 11, 5)]
    outs = {}
    for d in ("cpu", "cuda"):
        p = _tree_to(params, dev) if d == "cuda" else params
        eng = ServingEngine(cfg, p, max_batch=2, max_seq=64, device=d)
        f0, d0 = fk.launches, dk.launches
        outs[d] = eng.generate(prompts, max_new_tokens=6)
        if d == "cuda":
            assert fk.launches - f0 == cfg.num_layers * len(prompts)
            assert dk.launches - d0 == cfg.num_layers * eng.metrics["decode_steps"]
    assert outs["cuda"] == outs["cpu"]


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


SSD_CASES = [
    # B, S, H, G, P, N, chunk
    (1, 32, 64, 1, 64, 128, 256),  # the engine's prefill (mamba2-1.3b, ngroups 1)
    (1, 300, 8, 1, 64, 128, 256),  # ragged: two chunks, the second partial
    (2, 256, 4, 4, 32, 64, 64),  # tests/test_kernels_ssd.py's cases, B/C per head
    (1, 128, 8, 8, 64, 32, 32),
    (2, 192, 2, 2, 16, 16, 64),
    (1, 64, 4, 4, 64, 128, 64),
    (2, 100, 8, 2, 32, 16, 32),  # groups of 4 heads, ragged
    (1, 70, 2, 1, 128, 64, 64),  # P = 128
    (1, 5, 4, 1, 16, 8, 64),  # shorter than one tile
    (1, 256, 8, 1, 64, 128, 256),  # S = L: the last one-chunk (one-launch) shape
    (1, 257, 8, 1, 64, 128, 256),  # S = L + 1: the first of more chunks (three launches)
    (1, 1, 8, 1, 64, 128, 256),  # S = 1
    (4, 32, 64, 1, 64, 128, 256),  # B = 4 at the engine's widths
    (1, 300, 112, 2, 64, 64, 256),  # zamba2-7b's widths (H = 112, G = 2, N = 64)
    (1, 2048, 64, 1, 64, 128, 256),  # the long prefill: 8 chunks, G = 1
    (2, 200, 4, 2, 16, 8, 64),  # P = 16 and N = 8 over several chunks
    (1, 90, 4, 1, 16, 24, 32),  # N = 24: not a multiple of the 16-wide k step
]


def _ssd_inputs(B, S, H, G, P, N, dt_, dev, seed=9):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32)).to(dev, dt_)
    Bm, Cm = (torch.from_numpy((rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32))
              .to(dev, dt_) for _ in "BC")
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((B, S, H)) - 1.0, 0.0)
                          .astype(np.float32)).to(dev)
    A = torch.from_numpy((-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)).to(dev)
    D = torch.from_numpy(rng.standard_normal(H).astype(np.float32)).to(dev)
    return x, Bm, Cm, dt, A, D


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dt_", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(case, dt_, dev):
    B, S, H, G, P, N, chunk = case
    args = _ssd_inputs(B, S, H, G, P, N, dt_, dev)
    before = sk.launches
    y1, st1 = sk.ssd_scan_cuda(*args, chunk=chunk)
    y2, st2 = sk.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.launches == before + 1 and y1.dtype == dt_ and st1.dtype == torch.float32
    tol = 1e-4 if dt_ == torch.float32 else 2e-2
    np.testing.assert_allclose(y1.float().cpu().numpy(), y2.float().cpu().numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(st1.cpu().numpy(), st2.cpu().numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", [(1, 32, 64, 1, 64, 128, 256), (1, 600, 8, 2, 64, 128, 256),
                                  (2, 200, 4, 2, 16, 8, 64)])
@pytest.mark.parametrize("dt_", [torch.float32, torch.bfloat16])
def test_ssd_kernel_is_bitwise_repeatable(case, dt_, dev):
    """No atomics, no order that depends on timing: two calls on the same
    inputs give bitwise-equal y and state, one chunk or several."""
    B, S, H, G, P, N, chunk = case
    args = _ssd_inputs(B, S, H, G, P, N, dt_, dev, seed=11)
    y1, st1 = sk.ssd_scan_cuda(*args, chunk=chunk)
    y2, st2 = sk.ssd_scan_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(st1, st2)


def test_ssd_kernel_workspace_matches_the_planner(dev):
    """The source's workspace layout is the one ``kernel.workspace_bytes``
    allocates."""
    lib = sk.LIB.load()
    for dt_, code in sk.DTYPES.items():
        for B, S, H, P, N, L in ((1, 2048, 64, 64, 128, 256), (2, 300, 6, 16, 24, 64)):
            assert lib.ssd_scan_workspace_bytes(code, B, S, H, P, N, L) == sk.workspace_bytes(
                dt_, B, S, H, P, N, L)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, Bm, Cm, dt, A, D = _ssd_inputs(1, 16, 4, 1, 64, 32, torch.float32, dev)
    s0 = sk.launches
    with pytest.raises(TypeError, match="dtypes"):
        sk.ssd_scan_cuda(x, Bm.bfloat16(), Cm, dt, A, D)
    with pytest.raises(TypeError, match="dtypes"):
        sk.ssd_scan_cuda(x.double(), Bm.double(), Cm.double(), dt, A, D)
    with pytest.raises(TypeError, match="float32"):
        sk.ssd_scan_cuda(x, Bm, Cm, dt.bfloat16(), A, D)
    with pytest.raises(ValueError, match="devices differ"):
        sk.ssd_scan_cuda(x, Bm, Cm, dt.cpu(), A, D)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.ssd_scan_cuda(*(t.cpu() for t in (x, Bm, Cm, dt, A, D)))
    with pytest.raises(ValueError, match="contiguous"):
        sk.ssd_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), Bm, Cm, dt, A, D)
    with pytest.raises(ValueError, match="head width"):
        sk.ssd_scan_cuda(x[..., :48].contiguous(), Bm, Cm, dt, A, D)
    big = torch.zeros((1, 16, 1, 1024), device=dev)
    with pytest.raises(RuntimeError, match="shared memory"):
        sk.ssd_scan_cuda(x, big, big, dt, A, D)
    assert sk.launches == s0  # a refused call launches nothing


def test_ssm_engine_on_the_card_matches_its_cpu_run(dev):
    """The mamba2 smoke model in float32 through the engine on the card (the
    SSD kernel) and on the CPU (its plain version): the same greedy tokens,
    one scan launch per layer and prefill, none in a decode step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True), dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (1, 40, 2, 7, 11)]
    outs = {}
    for d in ("cpu", "cuda"):
        p = _tree_to(params, dev) if d == "cuda" else params
        eng = ServingEngine(cfg, p, max_batch=2, max_seq=64, device=d)
        s0 = sk.launches
        outs[d] = eng.generate(prompts, max_new_tokens=6)
        if d == "cuda":
            assert sk.launches - s0 == cfg.num_layers * len(prompts)
    assert outs["cuda"] == outs["cpu"]


# B4 with its own value width: MLA's prefill, q/k 192 and v 128 (H = KH)
FLASH_PAIR_CASES = [
    # B, S, H, KH, window, softcap, causal
    (1, 32, 128, 128, 0, 0.0, True),  # deepseek-v3's engine prefill
    (1, 1, 4, 4, 0, 0.0, True),
    (2, 63, 4, 4, 0, 0.0, True),
    (1, 100, 8, 8, 0, 0.0, True),  # ragged S
    (1, 2048, 8, 8, 0, 0.0, True),
    (2, 77, 8, 2, 48, 30.0, True),  # GQA, window and softcap
    (1, 65, 4, 4, 0, 0.0, False),
]


@pytest.mark.parametrize("case", FLASH_PAIR_CASES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_value_width_matches_plain(case, dt, dev):
    B, S, H, KH, window, cap, causal = case
    q = _randn((B, S, H, 192), dt, dev, 20)
    k, v = _randn((B, S, KH, 192), dt, dev, 21), _randn((B, S, KH, 128), dt, dev, 22)
    before = fk.launches
    got = fk.flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=cap,
                                  scale=192 ** -0.5)
    want = fk.flash_attention_plain(q, k, v, causal=causal, window=window, softcap=cap,
                                    scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert fk.launches == before + 1 and got.dtype == dt and got.shape == (B, S, H, 128)
    tol = ATTN_TOL[dt]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("S", [32, 300, 2048])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_at_llama4_shapes_matches_plain(S, dt, dev):
    """llama4-scout's prefill: H 40 over KH 8 (G = 5), Dh 128, the local
    layers' window of 8192."""
    q = _randn((1, S, 40, 128), dt, dev, 23)
    k, v = _randn((1, S, 8, 128), dt, dev, 24), _randn((1, S, 8, 128), dt, dev, 25)
    got = fk.flash_attention_cuda(q, k, v, window=8192)
    want = fk.flash_attention_plain(q, k, v, window=8192)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dt]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(4, 256, (1, 17, 256, 40)),
                                   (4, 9000, (9000, 8193, 100, 1))])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_decode_at_llama4_shapes_matches_plain(shape, dt, dev):
    """llama4-scout's decode: H 40 over KH 8 (G = 5, rounded up to an
    8-head block), Dh 128, a window of 8192 (biting past 8192 rows)."""
    B, S, lens = shape
    _decode_matches_plain(B, S, 40, 8, 128, lens, dt, dev, window=8192)


def test_flash_refuses_a_width_pair_it_is_not_built_for(dev):
    q, k = _randn((1, 16, 4, 128), torch.bfloat16, dev, 26), _randn((1, 16, 4, 128),
                                                                     torch.bfloat16, dev, 27)
    f0 = fk.launches
    with pytest.raises(ValueError, match="head_dim pair"):
        fk.flash_attention_cuda(q, k, k[..., :64].contiguous())
    assert fk.launches == f0


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v3-671b"])
def test_moe_routes_on_the_card_as_on_the_cpu(arch, dev):
    """The MoE FFN at the smoke widths in float32 (TF32 off), one layer with
    a nonzero router bias, on the card and on the CPU: the same expert ids
    wherever the CPU's gap between the k-th and the (k+1)-th routing score
    exceeds 1e-4, the same drop fraction, outputs within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    if "router_bias" in params:
        params["router_bias"] = 0.1 * torch.randn(cfg.moe.num_experts,
                                                  generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    y_cpu, m_cpu = moe.moe_ffn(params, cfg, x)
    idx_cpu, _ = moe._route(params, cfg, x.reshape(80, -1))
    p_dev = {k: v.to(dev) for k, v in params.items()}
    y_dev, m_dev = moe.moe_ffn(p_dev, cfg, x.to(dev))
    idx_dev, _ = moe._route(p_dev, cfg, x.to(dev).reshape(80, -1))
    logits = x.reshape(80, -1) @ params["router"]
    scores = torch.sigmoid(logits) + params["router_bias"] if "router_bias" in params \
        else torch.softmax(logits, -1)
    top = torch.sort(scores, -1, descending=True).values
    k = cfg.moe.top_k
    decided = (top[:, k - 1] - top[:, k]) > 1e-4
    assert torch.equal(idx_dev.cpu()[decided], idx_cpu[decided])
    assert float(m_dev["moe_drop_fraction"]) == float(m_cpu["moe_drop_fraction"])
    np.testing.assert_allclose(y_dev.cpu().numpy(), y_cpu.numpy(), atol=1e-4, rtol=1e-4)


def test_moe_engine_on_the_card_matches_its_cpu_run(dev):
    """The llama4-scout smoke model (MoE, GQA) in float32 through the engine
    on the card and on the CPU: the same greedy tokens, one flash launch per
    layer and prefill, one decode launch per layer and step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e", smoke=True), dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 1, 7, 2, 11)]
    outs = {}
    for d in ("cpu", "cuda"):
        p = _tree_to(params, dev) if d == "cuda" else params
        eng = ServingEngine(cfg, p, max_batch=2, max_seq=64, device=d)
        f0, d0 = fk.launches, dk.launches
        outs[d] = eng.generate(prompts, max_new_tokens=6)
        if d == "cuda":
            assert fk.launches - f0 == cfg.num_layers * len(prompts)
            assert dk.launches - d0 == cfg.num_layers * eng.metrics["decode_steps"]
    assert outs["cuda"] == outs["cpu"]


def _sharded_read_pair(d, metric, lifecycle, n=8, cap=8 * 320, dim=64):
    """Replicated L1 + an 8-position sharded L2 on device ``d``, filled from
    one seed: dyadic rows under dot (every score exact), Gaussian under
    cosine. ``lifecycle`` stamps TTLs and a staleness weight."""
    from repro_torch.core.vector_store import InMemoryVectorStore
    from repro_torch.distributed.sharded_read import ShardedReadBank
    from repro_torch.distributed.sharded_store import ShardedVectorStore
    from repro_torch.launch.mesh import make_cache_mesh

    rng = np.random.default_rng(23)

    def rows(m):
        if metric == "dot":
            return rng.integers(0, 5, size=(m, dim)).astype(np.float32) / 4
        return rng.standard_normal((m, dim)).astype(np.float32)

    mesh = make_cache_mesh(n, device=d)
    rep = InMemoryVectorStore(dim, 300, metric, use_pallas=True, device=d)
    sh = ShardedVectorStore(mesh, dim, cap, k=4, metric=metric, use_pallas=True,
                            staleness_weight=0.25 if lifecycle else 0.0)
    r1, r2 = rows(280), rows(cap - 200)
    rep.add_batch(r1, [f"l1q{i}" for i in range(280)], [f"l1a{i}" for i in range(280)])
    ttls = [30.0 if (lifecycle and i % 3 == 0) else None for i in range(len(r2))]
    sh.add_batch(r2, [f"l2q{i}" for i in range(len(r2))], [f"l2a{i}" for i in range(len(r2))],
                 ttls=ttls)
    return rep, sh, ShardedReadBank(mesh, [("rep", rep), ("sh", sh)]), np.concatenate([
        r1[:3], r2[5:10], rows(4)])


@pytest.mark.parametrize("route,metric", [("kernel", "dot"), ("lifecycle", "dot"),
                                          ("kernel", "cosine")])
def test_sharded_read_on_the_card_matches_the_cpu(route, metric, dev, monkeypatch):
    """A read at 8 positions on the card against the same read on the CPU:
    the kernel route (B1 over the hot lanes and B2 at each position) and
    the lifecycle route (TTLs and a staleness penalty before the top-k on
    L2, which takes the plain route; L1 has no lifecycle and keeps B1).
    Decisions, global ids and counter deltas are equal; scores
    too under dot (dyadic rows), within 2e-5 under cosine."""
    from repro_torch.core.read_path import LevelSpec
    from repro_torch.core.store_bank import StoreBank

    lifecycle = route == "lifecycle"
    clock = [100.0]
    monkeypatch.setattr(StoreBank, "rel_now", staticmethod(lambda: clock[0]))
    t_single, t_comb, t_s = (22.0, 60.0, 20.0) if metric == "dot" else (0.5, 1.2, 0.9)
    specs = (LevelSpec(False, True, 0.0, float("inf"), 0, 4),
             LevelSpec(True, True, t_single, t_comb, 4, 4))
    got = []
    for d in (dev, torch.device("cpu")):
        clock[0] = 100.0
        rep, sh, srb, q = _sharded_read_pair(d, metric, lifecycle)
        clock[0] = 115.0
        thr = np.full((len(q), 2), t_s, np.float32)
        thr[-4:] = 1e6  # the fresh rows cannot hit semantically
        assert srb.lifecycle_active() == lifecycle
        before = [b.counters_host()[:2] for b in srb.banks()]
        launches = (tk.launches, tops.single_store_launches)
        dec = srb.fused_read(None, [None] * len(q), thr, specs, vecs=q,
                             shard_mask=np.arange(8) != 3)
        spent = (tk.launches - launches[0], tops.single_store_launches - launches[1])
        on_card = d.type == "cuda"
        # B1 + B2 x 7 live positions; on the lifecycle route B1 alone
        assert spent == (((1, 0) if lifecycle else (8, 7)) if on_card else (0, 0))
        after = [b.counters_host()[:2] for b in srb.banks()]
        deltas = [[a - b for a, b in zip(x, y)] for x, y in zip(after, before)]
        got.append((dec, deltas))
    (dk, ck), (dp, cp) = got
    for name in ("winner", "hit", "generative"):
        np.testing.assert_array_equal(getattr(dk, name), getattr(dp, name))
    live = np.isfinite(dp.scores)
    np.testing.assert_array_equal(np.isfinite(dk.scores), live)
    np.testing.assert_array_equal(dk.idx[live], dp.idx[live])
    if metric == "dot":
        np.testing.assert_array_equal(dk.scores, dp.scores)
    else:
        np.testing.assert_allclose(dk.scores[live], dp.scores[live], **TOL)
    for a, b in zip(ck, cp):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert (dk.winner < 2).any() and dk.hit.shape == (len(dk.winner), 2)
