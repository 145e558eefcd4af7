"""The SSD chunked scan's plain version (the CPU side of kernel B5) against
the reference: the Pallas ``ssd_scan`` in interpret mode and the jnp oracle
``ssd_scan_ref`` on every case of ``tests/test_kernels_ssd.py``, in float32
(1e-4) and bfloat16 (5e-2), the reference tests' tolerances. Then a ragged
S (zero-padded in the reference, masked by the port), B/C groups shared by
several heads against the reference's repeated layout, chunk-size
invariance, the step-by-step recurrence in float64 and each batch row's
independence. Inputs are made with
numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan import kernel as sk
from repro_torch.kernels.ssd_scan import ops

torch.set_num_threads(1)

CASES = [
    # B, S, H, P, N, chunk (tests/test_kernels_ssd.py)
    (2, 256, 4, 32, 64, 64),
    (1, 128, 8, 64, 32, 32),
    (2, 192, 2, 16, 16, 64),
    (1, 64, 4, 64, 128, 64),
]
TOL = {np.float32: 1e-4, "bfloat16": 5e-2}


def _inputs(B, S, H, P, N, seed=0, G=None):
    """x, Bm, Cm, dt (post-softplus), A (< 0), D as numpy float32; Bm/Cm
    carry G groups (G = H by default, the reference's layout)."""
    rng = np.random.default_rng(seed)
    G = H if G is None else G
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)) - 1.0, 0.0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return x, Bm, Cm, dt, A, D


def _torch(arrays, bf16=False):
    x, Bm, Cm, dt, A, D = (torch.from_numpy(a) for a in arrays)
    if bf16:
        x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    return x, Bm, Cm, dt, A, D


def _jax(arrays, bf16=False):
    x, Bm, Cm, dt, A, D = (jnp.asarray(a) for a in arrays)
    if bf16:
        x, Bm, Cm = x.astype(jnp.bfloat16), Bm.astype(jnp.bfloat16), Cm.astype(jnp.bfloat16)
    return x, Bm, Cm, dt, A, D


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_ref(case, dtype):
    B, S, H, P, N, chunk = case
    bf16 = dtype == "bfloat16"
    arrays = _inputs(B, S, H, P, N, seed=S)
    y, st = sk.ssd_scan_plain(*_torch(arrays, bf16), chunk=chunk)
    assert y.dtype == (torch.bfloat16 if bf16 else torch.float32) and st.dtype == torch.float32
    assert tuple(st.shape) == (B, H, P, N)
    tol = TOL["bfloat16" if bf16 else np.float32]
    y_k, st_k = j_ssd_scan(*_jax(arrays, bf16), chunk=chunk, interpret=True)
    y_r, st_r = ssd_scan_ref(*_jax(arrays, bf16), chunk)
    for want_y, want_st in ((y_k, st_k), (y_r, st_r)):
        _close(y, want_y, tol)
        _close(st, want_st, tol)


@pytest.mark.parametrize("S,chunk", [(40, 32), (300, 256), (5, 64)])
def test_ragged_length_matches_zero_padded_reference(S, chunk):
    """S not a multiple of the chunk: the reference zero-pads with dt = 0."""
    arrays = _inputs(2, S, 4, 16, 8, seed=S)
    y, st = ops.ssd_scan(*_torch(arrays), chunk=chunk)
    y_r, st_r = ssd_scan_ref(*_jax(arrays), chunk)
    assert tuple(y.shape) == (2, S, 4, 16)
    _close(y, y_r, 1e-4)
    _close(st, st_r, 1e-4)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groups_match_the_repeated_reference_layout(G, dtype):
    """Bm/Cm with G groups of H // G heads each give what the reference
    computes on the groups repeated to H heads (``models/ssm.py``
    ``_split_xbc``)."""
    bf16 = dtype == "bfloat16"
    H = 4
    x, Bm, Cm, dt, A, D = _inputs(1, 96, H, 32, 16, seed=11, G=G)
    y, st = sk.ssd_scan_plain(*_torch((x, Bm, Cm, dt, A, D), bf16), chunk=32)
    rep = (np.repeat(Bm, H // G, axis=2), np.repeat(Cm, H // G, axis=2))
    y_r, st_r = ssd_scan_ref(*_jax((x, *rep, dt, A, D), bf16), 32)
    tol = TOL["bfloat16" if bf16 else np.float32]
    _close(y, y_r, tol)
    _close(st, st_r, tol)


def test_chunk_size_invariance():
    arrays = _torch(_inputs(1, 128, 2, 16, 16))
    y32, st32 = ops.ssd_scan(*arrays, chunk=32)
    y128, st128 = ops.ssd_scan(*arrays, chunk=128)
    np.testing.assert_allclose(y32.numpy(), y128.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st32.numpy(), st128.numpy(), atol=1e-4, rtol=1e-4)


def test_matches_naive_recurrence():
    """The step-by-step SSM recurrence in float64."""
    B, S, H, P, N = 1, 48, 2, 8, 12
    x, Bm, Cm, dt, A, D = _inputs(B, S, H, P, N, seed=7)
    y_k, st_k = ops.ssd_scan(*_torch((x, Bm, Cm, dt, A, D)), chunk=16)
    h = np.zeros((B, H, P, N))
    xs, Bs, Cs, dts, An, Dn = (a.astype(np.float64) for a in (x, Bm, Cm, dt, A, D))
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        decay = np.exp(dts[:, t] * An)
        h = h * decay[:, :, None, None] + np.einsum("bhn,bhp,bh->bhpn", Bs[:, t], xs[:, t],
                                                    dts[:, t])
        ys[:, t] = np.einsum("bhn,bhpn->bhp", Cs[:, t], h) + Dn[None, :, None] * xs[:, t]
    np.testing.assert_allclose(y_k.numpy(), ys, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(st_k.numpy(), h, atol=1e-3, rtol=1e-3)


def test_cpu_tensors_take_the_plain_version_and_the_cuda_wrapper_refuses_them():
    arrays = _torch(_inputs(1, 16, 2, 16, 8))
    sk.reset_launches()
    ops.ssd_scan(*arrays, chunk=8)
    assert sk.launches == 0 and not sk.LIB.loaded
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.ssd_scan_cuda(*arrays, chunk=8)
    x, Bm, Cm, dt, A, D = arrays
    with pytest.raises(ValueError, match="shapes"):
        ops.ssd_scan(x, Bm[:, :, :1].repeat(1, 1, 3, 1), Cm[:, :, :1].repeat(1, 1, 3, 1),
                     dt, A, D, chunk=8)  # 3 groups do not divide 2 heads
    with pytest.raises(TypeError, match="dtypes"):
        ops.ssd_scan(x.bfloat16(), Bm, Cm, dt, A, D, chunk=8)
    assert sk.launches == 0


def test_each_batch_row_is_its_own_scan():
    """A batch of rows with ragged content gives each row's batch-1 result:
    no state or cumsum leaks across the batch axis."""
    x, Bm, Cm, dt, A, D = _torch(_inputs(3, 40, 4, 16, 8, seed=5, G=2))
    y, st = ops.ssd_scan(x, Bm, Cm, dt, A, D, chunk=16)
    for b in range(3):
        y_b, st_b = ops.ssd_scan(x[b:b + 1], Bm[b:b + 1], Cm[b:b + 1], dt[b:b + 1], A, D,
                                 chunk=16)
        np.testing.assert_allclose(y[b:b + 1].numpy(), y_b.numpy(), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(st[b:b + 1].numpy(), st_b.numpy(), atol=1e-6, rtol=1e-6)


# -- the CUDA kernel's algorithm, rehearsed on the CPU -------------------------
# The kernel (csrc/ssd_scan.cu) cannot run here, so its four phases are
# written out below in plain torch: C B^T per B/C group and chunk, each
# chunk's own state contribution, the state passed across chunks, and each
# chunk's outputs from its starting state. With ``split`` the products take
# the kernel's bf16 parts: an input of float32 3 parts and of bfloat16 1, a
# float32 operand (the scores, the carried state, x w) 3 or 2 parts, and of
# the products of parts those whose indices sum below the larger count.

REHEARSAL_CASES = [
    # B, S, H, G, P, N, chunk: the reference cases with their G = H layout,
    # ragged S, and G in {1, 2, H}
    *[(B, S, H, H, P, N, chunk) for B, S, H, P, N, chunk in CASES],
    (2, 100, 4, 1, 16, 8, 32),
    (1, 77, 4, 2, 32, 16, 32),
    (2, 40, 4, 4, 16, 16, 16),
    (1, 33, 8, 2, 16, 32, 32),  # one step past a chunk
    (1, 7, 2, 1, 16, 8, 64),  # shorter than one chunk
]


def _parts(v, n):
    """``v`` rounded to float32, as bf16 parts (float64 tensors) summing to it."""
    r = v.to(torch.float32).to(torch.float64)
    out = []
    for _ in range(n):
        p = r.to(torch.bfloat16).to(torch.float64)
        out.append(p)
        r = r - p
    return out


def _product(eq, a, b, na, nb):
    """einsum ``eq`` of a and b in float64, with each operand in ``na``/``nb``
    bf16 parts (0: exact) and the kernel's choice of part products."""
    if not na:
        return torch.einsum(eq, a, b)
    pa, pb = _parts(a, na), _parts(b, nb)
    return sum(torch.einsum(eq, pa[i], pb[j])
               for i in range(na) for j in range(nb) if i + j < max(na, nb))


def _four_phases(x, Bm, Cm, dt, A, D, chunk, split=False):
    """The kernel's algorithm in float64: (y, final state)."""
    f = torch.float64
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    n_in, n_f = ((3, 3) if x.dtype == torch.float32 else (1, 2)) if split else (0, 0)
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    xf, Bf, Cf, dtf = (torch.nn.functional.pad(t.to(f), (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, Bm, Cm, dt))
    xc = xf.reshape(Bsz, nc, L, H, P)
    Bc, Cc = Bf.reshape(Bsz, nc, L, G, N), Cf.reshape(Bsz, nc, L, G, N)
    dtc = dtf.reshape(Bsz, nc, L, H)
    cs = torch.cumsum(dtc * A.to(f), dim=2)  # [B, nc, L, H]
    last = cs[:, :, -1]  # padded steps have dt = 0: the last live step's cs
    rep = H // G
    # 1: C B^T, once per group and chunk
    cb = _product("bclgn,bcsgn->bcgls", Cc, Bc, n_in, n_in)
    # 2: each chunk's own state contribution
    w = torch.exp(last[:, :, None] - cs) * dtc  # [B, nc, L, H]
    Bh = Bc.repeat_interleave(rep, dim=3)
    contrib = _product("bcshp,bcshn->bchpn", xc * w[..., None], Bh, n_f, n_in)
    # 3: the state passed across chunks
    state = torch.zeros((Bsz, H, P, N), dtype=f)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * torch.exp(last[:, c])[:, :, None, None] + contrib[:, c]
    start = torch.stack(starts, dim=1)  # [B, nc, H, P, N]
    # 4: the outputs from each chunk's starting state
    Ch = Cc.repeat_interleave(rep, dim=3)
    y_off = (_product("bclhn,bchpn->bclhp", Ch, start, n_in, n_f)
             * torch.exp(cs)[..., None])
    decay = torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])  # [B, nc, l, s, H]
    causal = torch.ones((L, L), dtype=torch.bool).tril()[None, None, :, :, None]
    scores = cb.repeat_interleave(rep, dim=2).permute(0, 1, 3, 4, 2) * decay
    scores = torch.where(causal, scores * dtc[:, :, None, :, :], 0.0)
    y_diag = _product("bclsh,bcshp->bclhp", scores, xc, n_f, n_in)
    y = (y_off + y_diag + D.to(f)[:, None] * xc).reshape(Bsz, nc * L, H, P)[:, :S]
    return y, state


def _recurrence(x, Bm, Cm, dt, A, D):
    """The step-by-step SSM recurrence in float64, groups repeated to heads."""
    xs, Bs, Cs, dts = (t.to(torch.float64).numpy() for t in (x, Bm, Cm, dt))
    An, Dn = A.to(torch.float64).numpy(), D.to(torch.float64).numpy()
    Bsz, S, H, P = xs.shape
    rep = H // Bs.shape[2]
    Bs, Cs = np.repeat(Bs, rep, axis=2), np.repeat(Cs, rep, axis=2)
    h = np.zeros((Bsz, H, P, Bs.shape[-1]))
    ys = np.zeros((Bsz, S, H, P))
    for t in range(S):
        h = h * np.exp(dts[:, t] * An)[:, :, None, None] + np.einsum(
            "bhn,bhp,bh->bhpn", Bs[:, t], xs[:, t], dts[:, t])
        ys[:, t] = np.einsum("bhn,bhpn->bhp", Cs[:, t], h) + Dn[None, :, None] * xs[:, t]
    return ys, h


@pytest.mark.parametrize("case", REHEARSAL_CASES)
def test_four_phases_match_the_recurrence_and_plain_in_float64(case):
    """The chunks-in-parallel algorithm is the scan: in float64 it equals the
    step-by-step recurrence to 1e-10, and ``ssd_scan_plain`` (float32 sums)
    to 1e-5."""
    B, S, H, G, P, N, chunk = case
    args = _torch(_inputs(B, S, H, P, N, seed=S + G, G=G))
    y, st = _four_phases(*args, chunk)
    ys, hs = _recurrence(*args)
    np.testing.assert_allclose(y.numpy(), ys, atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(st.numpy(), hs, atol=1e-10, rtol=1e-10)
    y_p, st_p = sk.ssd_scan_plain(*args, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), y_p.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), st_p.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", REHEARSAL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_four_phases_with_the_kernels_bf16_parts_match_plain(case, dtype):
    """The kernel's bf16 parts at the card's tolerances against the plain
    version: y and the state within 1e-4 in float32; in bfloat16 y (rounded
    to bfloat16 once, as both round) within 2e-2 and the float32 state within
    1e-4."""
    B, S, H, G, P, N, chunk = case
    bf16 = dtype == "bfloat16"
    args = _torch(_inputs(B, S, H, P, N, seed=S + G, G=G), bf16)
    y, st = _four_phases(*args, chunk, split=True)
    y_p, st_p = sk.ssd_scan_plain(*args, chunk=chunk)
    y = y.to(y_p.dtype)
    _close(y, y_p.float().numpy(), 2e-2 if bf16 else 1e-4)
    _close(st, st_p.numpy(), 1e-4)


def test_plan_of_the_engine_prefill_is_one_launch_over_enough_blocks():
    """mamba2-1.3b's 32-token prefill: one chunk, one kernel, no workspace,
    two warps (no dead query rows), P cut so that 128 output blocks run."""
    p = sk.plan(1, 32, 64, 64, 128, 256)
    assert (p.L, p.chunks, p.kernels, p.workspace, p.warps) == (32, 1, 1, 0, 2)
    assert p.out_blocks >= sk.MIN_BLOCKS and p.p_slice == 32
    assert p.col_groups == 2 and p.state_blocks == 64 * 2 * 2
    assert sk.plan(4, 32, 64, 64, 128, 256).p_slice == 64  # B = 4 has blocks enough


def test_plan_of_many_chunks_is_three_launches_with_a_workspace():
    p = sk.plan(1, 2048, 64, 64, 128, 256)
    assert (p.L, p.chunks, p.kernels, p.warps, p.p_slice, p.q_tiles) == (256, 8, 3, 4, 64, 4)
    assert p.out_blocks == 8 * 64 * 4 and p.state_blocks == 8 * 64  # 128 columns a block
    bch = 8 * 64
    assert p.workspace == -(-(4 * bch * (64 * 128 + 1)) // 16) * 16 + 2 * 2 * bch * 64 * 128
    f32 = sk.plan(1, 2048, 64, 64, 128, 256, torch.float32)
    assert f32.workspace - p.workspace == 2 * bch * 64 * 128  # a third bf16 part


@pytest.mark.parametrize("S,chunks,kernels", [(1, 1, 1), (255, 1, 1), (256, 1, 1),
                                              (257, 2, 3), (512, 2, 3), (513, 3, 3)])
def test_plan_routes_at_the_chunk_boundary(S, chunks, kernels):
    p = sk.plan(1, S, 8, 64, 128, 256)
    assert (p.chunks, p.kernels, p.L) == (chunks, kernels, min(S, 256))
    assert (p.workspace > 0) == (chunks > 1)


@pytest.mark.parametrize("P,N", [(16, 8), (32, 16), (64, 64), (128, 128), (128, 8)])
def test_plan_slices_divide_P_and_columns_cover_N(P, N):
    for S in (1, 32, 300):
        p = sk.plan(2, S, 4, P, N, 256)
        assert P % p.p_slice == 0 and 16 <= p.p_slice <= min(P, 64)
        cols = sk.state_cols(p.warps)
        assert p.col_groups * cols >= N > (p.col_groups - 1) * cols
        assert p.q_tiles * 16 * p.warps >= p.L
