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
