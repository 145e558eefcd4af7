"""B5's gradient on the CPU: ``ssd_scan_bwd_plain`` (the formula the CUDA
backward kernels hold to, ``bwd_phases`` in float32) against autograd
through ``ssd_scan_plain`` and against ``jax.vjp`` of the reference's
oracle ``ssd_scan_ref`` (groups repeated to heads on the JAX side, dB and
dC summed back over each group's heads), from the same seeded inputs: one
step, one whole chunk, one step past it, a ragged S over three chunks,
G = 1, 2 and H, with a zero and a nonzero final-state gradient. float32
gradients agree within 1e-5 of each gradient's largest value (sums in
another order). In float64 the phases (a)-(e) equal autograd through the
step-by-step recurrence to 1e-10.

``ops.ssd_scan`` on a CPU tensor is the plain version under autograd's own
differentiation; on a CUDA tensor it is ``SsdScanFn``
(``tests/test_torch_cuda.py`` runs those legs on the card)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan import kernel as sk
from repro_torch.kernels.ssd_scan.ops import ssd_scan

torch.set_num_threads(1)

CASES = [
    # B, S, H, G, P, N, chunk
    (2, 1, 4, 2, 8, 6, 16),  # S = 1
    (1, 16, 4, 1, 8, 6, 16),  # S = L
    (2, 17, 4, 4, 8, 5, 16),  # S = L + 1, G = H
    (1, 40, 6, 2, 16, 8, 16),  # ragged S over three chunks
    (2, 48, 4, 1, 8, 12, 16),  # three whole chunks, G = 1
]
TOL = 1e-5
NAMES = ("dx", "dBm", "dCm", "ddt", "dA", "dD")


def _inputs(B, S, H, G, P, N, seed):
    """x, Bm, Cm, dt (post-softplus), A (< 0), D, dy and dstate as numpy
    float32."""
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((B, S, H, P)).astype(np.float32),
        Bm=(rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32),
        Cm=(rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32),
        dt=np.logaddexp(rng.standard_normal((B, S, H)) - 1.0, 0.0).astype(np.float32),
        A=(-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32),
        D=rng.standard_normal(H).astype(np.float32),
        dy=rng.standard_normal((B, S, H, P)).astype(np.float32),
        dstate=rng.standard_normal((B, H, P, N)).astype(np.float32),
    )


def _close(got, want, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1.0), (name, err)


@functools.lru_cache(maxsize=None)
def _reference_vjp(case, seed):
    """``jax.vjp`` of the reference oracle at ``case``'s inputs, the groups
    repeated to heads, as one jitted function of the cotangents (one compile
    per case, for both of them)."""
    B, S, H, G, P, N, chunk = case
    a = _inputs(B, S, H, G, P, N, seed)
    rep = H // G
    args = [jnp.asarray(a["x"]), jnp.asarray(np.repeat(a["Bm"], rep, axis=2)),
            jnp.asarray(np.repeat(a["Cm"], rep, axis=2)), jnp.asarray(a["dt"]),
            jnp.asarray(a["A"]), jnp.asarray(a["D"])]
    return jax.jit(lambda ct: jax.vjp(lambda *t: ssd_scan_ref(*t, chunk), *args)[1](ct))


@pytest.mark.parametrize("with_state", [False, True], ids=["dstate0", "dstate"])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd_and_the_reference(case, with_state):
    B, S, H, G, P, N, chunk = case
    a = _inputs(B, S, H, G, P, N, seed=S + G)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = sk.ssd_scan_bwd_plain(t["x"], t["Bm"], t["Cm"], t["dt"], t["A"], t["D"], t["dy"],
                                t["dstate"] if with_state else None, chunk=chunk)
    # autograd through the plain forward
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in ("x", "Bm", "Cm", "dt", "A", "D")]
    y, st = sk.ssd_scan_plain(*leaves, chunk=chunk)
    loss = (y * torch.from_numpy(a["dy"])).sum()
    if with_state:
        loss = loss + (st * torch.from_numpy(a["dstate"])).sum()
    loss.backward()
    dstate = a["dstate"] if with_state else np.zeros_like(a["dstate"])
    want = list(_reference_vjp(case, S + G)((jnp.asarray(a["dy"]), jnp.asarray(dstate))))
    rep = H // G
    for i in (1, 2):  # dB, dC over each group's heads
        want[i] = np.asarray(want[i]).reshape(B, S, G, rep, N).sum(3)
    for name, g, leaf, w in zip(NAMES, got, leaves, want):
        assert g.dtype == torch.float32 and g.shape == leaf.shape, name
        _close(g, leaf.grad.numpy(), name)
        _close(g, w, name)


def _recurrence(x, Bm, Cm, dt, A, D):
    """The step-by-step SSM recurrence in torch (differentiable), groups
    repeated to heads: (y, final state)."""
    Bsz, S, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh, Ch = Bm.repeat_interleave(rep, dim=2), Cm.repeat_interleave(rep, dim=2)
    h = torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=x.dtype)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[:, :, None, None] + torch.einsum(
            "bhn,bhp,bh->bhpn", Bh[:, t], x[:, t], dt[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h) + D[None, :, None] * x[:, t])
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("case", CASES)
def test_phases_equal_autograd_through_the_recurrence_in_float64(case):
    """The chunk-parallel phases (a)-(e) the CUDA kernels run are the
    gradient of the scan: in float64 they equal autograd through the
    step-by-step recurrence, with a nonzero final-state gradient."""
    B, S, H, G, P, N, chunk = case
    a = {k: torch.from_numpy(v).double() for k, v in _inputs(B, S, H, G, P, N, S).items()}
    got = sk.bwd_phases(a["x"], a["Bm"], a["Cm"], a["dt"], a["A"], a["D"], a["dy"],
                        a["dstate"], chunk, torch.float64)
    leaves = [a[k].clone().requires_grad_() for k in ("x", "Bm", "Cm", "dt", "A", "D")]
    y, st = _recurrence(*leaves)
    ((y * a["dy"]).sum() + (st * a["dstate"]).sum()).backward()
    for name, g, leaf in zip(NAMES, got, leaves):
        assert g.dtype == torch.float64 and g.shape == leaf.shape, name
        want = leaf.grad.numpy()
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-10 * max(np.abs(want).max(), 1.0), (name, err)


def test_bf16_gradients_take_the_inputs_dtypes():
    """With bfloat16 x/Bm/Cm, dx, dBm and dCm come back in bfloat16 (rounded
    once from the float32 sums) and ddt, dA and dD in float32."""
    a = _inputs(1, 20, 4, 2, 8, 6, seed=3)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    lo = {k: t[k].bfloat16() for k in ("x", "Bm", "Cm", "dy")}
    got = sk.ssd_scan_bwd_plain(lo["x"], lo["Bm"], lo["Cm"], t["dt"], t["A"], t["D"], lo["dy"],
                                chunk=8)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 3
    want = sk.ssd_scan_bwd_plain(*(lo[k].float() if k in lo else t[k]
                                   for k in ("x", "Bm", "Cm", "dt", "A", "D", "dy")), chunk=8)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w.to(g.dtype)), name


def test_cpu_wrapper_is_differentiated_by_autograd():
    """On a CPU tensor the wrapper is the plain version: autograd records
    its own ops (no custom Function) and launches nothing."""
    a = _inputs(1, 24, 4, 2, 8, 6, seed=5)
    x = torch.from_numpy(a["x"]).requires_grad_()
    before = (sk.launches, sk.bwd_launches)
    y, _ = ssd_scan(x, *(torch.from_numpy(a[k]) for k in ("Bm", "Cm", "dt", "A", "D")), chunk=8)
    assert type(y.grad_fn).__name__ != "SsdScanFnBackward"
    y.backward(torch.from_numpy(a["dy"]))
    assert x.grad is not None and (sk.launches, sk.bwd_launches) == before
    assert not sk.LIB_BWD.loaded
