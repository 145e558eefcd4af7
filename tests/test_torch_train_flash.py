"""B4's gradient on the CPU: ``flash_attention_bwd_plain`` (the formula the
CUDA backward kernels hold to) against autograd through
``flash_attention_plain``, and both against ``jax.grad`` of the
reference's oracle ``flash_attention_ref``, from the same seeded inputs.
The cases cover causal and not, a window, a softcap, GQA, a ragged S,
S = 1 and the wide head widths 224 and 256; q/k 24 with v 16 (MLA's split
widths at smoke size) is held against ``jax.vjp`` of the reference's
``mha``. The plain forward's row log-sum-exp equals the reference's scores'
logsumexp. float32 throughout; gradients agree within 1e-5 of the largest
value (sums in another order), the log-sum-exp within 1e-5.

``ops.flash_attention`` on a CPU tensor is the plain version under
autograd's own differentiation; on a CUDA tensor it is ``FlashAttentionFn``
(``tests/test_torch_cuda.py`` runs those legs on the card)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro.models import attention as j_attn
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import flash_attention

torch.set_num_threads(1)

CASES = [
    # B, S, H, KH, Dh, causal, window, softcap
    (2, 40, 4, 4, 16, True, 0, 0.0),
    (1, 70, 8, 2, 32, True, 16, 0.0),  # GQA, a window
    (2, 33, 4, 1, 16, True, 0, 30.0),  # a softcap
    (1, 50, 4, 2, 64, False, 12, 20.0),  # non-causal, window and softcap
    (2, 1, 2, 1, 16, True, 0, 0.0),
    (1, 24, 2, 1, 224, True, 0, 0.0),  # zamba2's shared-attention width
    (1, 20, 2, 2, 256, True, 8, 0.0),  # gemma3's width, a window
]
MLA_CASES = [
    # B, S, H, KH, window: q/k width 24, v width 16 (MLA's split at smoke width)
    (2, 19, 4, 4, 0),
    (1, 33, 4, 2, 8),
]
TOL = 1e-5


def _inputs(case, seed=0):
    B, S, H, KH, Dh = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, Dh), (B, S, KH, Dh), (B, S, KH, Dh), (B, S, H, Dh))]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd_and_the_reference(case):
    causal, window, cap = case[5:]
    opts = dict(causal=causal, window=window, softcap=cap)
    q, k, v, do = _inputs(case)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = fk.flash_attention_plain(tq, tk, tv, return_lse=True, **opts)
    o.backward(torch.from_numpy(do))
    got = fk.flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(), o.detach(), lse,
                                       torch.from_numpy(do), **opts)
    want = jax.jit(lambda a, b, c, d: jax.vjp(lambda *t: j_ref(*t, **opts), a, b, c)[1](d))(
        *(jnp.asarray(t) for t in (q, k, v, do)))
    for name, g, a, w in zip("qkv", got, (tq.grad, tk.grad, tv.grad), want):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
        _close(g, a.numpy())
        _close(g, w)


@pytest.mark.parametrize("case", MLA_CASES)
def test_plain_backward_at_a_value_width_matches_autograd_and_mha(case):
    """q/k 24 and v 16 (MLA's (192, 128) at smoke width): the plain
    backward against autograd and ``jax.vjp`` of the reference's ``mha``,
    causal, scale 1/sqrt(24); dq and dk are 24 wide, dv 16."""
    B, S, H, KH, window = case
    rng = np.random.default_rng(S)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, H, 24), (B, S, KH, 24), (B, S, KH, 16), (B, S, H, 16)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = fk.flash_attention_plain(tq, tk, tv, window=window, return_lse=True)
    o.backward(torch.from_numpy(do))
    got = fk.flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(), o.detach(), lse,
                                       torch.from_numpy(do), window=window)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    def mha(a, b, c):
        return j_attn.mha(a, b, c, q_pos=pos, k_pos=pos, window=window, cap=0.0,
                          scale=24 ** -0.5, chunk=1024)

    want = jax.jit(lambda a, b, c, d: jax.vjp(mha, a, b, c)[1](d))(
        *(jnp.asarray(t) for t in (q, k, v, do)))
    for name, g, a, w in zip("qkv", got, (tq.grad, tk.grad, tv.grad), want):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
        _close(g, a.numpy())
        _close(g, w)


@pytest.mark.parametrize("case", CASES)
def test_plain_lse_is_the_scores_logsumexp(case):
    B, S, H, KH, Dh, causal, window, cap = case
    q, k, _, _ = _inputs(case, seed=1)
    _, lse = fk.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(k), causal=causal, window=window,
                                      softcap=cap, return_lse=True)
    G = H // KH
    s = np.einsum("bqkgd,bskd->bkgqs", q.reshape(B, S, KH, G, Dh).astype(np.float64),
                  k.astype(np.float64)) * Dh ** -0.5
    if cap:
        s = cap * np.tanh(s / cap)
    pos = np.arange(S)
    mask = np.ones((S, S), bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(B, H, S)
    np.testing.assert_allclose(lse.numpy(), want, atol=TOL, rtol=TOL)


def test_cpu_wrapper_is_differentiated_by_autograd():
    """On a CPU tensor the wrapper is the plain version: autograd records
    its own ops (no custom Function) and launches nothing."""
    q, k, v, do = _inputs(CASES[1])
    tq = torch.from_numpy(q).requires_grad_()
    before = (fk.launches, fk.bwd_launches)
    out = flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v), window=16)
    assert type(out.grad_fn).__name__ != "FlashAttentionFnBackward"
    out.backward(torch.from_numpy(do))
    assert tq.grad is not None and (fk.launches, fk.bwd_launches) == before
    assert not fk.LIB_BWD.loaded
