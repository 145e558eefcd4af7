"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
local path (``repro.models.moe``) at the two MoE smoke configs in float32:
llama4-scout's softmax router (16 -> 4 experts, top-1) and deepseek-v3's
``sigmoid_bias`` router (8 experts, top-2, ``routed_scaling`` 2.5) with a
random nonzero bias. The same numpy inputs and parameters go to both.

Routing is a discrete decision, so the expert ids are equal exactly and so
is ``moe_drop_fraction`` (counts over T k, exact in float32); the gate
weights and outputs agree within 1e-5 (float32 sums in another order).
Exact ties break to the lower expert index in both, as ``lax.top_k``
does. ``moe_ffn`` runs at a capacity that drops assignments, with and
without the shared expert."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as j_moe
from repro_torch.configs import get_config
from repro_torch.models import moe as t_moe

torch.set_num_threads(1)

TOL = 1e-5
ARCHS = ("llama4-scout-17b-a16e", "deepseek-v3-671b")


def _configs(arch, **moe_kw):
    jc = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32")
    tc = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if moe_kw:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe_kw))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe_kw))
    return jc, tc


def _params(cfg, seed):
    """The reference's MoE tree at ``cfg``'s widths, drawn with numpy
    (router_bias nonzero for sigmoid_bias)."""
    rng = np.random.default_rng(seed)
    mo, D = cfg.moe, cfg.d_model
    E, F = mo.num_experts, mo.d_ff_expert
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    if mo.router == "sigmoid_bias":
        p["router_bias"] = 0.5 * rng.standard_normal((E,))
    if mo.num_shared_experts:
        Fs = mo.d_ff_shared * mo.num_shared_experts
        p["shared_gate"] = rng.standard_normal((D, Fs)) / np.sqrt(D)
        p["shared_up"] = rng.standard_normal((D, Fs)) / np.sqrt(D)
        p["shared_down"] = rng.standard_normal((Fs, D)) / np.sqrt(Fs)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    jc, tc = _configs(arch)
    jp, tp = _both(_params(jc, 0))
    x = np.random.default_rng(1).standard_normal((64, jc.d_model)).astype(np.float32)
    j_idx, j_gates = j_moe._route(jp, jc, jnp.asarray(x))
    t_idx, t_gates = t_moe._route(tp, tc, torch.from_numpy(x))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_gates.numpy(), np.asarray(j_gates), atol=TOL, rtol=TOL)
    assert t_gates.dtype == torch.float32
    if jc.moe.router == "sigmoid_bias":  # the scaled gates of each token sum to 2.5
        np.testing.assert_allclose(t_gates.sum(-1).numpy(), jc.moe.routed_scaling, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_ties_go_to_the_lower_expert_index(arch):
    """Experts 1 and 3 share a router column (equal logits for every token),
    so do 0 and 2; with a zero bias both packages pick the lower index of
    each tied pair first."""
    jc, tc = _configs(arch)
    p = _params(jc, 2)
    p["router"][:, 3] = p["router"][:, 1]
    p["router"][:, 2] = p["router"][:, 0]
    if "router_bias" in p:
        p["router_bias"][:] = 0.0
    jp, tp = _both(p)
    x = np.random.default_rng(3).standard_normal((32, jc.d_model)).astype(np.float32)
    j_idx, _ = j_moe._route(jp, jc, jnp.asarray(x))
    t_idx, _ = t_moe._route(tp, tc, torch.from_numpy(x))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    top = t_idx[:, 0]
    assert not np.isin(top.numpy(), [2, 3]).any()  # never the higher twin first
    tied = top < 2
    assert tied.any()
    if jc.moe.top_k > 1:  # a tied pair on top: the higher twin comes right after
        assert (t_idx[tied, 1] == top[tied] + 2).all()


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference_with_drops(arch, shared):
    """capacity_factor 0.5 over 2 x 24 tokens: the most loaded experts drop
    assignments, the rest keep theirs."""
    kw = {} if shared else dict(num_shared_experts=0)
    jc, tc = _configs(arch, **kw)
    jp, tp = _both(_params(jc, 4))
    x = np.random.default_rng(5).standard_normal((2, 24, jc.d_model)).astype(np.float32)
    jy, jm = j_moe.moe_ffn(jp, jc, jnp.asarray(x), capacity_factor=0.5)
    ty, tm = t_moe.moe_ffn(tp, tc, torch.from_numpy(x), capacity_factor=0.5)
    drop = float(tm["moe_drop_fraction"])
    assert 0.0 < drop < 1.0  # drops are live
    assert np.float32(drop) == np.float32(jm["moe_drop_fraction"])
    assert ty.shape == (2, 24, jc.d_model) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    j_idx, _ = j_moe._route(jp, jc, jnp.asarray(x.reshape(48, -1)))
    t_idx, _ = t_moe._route(tp, tc, torch.from_numpy(x.reshape(48, -1)))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_at_the_configs_own_capacity(arch):
    """The smoke configs' capacity factor (1.5) and the min(8, T) floor:
    T = 5 keeps every assignment (capacity T), T = 2 x 40 drops some. The
    tokens share a common offset, so the router favours some experts."""
    jc, tc = _configs(arch)
    jp, tp = _both(_params(jc, 6))
    for shape in ((1, 5), (2, 40)):
        x = np.random.default_rng(7).standard_normal(shape + (jc.d_model,)).astype(np.float32)
        x += 1.0
        jy, jm = j_moe.moe_ffn(jp, jc, jnp.asarray(x))
        ty, tm = t_moe.moe_ffn(tp, tc, torch.from_numpy(x))
        assert np.float32(tm["moe_drop_fraction"]) == np.float32(jm["moe_drop_fraction"])
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
        drop = float(tm["moe_drop_fraction"])
        assert drop == 0.0 if shape == (1, 5) else drop > 0.0


@pytest.mark.parametrize("T", [1, 4, 5, 8, 40, 128, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_is_the_reference_formula(arch, T):
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        mo = cfg.moe
        want = max(int(np.ceil(T * mo.top_k / mo.num_experts * mo.capacity_factor)), min(8, T))
        assert t_moe.capacity_of(cfg, T) == want


def test_init_moe_draws_the_reference_shapes_with_a_float32_router():
    jc, tc = _configs("deepseek-v3-671b")
    tc = dataclasses.replace(tc, dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = t_moe.init_moe(gen, tc, stacked=3, device="cpu")
    want = {k: (3,) + v.shape for k, v in _params(jc, 0).items()}
    assert {k: tuple(v.shape) for k, v in p.items()} == want
    assert p["router"].dtype == p["router_bias"].dtype == torch.float32
    assert p["w_gate"].dtype == p["shared_up"].dtype == torch.bfloat16
    assert not p["router_bias"].any()
    # one expert at a time: each [D, F] slice has the fan-in's scale, and experts differ
    w = p["w_gate"][0].float()
    assert abs(float(w.std()) * np.sqrt(tc.d_model) - 1.0) < 0.1  # unit normal cut at 3 sigma
    assert not torch.equal(w[0], w[1])
