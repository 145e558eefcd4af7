"""The training substrate of the port against the reference: one AdamW and
one 8-bit AdamW update (parameters, moments or their int8 values and
scales, grad norm; weight decay and clipping on) from the same seeded
trees, ``_microbatch_grads`` at accumulation 1 and 4 (against each other
and the reference's), the schedules, ``compress_with_error_feedback`` and
``global_norm``; then the assertions of the reference's
``tests/test_training.py`` on the port. Tolerances: float32 updates within
1e-6 (the same float32 operations; the 8-bit moments' int8 values may sit a
rounding step apart where x / scale lands within an ulp of .5, so they are
compared through the dequantized moments at one int8 step), gradients at
1e-4 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _compat import given, settings, st

from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro.training import grad_compress as j_gc
from repro.training import optimizer as j_opt
from repro.training import schedule as j_sched
from repro.training.train_loop import _microbatch_grads as j_microbatch_grads
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.training.grad_compress import compress_with_error_feedback, init_error_state
from repro_torch.training.optimizer import (
    AdamWConfig,
    _dequantize,
    _quantize,
    adamw_update,
    global_norm,
    init_opt_state,
    tree_leaves,
    tree_map,
)
from repro_torch.training.schedule import constant, warmup_cosine
from repro_torch.training.train_loop import _microbatch_grads

torch.set_num_threads(1)


def _tree(seed, stacked=True):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16, 32) if stacked else (16, 32)).astype(np.float32),
            "ln": rng.standard_normal((32,)).astype(np.float32),
            "tiny": rng.standard_normal((4, 6)).astype(np.float32)}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# --- parity with the reference ----------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_adamw_update_matches_the_reference(quantized):
    cfg = AdamWConfig(quantized=quantized, clip_norm=1.0, weight_decay=0.1)
    jcfg = j_opt.AdamWConfig(quantized=quantized, clip_norm=1.0, weight_decay=0.1)
    params, grads = _tree(0), _tree(1)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_opt.init_opt_state(jp, jcfg)
    ts = init_opt_state(_t(params), cfg)
    # a second step, from the first's moments, exercises the bias correction
    for step in range(2):
        jp, js, jm = j_opt.adamw_update(jp, jax.tree.map(jnp.asarray, grads), js,
                                        jnp.asarray(step, jnp.int32), jnp.asarray(3e-2), jcfg)
        tp_prev = _t(params) if step == 0 else tp
        tp, ts, tm = adamw_update(tp_prev, _t(grads), ts, torch.tensor(step, dtype=torch.int32),
                                  torch.tensor(3e-2), cfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)
            sj, st_ = js[k], ts[k]
            assert set(sj) == set(st_) == {"m", "v"}
            for mom in ("m", "v"):
                if isinstance(sj[mom], dict):
                    assert set(st_[mom]) == {"q", "scale"} and st_[mom]["q"].dtype == torch.int8
                    np.testing.assert_allclose(st_[mom]["scale"].numpy(),
                                               np.asarray(sj[mom]["scale"]), rtol=1e-6)
                    step_size = np.asarray(sj[mom]["scale"])
                    got = _dequantize(st_[mom]).numpy()
                    want = np.asarray(j_opt._dequantize(sj[mom]))
                    assert (np.abs(got - want) <= step_size * 1.0001).all()
                else:
                    np.testing.assert_allclose(st_[mom].numpy(), np.asarray(sj[mom]),
                                               atol=1e-6, rtol=1e-6)
        if quantized:  # continue both from the reference's state, as it stands
            ts = tree_map(lambda a: torch.from_numpy(np.array(a)), js)
            tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jp)


def test_quantized_state_tree_is_the_reference_layout():
    params = _tree(2)
    ts = init_opt_state(_t(params), AdamWConfig(quantized=True))
    js = j_opt.init_opt_state(jax.tree.map(jnp.asarray, params), j_opt.AdamWConfig(quantized=True))
    assert jax.tree.structure(js) == jax.tree.structure(tree_map(lambda a: 0, ts))
    assert isinstance(ts["tiny"]["m"], torch.Tensor)  # last axis < 8: float32 moments


def test_microbatch_grads_accum_1_and_4_match_the_reference():
    jc = dataclasses.replace(j_get_config("qwen1.5-0.5b", smoke=True), dtype="float32")
    tc = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True), dtype="float32")
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (4, 24)).astype(np.int32)
    out = {}
    for accum in (1, 4):
        tg, tl, _ = _microbatch_grads(dataclasses.replace(tc, grad_accum=accum), tp,
                                      {"tokens": torch.from_numpy(toks)}, torch.float32)
        jg, jl, _ = j_microbatch_grads(dataclasses.replace(jc, grad_accum=accum), jp,
                                       {"tokens": jnp.asarray(toks)}, jnp.float32)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
            assert a.dtype == torch.float32
            err = np.abs(a.numpy() - np.asarray(b)).max()
            assert err <= 1e-4 * max(np.abs(np.asarray(b)).max(), 1e-2)
        out[accum] = (tg, float(tl))
    assert abs(out[1][1] - out[4][1]) < 0.05
    for a, b in zip(tree_leaves(out[1][0]), tree_leaves(out[4][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.02, rtol=0.05)


def test_bf16_accumulation_under_the_8bit_optimizer():
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True), grad_accum=2)
    params = TT.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 16)))
    grads, loss, _ = _microbatch_grads(cfg, params, {"tokens": toks}, torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(grads))
    assert torch.isfinite(loss) and loss.dtype == torch.float32


def test_schedules_match_the_reference():
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
        np.testing.assert_allclose(float(warmup_cosine(s, **kw)),
                                   float(j_sched.warmup_cosine(s, **kw)), rtol=1e-6)
        assert float(constant(s, peak_lr=2e-3)) == float(j_sched.constant(s, peak_lr=2e-3))


def test_compression_and_global_norm_match_the_reference():
    grads = _tree(3)
    err_t, err_j = None, None
    for _ in range(3):
        sent_t, err_t = compress_with_error_feedback(_t(grads), err_t)
        sent_j, err_j = j_gc.compress_with_error_feedback(jax.tree.map(jnp.asarray, grads), err_j)
        for k in grads:
            np.testing.assert_allclose(sent_t[k].numpy(), np.asarray(sent_j[k]), atol=1e-6)
            np.testing.assert_allclose(err_t[k].numpy(), np.asarray(err_j[k]), atol=1e-6)
    np.testing.assert_allclose(float(global_norm(_t(grads))),
                               float(j_opt.global_norm(jax.tree.map(jnp.asarray, grads))),
                               rtol=1e-6)


# --- the reference's tests/test_training.py on the port ---------------------


def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 256)).astype(np.float32)) * 3
    err = torch.abs(_dequantize(_quantize(x)) - x)
    per_row_scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0
    assert bool(torch.all(err <= per_row_scale * 0.51 + 1e-6))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_property_quantize_preserves_sign_and_zero(seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((8, 32)).astype(np.float32))
    x[0, 0] = 0.0
    d = _dequantize(_quantize(x))
    assert float(d[0, 0]) == 0.0
    big = torch.abs(x) > torch.amax(torch.abs(x), -1, keepdim=True) * 0.05
    assert bool(torch.all(torch.where(big, torch.sign(d) == torch.sign(x), True)))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("stacked", [False, True])
def test_adamw_descends_quadratic(quantized, stacked):
    cfg = AdamWConfig(quantized=quantized, weight_decay=0.0)
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(
        rng.standard_normal((8, 16, 32) if stacked else (16, 32)).astype(np.float32) * 0.1)}
    opt = init_opt_state(params, cfg)

    def loss(p):
        return torch.sum((p["w"] - 1.0) ** 2)

    l0 = float(loss(params))
    for i in range(50):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, opt, _ = adamw_update(params, {"w": g}, opt, i, 0.05, cfg)
    assert float(loss(params)) < l0 * 0.2


def test_quantized_tracks_fp32_closely():
    w0 = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 16, 32)).astype(np.float32))
    outs = {}
    for quantized in (False, True):
        cfg = AdamWConfig(quantized=quantized, weight_decay=0.0)
        p = {"w": w0 * 0.1}
        opt = init_opt_state(p, cfg)
        for i in range(30):
            p, opt, _ = adamw_update(p, {"w": 2 * (p["w"] - 1.0)}, opt, i, 0.05, cfg)
        outs[quantized] = float(torch.sum((p["w"] - 1.0) ** 2))
    assert abs(outs[True] - outs[False]) < 0.15 * max(outs[False], 1e-3)


def test_grad_accum_matches_full_batch():
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    params = TT.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32)))
    g1, l1, _ = _microbatch_grads(dataclasses.replace(cfg, grad_accum=1), params,
                                  {"tokens": toks}, torch.float32)
    g4, l4, _ = _microbatch_grads(dataclasses.replace(cfg, grad_accum=4), params,
                                  {"tokens": toks}, torch.float32)
    assert abs(float(l1) - float(l4)) < 0.05
    for a, b in zip(tree_leaves(g1), tree_leaves(g4)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=0.02, rtol=0.05)


def test_schedule_shape():
    lrs = [float(warmup_cosine(s, peak_lr=1.0, warmup_steps=10, total_steps=100))
           for s in range(100)]
    assert lrs[0] < 0.11 and abs(lrs[10] - 1.0) < 1e-6
    assert lrs[99] < 0.2 and all(b <= a + 1e-6 for a, b in zip(lrs[10:], lrs[11:]))


def test_grad_compression_error_feedback_unbiased():
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal((32, 64)).astype(np.float32))}
    err = init_error_state(g)
    total = torch.zeros_like(g["w"])
    for _ in range(20):
        sent, err = compress_with_error_feedback(g, err)
        total = total + sent["w"]
    np.testing.assert_allclose((total / 20).numpy(), g["w"].numpy(), atol=0.02)


def test_global_norm_matches_naive():
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.standard_normal((8, 4, 16)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((32,)).astype(np.float32))}
    naive = np.sqrt(sum(float(torch.sum(torch.square(leaf))) for leaf in tree_leaves(tree)))
    assert abs(float(global_norm(tree)) - naive) < 1e-4
