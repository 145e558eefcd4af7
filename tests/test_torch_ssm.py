"""The port's SSM family (mamba2) against the reference's jnp model: the
mamba2-1.3b smoke config in float32, the reference's random weights carried
across by ``params_from_jax``. ``prefill`` logits and the conv/ssm caches,
then three teacher-forced ``decode_step``s, agree within 1e-4 (float32 sums
in another order over a few layers) at prompt lengths 1 and 2 (shorter than
the conv's d_conv - 1 = 3 taps of history), 40 (two scan chunks of 32, the
second partial) and 7. In bfloat16 one block agrees with the reference's
within one bfloat16 step (the conv and the SiLU round where the reference
rounds), and ``params_from_jax`` keeps ``A_log``, ``dt_bias`` and ``D`` in
float32. The port's ``ServingEngine`` gives the reference's token lists,
``metrics`` and final slot states through continuous batching with slot
reuse, so prefill overwrites a reused slot's state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import ssm as j_ssm
from repro.models import transformer as JT
from repro.serving.engine import ModelBackend as JBackend
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import ModelBackend as TBackend
from repro_torch.serving.engine import ServingEngine as TEngine

torch.set_num_threads(1)

LLM = "mamba2-1.3b"
TOL = 1e-4


def _configs(dtype="float32"):
    jc = dataclasses.replace(j_get_config(LLM, smoke=True), dtype=dtype)
    tc = dataclasses.replace(get_config(LLM, smoke=True), dtype=dtype)
    return jc, tc


@pytest.fixture(scope="module")
def f32():
    jc, tc = _configs()
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(0))
    pn = jax.tree_util.tree_map(np.asarray, jp)
    return jc, tc, jp, pn, TT.params_from_jax(pn, tc, device="cpu")


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.to(torch.float32).numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def test_config_matches_the_reference():
    for smoke in (False, True):
        jc, tc = j_get_config(LLM, smoke=smoke), get_config(LLM, smoke=smoke)
        for f in ("family", "num_layers", "d_model", "vocab_size", "norm_eps", "dtype",
                  "tie_embeddings", "d_inner", "ssm_heads"):
            assert getattr(tc, f) == getattr(jc, f), f
        assert dataclasses.asdict(tc.ssm) == dataclasses.asdict(jc.ssm)
    assert (tc.d_inner, tc.ssm_heads) == (128, 4)


@pytest.mark.parametrize("S", [1, 2, 40, 7])
def test_prefill_and_decode_match_reference(f32, S):
    jc, tc, jp, _, tp = f32
    rng = np.random.default_rng(S)
    B = 2
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    jcache, _ = JT.init_cache(jc, B, 64)
    jl, jcache = JT.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, jcache)
    tcache = TT.init_cache(tc, B, 64, device="cpu")
    tl, tcache2 = TT.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, tcache)
    assert tcache2 is tcache and tl.dtype == torch.float32  # written in place; f32 logits
    assert set(tcache) == {"conv", "ssm"}
    _close(tl, jl)
    for name in ("conv", "ssm"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        _close(tcache[name], jcache[name])
    for i in range(3):  # teacher-forced
        t = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
        p = np.full((B,), S + i, np.int32)
        jl, jcache = JT.decode_step(jp, jc, jnp.asarray(t), jnp.asarray(p), jcache)
        tl, _ = TT.decode_step(tp, tc, torch.from_numpy(t), torch.from_numpy(p), tcache)
        _close(tl, jl)
        for name in ("conv", "ssm"):
            _close(tcache[name], jcache[name])


def test_prefill_overwrites_a_used_cache():
    """Prefill starts the scan from a zero state and overwrites the conv
    tail, whatever the slot held: a used cache ends as a fresh one."""
    _, tc = _configs()
    tp = TT.init_params(tc, seed=3, device="cpu")
    toks = torch.arange(2)[None]  # shorter than d_conv - 1: the tail is left-padded
    fresh = TT.init_cache(tc, 1, 16, device="cpu")
    used = TT.init_cache(tc, 1, 16, device="cpu")
    for name in ("conv", "ssm"):
        used[name].normal_()
    l1, _ = TT.prefill(tp, tc, {"tokens": toks}, fresh)
    l2, _ = TT.prefill(tp, tc, {"tokens": toks}, used)
    assert torch.equal(l1, l2)
    for name in ("conv", "ssm"):
        assert torch.equal(fresh[name], used[name])
    assert (used["conv"][:, :, 0] == 0).all()  # the padded tap


def test_bfloat16_block_rounds_where_the_reference_rounds():
    """One SSM block in bfloat16, prefill then a decode step: the depthwise
    conv + SiLU equals the reference's bit for bit, the block's output and
    caches agree within one bfloat16 step, the state stays float32."""
    jc, tc = _configs("bfloat16")
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(0))
    pn = jax.tree_util.tree_map(np.asarray, jp)
    lp = {k: v[0] for k, v in pn["layers"]["ssm"].items()}
    tlp = {k: v[0] for k, v in TT.params_from_jax(pn, tc, device="cpu")["layers"]["ssm"].items()}
    rng = np.random.default_rng(1)
    xbc = rng.standard_normal((2, 9, 160)).astype(np.float32)
    want = j_ssm._causal_conv(jnp.asarray(xbc, jnp.bfloat16), jnp.asarray(lp["conv_w"]),
                              jnp.asarray(lp["conv_b"]))
    got = t_ssm._causal_conv(torch.from_numpy(xbc).bfloat16(), tlp["conv_w"], tlp["conv_b"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))

    x = rng.standard_normal((2, 40, tc.d_model)).astype(np.float32)
    jcache, _ = j_ssm.init_ssm_cache(jc, 2)
    tcache = t_ssm.init_ssm_cache(tc, 2)
    assert (tcache["conv"].dtype, tcache["ssm"].dtype) == (torch.bfloat16, torch.float32)
    jy, jcache = j_ssm.ssm_block(lp, jc, jnp.asarray(x, jnp.bfloat16), cache=jcache)
    ty = t_ssm.ssm_block(tlp, tc, torch.from_numpy(x).bfloat16(), cache=tcache)
    assert ty.dtype == torch.bfloat16
    _close(ty, jy, 2e-2)
    _close(tcache["conv"], jcache["conv"], 0.0)
    _close(tcache["ssm"], jcache["ssm"], 1e-5)
    xd = rng.standard_normal((2, 1, tc.d_model)).astype(np.float32)
    jy, jcache = j_ssm.ssm_block(lp, jc, jnp.asarray(xd, jnp.bfloat16), cache=jcache, decode=True)
    ty = t_ssm.ssm_block(tlp, tc, torch.from_numpy(xd).bfloat16(), cache=tcache, decode=True)
    _close(ty, jy, 2e-2)
    _close(tcache["conv"], jcache["conv"], 0.0)
    _close(tcache["ssm"], jcache["ssm"], 1e-5)


def test_params_from_jax_keeps_the_float32_leaves():
    """A bfloat16 mamba2 tree: ``A_log``, ``dt_bias`` and ``D`` stay float32
    (exactly the reference's values), every other leaf is bfloat16; a dense
    tree comes across exactly as before (every leaf in ``cfg.dtype``)."""
    jc, tc = _configs("bfloat16")
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(2))
    pn = jax.tree_util.tree_map(np.asarray, jp)
    tp = TT.params_from_jax(pn, tc, device="cpu")
    for k, v in tp["layers"]["ssm"].items():
        ref = pn["layers"]["ssm"][k]
        if k in ("A_log", "dt_bias", "D"):
            assert ref.dtype == np.float32 and v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), ref)
        else:
            assert v.dtype == torch.bfloat16, k
    assert tp["embed"]["table"].dtype == tp["layers"]["ln"].dtype == torch.bfloat16

    qc = j_get_config("qwen1.5-0.5b", smoke=True)
    qp = jax.tree_util.tree_map(np.asarray, JT.init_params(qc, jax.random.PRNGKey(3))[0])
    got = TT.params_from_jax(qp, get_config("qwen1.5-0.5b", smoke=True), device="cpu")

    def walk(t, r):
        for k, v in r.items():
            if isinstance(v, dict):
                walk(t[k], v)
            else:
                want = torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16)
                assert t[k].dtype == torch.bfloat16 and torch.equal(t[k], want), k

    walk(got, qp)


def test_init_params_draws_the_reference_distributions():
    _, tc = _configs()
    tp = TT.init_params(tc, seed=0, device="cpu")
    jc, _ = _configs()
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    for k, v in tp["layers"]["ssm"].items():
        assert tuple(v.shape) == shapes["layers"]["ssm"][k], k
    dt0 = torch.nn.functional.softplus(tp["layers"]["ssm"]["dt_bias"])
    assert (dt0 >= 1e-3 * 0.999).all() and (dt0 <= 0.1 * 1.001).all()
    a = torch.exp(tp["layers"]["ssm"]["A_log"])
    assert (a >= 1).all() and (a <= 16).all()
    assert tp["layers"]["ssm"]["A_log"].dtype == torch.float32


def test_engine_matches_reference_with_slot_reuse(f32):
    """Five prompts over two slots: every slot is prefilled at least twice,
    the second time over another request's state."""
    jc, tc, jp, pn, _ = f32
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32) for n in (1, 40, 2, 7, 11)]
    je = JEngine(jc, jp, max_batch=2, max_seq=64)
    te = TEngine(tc, pn, max_batch=2, max_seq=64, device="cpu")
    assert te.generate(prompts, max_new_tokens=6) == je.generate(prompts, max_new_tokens=6)
    assert te.metrics == je.metrics and te.metrics["decode_steps"] > 0
    assert sorted(te.slots.free) == [0, 1]
    for name in ("conv", "ssm"):  # free slots decode token 0 every tick, in both
        _close(te.cache[name], je.cache[name])


def test_model_backend_over_the_ssm_engine_matches_reference(f32):
    jc, tc, jp, pn, _ = f32
    jb = JBackend(LLM, JEngine(jc, jp, max_batch=2, max_seq=64))
    tb = TBackend(LLM, TEngine(tc, pn, max_batch=2, max_seq=64, device="cpu"))
    prompts = ["what is a state space model", "", "how do the chunks carry state"]
    assert [r.text for r in tb.generate_batch(prompts, max_tokens=4)] == \
        [r.text for r in jb.generate_batch(prompts, max_tokens=4)]
