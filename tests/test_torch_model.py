"""The port's dense decoder against the reference's jnp model: the qwen1.5-0.5b
smoke config in float32, the reference's random weights carried across by
``params_from_jax``. ``prefill`` logits and KV cache, then three
``decode_step``s at ragged positions, agree within 1e-4 (float32 sums in
another order over a few layers). A second config turns on every other dense
branch (local/global windows, attention and final softcaps, qk-norm, post
norms, GQA, embedding scale, a local RoPE theta), a third the rest (NoPE
layers, an ungated GELU MLP, an untied unembedding, a query scale, no QKV
bias). The layer helpers are held against the reference's in bfloat16,
where the casts matter, and the attention block's kernel path against the
reference's ``mha``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

TOL = 1e-4
VARIANTS = {
    "qwen-smoke": {},
    "every-dense-branch": dict(
        attn_pattern=("local", "global"), window_size=4, attn_logit_softcap=30.0,
        qk_norm=True, post_norms=True, num_kv_heads=2, embed_scale=True,
        final_logit_softcap=20.0, rope_theta_local=1e4,
    ),
    "nope-gelu-untied": dict(
        attn_pattern=("local", "nope_global"), window_size=3, act="gelu", mlp_gated=False,
        tie_embeddings=False, query_scale=0.3, qkv_bias=False,
    ),
}


def _configs(**over):
    jc = dataclasses.replace(j_get_config("qwen1.5-0.5b", smoke=True), dtype="float32", **over)
    tc = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True), dtype="float32", **over)
    return jc, tc


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.to(torch.float32).numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_decode_match_reference(variant):
    jc, tc = _configs(**VARIANTS[variant])
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(0)
    B, S, M = 2, 9, 32
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    jcache, _ = JT.init_cache(jc, B, M)
    jl, jcache = JT.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, jcache)
    tcache = TT.init_cache(tc, B, M, device="cpu")
    tl, tcache2 = TT.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, tcache)
    assert tcache2 is tcache and tl.dtype == torch.float32  # written in place; f32 logits
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    for pos in ([9, 4], [10, 5], [11, 6]):  # ragged: each sequence at its own row
        t = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
        p = np.asarray(pos, np.int32)
        jl, jcache = JT.decode_step(jp, jc, jnp.asarray(t), jnp.asarray(p), jcache)
        tl, _ = TT.decode_step(tp, tc, torch.from_numpy(t), torch.from_numpy(p), tcache)
        _close(tl, jl)
        for name in ("k", "v"):
            _close(tcache[name], jcache[name])


def test_prefill_into_a_used_cache_leaves_a_fresh_cache_state():
    """Prefill clears the rows past the prompt, so a reused slot holds what
    the reference's fresh batch-1 cache holds."""
    _, tc = _configs()
    tp = TT.init_params(tc, seed=3, device="cpu")
    toks = torch.arange(5)[None]
    fresh = TT.init_cache(tc, 1, 16, device="cpu")
    used = TT.init_cache(tc, 1, 16, device="cpu")
    for name in ("k", "v"):
        used[name].normal_()
    l1, _ = TT.prefill(tp, tc, {"tokens": toks}, fresh)
    l2, _ = TT.prefill(tp, tc, {"tokens": toks}, used)
    assert torch.equal(l1, l2)
    for name in ("k", "v"):
        assert torch.equal(fresh[name], used[name])
        assert (used[name][:, :, 5:] == 0).all()


def test_layer_helpers_match_reference_in_bfloat16():
    """rms_norm and RoPE compute in float32 and cast back, as the reference
    does."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    jw, tw = jnp.asarray(w, jnp.bfloat16), torch.from_numpy(w).bfloat16()
    got = t_layers.rms_norm(tx, tw, 1e-6)
    assert got.dtype == torch.bfloat16
    _close(got, j_layers.rms_norm(jx, jw, 1e-6), 1e-2)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    got = t_layers.apply_rope(tx, torch.from_numpy(pos), 1e4)
    assert got.dtype == torch.bfloat16
    _close(got, j_layers.apply_rope(jx, jnp.asarray(pos), 1e4), 1e-2)


def test_kernel_path_attention_matches_mha_in_float32():
    """The attention block's kernel path (flash on prefill, decode over the
    cache) computes what the reference's ``mha`` computes."""
    jc, tc = _configs(attn_pattern=("local",), window_size=3, attn_logit_softcap=15.0,
                      num_kv_heads=2)
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(1))
    lp = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], jp["layers"]["attn"])
    tlp = {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
    x = np.random.default_rng(2).standard_normal((1, 7, tc.d_model)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)[None]
    y_t, _ = t_attn.attention(tlp, tc, torch.from_numpy(x), torch.from_numpy(pos),
                              window=3, theta=tc.rope_theta)
    y_j, _ = j_attn.attention(lp, jc, jnp.asarray(x), jnp.asarray(pos), window=3,
                              theta=jc.rope_theta)
    _close(y_t, y_j)


def test_greedy_takes_the_first_maximum_like_jnp_argmax():
    from repro_torch.serving.sampler import sample_tokens

    logits = np.array([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]], np.float32)
    got = sample_tokens(torch.from_numpy(logits), temperature=0.0)
    assert got.tolist() == np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1)).tolist() == [1, 0]


def test_other_families_raise_naming_the_roadmap():
    """Every architecture and family of the reference is ported: a family
    the reference does not define raises, naming the ported ones, and an
    unknown architecture is a KeyError."""
    from repro.configs import ARCH_NAMES as J_ARCH_NAMES

    _, tc = _configs()
    with pytest.raises(NotImplementedError, match="'no-such-family' is not one the reference"):
        TT.init_params(dataclasses.replace(tc, family="no-such-family"), device="cpu")
    with pytest.raises(NotImplementedError, match="not one the reference"):
        TT.init_cache(dataclasses.replace(tc, family="no-such-family"), 1, 8, device="cpu")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    for name in J_ARCH_NAMES:
        assert get_config(name).name == name == get_config(name, smoke=True).name


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    _, tc = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.params_from_jax({}, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(tc)
