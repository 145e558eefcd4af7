"""The port's dense, vision, audio, hybrid and MoE configurations against the
reference's jnp model: qwen3-8b, gemma2-27b, gemma3-4b,
llava-next-mistral-7b, musicgen-large, zamba2-7b, llama4-scout-17b-a16e
(MoE, top-1 softmax router, local/NoPE-global layers) and deepseek-v3-671b
(MLA, a dense layer then MoE layers with a sigmoid_bias router, an MTP
head), each at its smoke config in float32 with the reference's random
weights carried across by ``params_from_jax``. ``prefill``'s logits and every cache leaf, then three
teacher-forced ``decode_step``s at ragged positions (the two sequences a
different number of rows apart), agree within 1e-4 (float32 sums in
another order over a few layers). llava runs with and without a prefix of
projected patch embeddings; musicgen takes [B, K, S] tokens and gives
[B, K, V] logits; zamba2 fills its nested {"mamba", "shared"} cache;
deepseek-v3 its latent {"ckv", "kr"} cache. The MoE models' ``forward``
gives the reference's ``moe_drop_fraction`` exactly, with drops present.
Each ``CONFIG`` and ``smoke()`` equals the reference's field by field,
training fields included, apart from the reference's TPU and mesh fields,
which the port drops."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ARCHS = ("qwen3-8b", "gemma2-27b", "gemma3-4b", "llava-next-mistral-7b", "musicgen-large",
         "zamba2-7b", "llama4-scout-17b-a16e", "deepseek-v3-671b")
MOE_ARCHS = ("llama4-scout-17b-a16e", "deepseek-v3-671b")
TOL = 1e-4
# the reference's fields the port leaves out: the TPU programs' (the mesh-layout
# choices infer_params_tp_only and opt_pod_sharded are kept for the dry run)
DROPPED = {"attn_chunk", "use_pallas", "kernel_interpret", "topk_block_n", "topk_grid_order",
           "unroll", "kv_cache_dtype", "gqa_repeat_kv"}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_the_reference(arch, smoke):
    jc, tc = j_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    port = {f.name for f in dataclasses.fields(ModelConfig)}
    assert {f.name for f in dataclasses.fields(jc)} - port == DROPPED
    for name in port:
        want, got = getattr(jc, name), getattr(tc, name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        else:
            assert got == want, name


@pytest.fixture(scope="module")
def models():
    """arch -> (reference config, port config, reference params, port params)."""
    out = {}
    for arch in ARCHS:
        jc = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32")
        tc = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        jp, _ = JT.init_params(jc, jax.random.PRNGKey(len(out)))
        pn = jax.tree_util.tree_map(np.asarray, jp)
        out[arch] = jc, tc, jp, TT.params_from_jax(pn, tc, device="cpu")
    return out


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.to(torch.float32).numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _close_tree(t, j):
    assert set(t) == set(j)
    for k, v in t.items():
        if isinstance(v, dict):
            _close_tree(v, j[k])
        else:
            assert tuple(v.shape) == j[k].shape, k
            _close(v, j[k])


def _tokens(rng, cfg, B, S):
    shape = (B, cfg.num_codebooks, S) if cfg.modality == "audio" else (B, S)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


CASES = [(arch, 0) for arch in ARCHS] + [("llava-next-mistral-7b", 8)]


@pytest.mark.parametrize("arch,patches", CASES)
def test_prefill_and_ragged_decode_match_reference(models, arch, patches):
    jc, tc, jp, tp = models[arch]
    rng = np.random.default_rng(len(arch) + patches)
    B, S = 2, 11
    toks = _tokens(rng, jc, B, S)
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if patches:  # a prefix of patch embeddings, projected into the backbone
        v = rng.standard_normal((B, patches, jc.d_frontend)).astype(np.float32)
        jbatch["vision_embeds"], tbatch["vision_embeds"] = jnp.asarray(v), torch.from_numpy(v)
    jcache, _ = JT.init_cache(jc, B, 64)
    jl, jcache = JT.prefill(jp, jc, jbatch, jcache)
    tcache = TT.init_cache(tc, B, 64, device="cpu")
    tl, tcache2 = TT.prefill(tp, tc, tbatch, tcache)
    assert tcache2 is tcache and tl.dtype == torch.float32  # written in place; f32 logits
    want_shape = (B, jc.num_codebooks, jc.vocab_size) if jc.modality == "audio" else \
        (B, jc.vocab_size)
    assert tuple(tl.shape) == jl.shape == want_shape
    _close(tl, jl)
    _close_tree(tcache, jcache)
    start = patches + S
    for i in range(3):  # teacher-forced, the second sequence further ahead each step
        t = _tokens(rng, jc, B, 1)
        p = np.array([start + i, start + 2 * i], np.int32)
        jl, jcache = JT.decode_step(jp, jc, jnp.asarray(t), jnp.asarray(p), jcache)
        tl, _ = TT.decode_step(tp, tc, torch.from_numpy(t), torch.from_numpy(p), tcache)
        assert tuple(tl.shape) == want_shape
        _close(tl, jl)
        _close_tree(tcache, jcache)


def test_hybrid_cache_and_parameter_tree():
    """zamba2's smoke tree and cache: 5 Mamba2 blocks in 2 groups of 2 (one
    left over), 2 shared blocks at 2 * d_model with their down projection,
    one k/v cache per group; the SSM's float32 leaves stay float32 in
    ``mamba``."""
    jc, tc = j_get_config("zamba2-7b", smoke=True), get_config("zamba2-7b", smoke=True)
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(4))
    pn = jax.tree_util.tree_map(np.asarray, jp)
    tp = TT.params_from_jax(pn, tc, device="cpu")
    assert set(tp) == {"embed", "final_norm", "mamba", "shared"}
    assert tuple(tp["shared"]["down"].shape) == (2, 128, 64)
    assert tuple(tp["shared"]["attn"]["wq"].shape) == (2, 128, 4, 32)
    for k in ("A_log", "dt_bias", "D"):
        assert tp["mamba"]["ssm"][k].dtype == torch.float32
    assert tp["mamba"]["ssm"]["in_proj"].dtype == torch.bfloat16
    cache = TT.init_cache(tc, 3, 16, device="cpu")
    jcache, _ = JT.init_cache(jc, 3, 16)
    assert tuple(cache["mamba"]["ssm"].shape) == jcache["mamba"]["ssm"].shape
    assert tuple(cache["shared"]["k"].shape) == jcache["shared"]["k"].shape == (2, 3, 16, 4, 32)
    # the port's own random tree has the reference's shapes
    shape = lambda a: tuple(a.shape)  # noqa: E731
    assert jax.tree_util.tree_map(shape, TT.init_params(tc, seed=0, device="cpu")) == \
        jax.tree_util.tree_map(shape, pn)
    with pytest.raises(ValueError, match="expected"):
        TT.params_from_jax({k: v for k, v in pn.items() if k != "shared"}, tc, device="cpu")


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-mistral-7b"])
def test_frontend_trees_have_the_reference_shapes(arch):
    jc, tc = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(5))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    got = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                 TT.init_params(tc, seed=0, device="cpu"))
    assert got == shapes


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_moe_drop_fraction_matches_reference(models, arch):
    """``forward``'s hidden states within 1e-4 and its metric, the mean of
    the MoE layers' drop fractions, equal to the reference's at the config's
    own capacity factor over 2 x 40 tokens, where experts overflow."""
    jc, tc, jp, tp = models[arch]
    toks = np.random.default_rng(9).integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    jh, _, _, jm = JT.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    th, tm = TT.forward(tp, tc, {"tokens": torch.from_numpy(toks)})
    _close(th, jh)
    assert set(tm) == set(jm) == {"moe_drop_fraction"}
    assert np.float32(tm["moe_drop_fraction"]) == np.float32(jm["moe_drop_fraction"]) > 0
    _, qc, _, qp = models["qwen3-8b"]  # a model without MoE layers reports no metric
    assert TT.forward(qp, qc, {"tokens": torch.from_numpy(toks[:, :5])})[1] == {}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_trees_keep_the_router_in_float32(arch):
    """The MoE trees have the reference's shapes ("dense_layers" only with
    first_k_dense, "mtp" only with mtp_depth), and ``params_from_jax`` keeps
    ``router`` and ``router_bias`` float32 in a bfloat16 model, everywhere
    they occur (the MoE stack and the MTP block)."""
    jc, tc = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(6))
    pn = jax.tree_util.tree_map(np.asarray, jp)
    tp = TT.params_from_jax(pn, tc, device="cpu")
    shape = lambda a: tuple(a.shape)  # noqa: E731
    assert jax.tree_util.tree_map(shape, tp) == jax.tree_util.tree_map(shape, pn)
    assert jax.tree_util.tree_map(shape, TT.init_params(tc, seed=0, device="cpu")) == \
        jax.tree_util.tree_map(shape, pn)
    want = {"embed", "unembed", "final_norm", "moe_layers"}
    if jc.moe.first_k_dense:
        want |= {"dense_layers", "mtp"}
    assert set(tp) == want
    ffns = [tp["moe_layers"]["ffn"]] + ([tp["mtp"]["block"]["ffn"]] if "mtp" in tp else [])
    for ffn in ffns:
        assert ffn["router"].dtype == torch.float32
        assert ffn.get("router_bias", ffn["router"]).dtype == torch.float32
        assert ffn["w_gate"].dtype == torch.bfloat16
    if "router_bias" in ffns[0]:  # the reference keeps it float32 too
        assert pn["moe_layers"]["ffn"]["router_bias"].dtype == np.float32
    cache = TT.init_cache(tc, 3, 16, device="cpu")
    jcache, _ = JT.init_cache(jc, 3, 16)
    assert {k: shape(v) for k, v in cache.items()} == {k: v.shape for k, v in jcache.items()}
    missing = "mtp" if "mtp" in pn else "moe_layers"
    with pytest.raises(ValueError, match="expected"):
        TT.params_from_jax({k: v for k, v in pn.items() if k != missing}, tc, device="cpu")
