"""The port's MLA (multi-head latent attention, ``repro_torch.models.attention``)
against the reference's at deepseek-v3's smoke widths in float32 (4 heads,
q/k width 24 = 16 latent-expanded + 8 rope, value width 16, latent 16), the
same numpy parameters and inputs in both: prefill (through the flash
attention kernel's plain version with its own value width) with the
latent cache it writes, then the absorbed decode at ragged positions, all
within 1e-4 (float32 sums in another order). The flash attention plain
version at q/k 24 and v 16 is held against the reference's ``mha``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as t_attn

torch.set_num_threads(1)

TOL = 1e-4
ARCH = "deepseek-v3-671b"


def _configs():
    jc = dataclasses.replace(j_get_config(ARCH, smoke=True), dtype="float32")
    tc = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    return jc, tc


def _params(cfg, seed=0):
    """An MLA layer at ``cfg``'s widths, drawn with numpy; the norms' scales
    away from 1 so that they are exercised."""
    m, D, H = cfg.mla, cfg.d_model, cfg.num_heads
    rng = np.random.default_rng(seed)
    shapes = {"wq_a": (D, m.q_lora_rank), "q_norm": (m.q_lora_rank,),
              "wq_b": (m.q_lora_rank, H, m.qk_head_dim),
              "wkv_a": (D, m.kv_lora_rank + m.qk_rope_head_dim), "kv_norm": (m.kv_lora_rank,),
              "wkv_b": (m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim),
              "wo": (H, m.v_head_dim, D)}
    p = {k: rng.standard_normal(s) / np.sqrt(s[0]) for k, s in shapes.items()}
    p["q_norm"] = 1.0 + 0.1 * rng.standard_normal(shapes["q_norm"])
    p["kv_norm"] = 1.0 + 0.1 * rng.standard_normal(shapes["kv_norm"])
    return {k: v.astype(np.float32) for k, v in p.items()}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.to(torch.float32).numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def test_init_mla_has_the_reference_shapes():
    import jax

    jc, tc = _configs()
    jp, _ = j_attn.init_mla(jax.random.PRNGKey(0), jc, stacked=2)
    tp = t_attn.init_mla(torch.Generator().manual_seed(0), tc, stacked=2, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    jcache, _ = j_attn.init_mla_cache(jc, 3, 16)
    tcache = t_attn.init_mla_cache(tc, 3, 16, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()} == {"ckv": (3, 16, 16), "kr": (3, 16, 8)}


@pytest.mark.parametrize("S", [1, 11, 40])
def test_prefill_and_absorbed_decode_match_reference(S):
    """Prefill of S tokens into a [2, 64] latent cache (the port also clears
    the rows past S, which start as zeros in both), then three decode steps
    with the two sequences at different positions."""
    jc, tc = _configs()
    p = _params(jc)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    rng = np.random.default_rng(S)
    B, S_max = 2, 64
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jcache, _ = j_attn.init_mla_cache(jc, B, S_max)
    jy, jcache = j_attn.mla_attention(jp, jc, jnp.asarray(x), jnp.asarray(pos), cache=jcache)
    tcache = t_attn.init_mla_cache(tc, B, S_max, device="cpu")
    tcache["ckv"].fill_(7.0)  # stale rows of an earlier request: cleared past S
    ty, tcache2 = t_attn.mla_attention(tp, tc, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                                       cache=tcache)
    assert tcache2 is tcache and ty.shape == (B, S, jc.d_model)
    _close(ty, jy)
    for k in ("ckv", "kr"):
        _close(tcache[k], jcache[k])
    for i in range(3):
        xd = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
        p_new = np.array([S + i, S + 3 * i], np.int32)
        jy, jcache = j_attn.mla_attention(jp, jc, jnp.asarray(xd), jnp.asarray(p_new[:, None]),
                                          cache=jcache, cache_positions=jnp.asarray(p_new))
        ty, _ = t_attn.mla_attention(tp, tc, torch.from_numpy(xd),
                                     torch.from_numpy(p_new[:, None].copy()), cache=tcache,
                                     cache_positions=torch.from_numpy(p_new))
        _close(ty, jy)
        for k in ("ckv", "kr"):
            _close(tcache[k], jcache[k])


def test_prefill_without_a_cache_matches_reference():
    jc, tc = _configs()
    p = _params(jc, 1)
    x = np.random.default_rng(2).standard_normal((1, 9, jc.d_model)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)[None]
    jy, jc_out = j_attn.mla_attention({k: jnp.asarray(v) for k, v in p.items()}, jc,
                                      jnp.asarray(x), jnp.asarray(pos))
    ty, tc_out = t_attn.mla_attention({k: torch.from_numpy(v) for k, v in p.items()}, tc,
                                      torch.from_numpy(x), torch.from_numpy(pos))
    assert jc_out is None and tc_out is None
    _close(ty, jy)


@pytest.mark.parametrize("case", [(2, 11, 4, 4, 0), (1, 40, 4, 2, 0), (2, 33, 4, 4, 8)])
def test_flash_plain_with_a_value_width_matches_mha(case):
    """q/k width 24, v width 16 (MLA's smoke shape; GQA and a window too)
    against the reference's ``mha``, causal, scale 1/sqrt(24)."""
    B, S, H, KH, window = case
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, S, H, 24)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, 24)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, 16)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    want = j_attn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=pos, k_pos=pos,
                      window=window, cap=0.0, scale=24 ** -0.5, chunk=1024)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=window,
                          scale=24 ** -0.5)
    assert got.shape == (B, S, H, 16)
    _close(got, want, 2e-5)
    # the default scale is q's width, as in the reference kernel
    _close(fk.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), window=window),
           want, 2e-5)


def test_plain_refuses_a_value_tensor_of_other_rows():
    q, k = torch.randn(1, 8, 4, 24), torch.randn(1, 8, 2, 24)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, k, torch.randn(1, 8, 4, 16))  # v's heads differ from k's
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, k, torch.randn(1, 7, 2, 16))  # v's rows differ from k's
