"""Decoder stacks of the dense and SSM families (the port of the reference's
``models/transformer.py`` for ``family`` "dense" and "ssm"; the MoE, MLA,
hybrid, audio and vision stacks wait for ROADMAP queue A item 10).

Parameters are a plain dict in the reference's layout, layers stacked on
axis 0 (``params["layers"]["attn"]["wq"]`` is [n, d, H, Dh],
``params["layers"]["ssm"]["in_proj"]`` [n, d, d_in_proj]), so a reader
finds each counterpart and ``params_from_jax`` carries the reference's
weights across as they are. A Python loop over the layers takes the place
of ``lax.scan``; nothing is jitted.

API (the reference's names):
  init_params(cfg, seed=0, device=None)          -> params
  params_from_jax(params_np, cfg, device=None)   -> params
  init_cache(cfg, batch, max_seq, device=None)   -> dense: {"k", "v"}: [n, B, S, KH, Dh]
                                                    ssm: {"conv": [n, B, W-1, C],
                                                          "ssm": [n, B, H, P, N]}
  prefill(params, cfg, batch, cache)             -> (last_logits, cache)
  decode_step(params, cfg, tokens, pos, cache)   -> (logits, cache)
The cache is updated in place and returned for the reference's signature.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import PORTED_FAMILIES
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    embed as embed_fn,
    init_embedding,
    init_mlp,
    mlp,
    ones_init,
    param_dtype,
    rms_norm,
    rope_angles,
    unembed_logits,
)

Params = Dict[str, Any]


def _require_ported(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP queue A "
            f"item 10); the port runs the families {PORTED_FAMILIES}"
        )


def layer_meta(cfg, n: int) -> Tuple[List[int], List[float], List[bool]]:
    """(window, theta, use_rope) per layer, built from ``attn_pattern``."""
    kinds = [cfg.attn_pattern[i % len(cfg.attn_pattern)] for i in range(n)]
    theta_local = cfg.rope_theta_local or cfg.rope_theta
    window = [cfg.window_size if k == "local" else 0 for k in kinds]
    theta = [theta_local if k == "local" else cfg.rope_theta for k in kinds]
    use_rope = [k != "nope_global" for k in kinds]
    return window, theta, use_rope


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (None = CUDA, raising without one)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d, dt = cfg.num_layers, cfg.d_model, param_dtype(cfg)
    params: Params = {"embed": init_embedding(gen, cfg.vocab_size, d, cfg, device=dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, d, cfg, device=dev)
    params["final_norm"] = ones_init((d,), dt, device=dev)
    if cfg.family == "ssm":
        params["layers"] = {"ln": ones_init((d,), dt, n, dev),
                            "ssm": ssm_mod.init_ssm(gen, cfg, stacked=n, device=dev)}
        return params
    layers: Params = {"ln1": ones_init((d,), dt, n, dev), "ln2": ones_init((d,), dt, n, dev)}
    if cfg.post_norms:
        layers["ln1_post"] = ones_init((d,), dt, n, dev)
        layers["ln2_post"] = ones_init((d,), dt, n, dev)
    layers["attn"] = attn_mod.init_attn(gen, cfg, stacked=n, device=dev)
    layers["ffn"] = init_mlp(gen, d, cfg.d_ff, cfg, stacked=n, device=dev)
    params["layers"] = layers
    return params


def params_from_jax(params_np: Params, cfg, device: DeviceLike = None) -> Params:
    """The reference's parameter tree (numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``, bfloat16 leaves
    included) as the port's parameters on ``device`` (None = CUDA, raising
    without one), in ``cfg.dtype`` except the leaves the reference keeps in
    float32 whatever the model's dtype (the SSM's ``A_log``, ``dt_bias``
    and ``D``), which stay float32. The layout is the same: layers stacked
    on axis 0, the embedding tied unless ``unembed`` is present."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dt = param_dtype(cfg)

    def put(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = put(v)
            else:
                leaf_dt = torch.float32 if k in ssm_mod.FLOAT32_PARAMS else dt
                out[k] = torch.from_numpy(np.array(v, np.float32)).to(device=dev, dtype=leaf_dt)
        return out

    params = put(params_np)
    expect = {"embed", "final_norm", "layers"} | (set() if cfg.tie_embeddings else {"unembed"})
    if set(params) != expect:
        raise ValueError(f"parameter tree has {sorted(params)}, expected {sorted(expect)}")
    n = next(iter(_leaves(params["layers"]))).shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"{n} layers for {cfg.num_layers}")
    return params


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def init_cache(cfg, batch: int, max_seq: int, device: DeviceLike = None) -> Params:
    _require_ported(cfg)
    if cfg.family == "ssm":
        one = ssm_mod.init_ssm_cache(cfg, batch, device=resolve_device(device))
    else:
        one = attn_mod.init_attn_cache(cfg, batch, max_seq, device=resolve_device(device))
    return {k: v[None].repeat(cfg.num_layers, *([1] * v.dim())) for k, v in one.items()}


def _attn_block_body(cfg, lp, x, positions, win, theta, rope_flag, cache_l, cache_pos, rope):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a_out, _ = attn_mod.attention(
        lp["attn"], cfg, h, positions, window=win, theta=theta, use_rope=rope_flag,
        cache=cache_l, cache_positions=cache_pos, rope=rope,
    )
    if cfg.post_norms:
        a_out = rms_norm(a_out, lp["ln1_post"], cfg.norm_eps)
    x = x + a_out
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    f_out = mlp(lp["ffn"], h, cfg)
    if cfg.post_norms:
        f_out = rms_norm(f_out, lp["ln2_post"], cfg.norm_eps)
    return x + f_out


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _run_ssm_stack(stack, cfg, x, *, cache=None, decode=False):
    for i in range(stack["ln"].shape[0]):
        lp = _layer(stack, i)
        cache_l = None if cache is None else {k: v[i] for k, v in cache.items()}
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        x = x + ssm_mod.ssm_block(lp["ssm"], cfg, h, cache=cache_l, decode=decode)
    return x


def _run_stacks(params, cfg, x, positions, *, cache=None, cache_pos=None, decode=False):
    if cfg.family == "ssm":
        x = _run_ssm_stack(params["layers"], cfg, x, cache=cache, decode=decode)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)
    windows, thetas, use_rope = layer_meta(cfg, cfg.num_layers)
    angles: Dict[float, Tuple[torch.Tensor, torch.Tensor]] = {}  # one (cos, sin) per theta
    for i in range(cfg.num_layers):
        rope = None
        if use_rope[i]:
            if thetas[i] not in angles:
                angles[thetas[i]] = rope_angles(positions, thetas[i], cfg.head_dim)
            rope = angles[thetas[i]]
        cache_l = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i]}
        x = _attn_block_body(cfg, _layer(params["layers"], i), x, positions, windows[i],
                             thetas[i], use_rope[i], cache_l, cache_pos, rope)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _unembed_table(params, cfg):
    return params["embed"]["table"] if cfg.tie_embeddings else params["unembed"]["table"]


@torch.no_grad()
def prefill(params, cfg, batch, cache):
    """Run the prompt ``batch["tokens"]`` [B, S] through the stack, filling
    ``cache`` in place (dense: rows 0..S-1, the rest cleared; SSM: the conv
    tail and the state, overwritten, the scan started from a zero state);
    return the last position's float32 logits [B, V] and the cache."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    x = embed_fn(params["embed"], tokens, cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    h = _run_stacks(params, cfg, x, positions, cache=cache)
    return unembed_logits(_unembed_table(params, cfg), h[:, -1], cfg), cache


@torch.no_grad()
def decode_step(params, cfg, tokens, pos, cache):
    """One decode step. tokens [B, 1], pos [B] (the row each new token
    occupies; the SSM family does not read it); the cache is written in
    place. Returns float32 logits [B, V] and the cache."""
    _require_ported(cfg)
    x = embed_fn(params["embed"], tokens, cfg)
    pos = pos.to(device=x.device, dtype=torch.int64)
    h = _run_stacks(params, cfg, x, pos[:, None], cache=cache, cache_pos=pos, decode=True)
    return unembed_logits(_unembed_table(params, cfg), h[:, 0], cfg), cache
