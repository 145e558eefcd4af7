"""Decoder stack of the dense family (the port of the reference's
``models/transformer.py`` for ``family == "dense"``; the MoE, MLA, SSM,
hybrid, audio and vision stacks wait for ROADMAP queue A item 10).

Parameters are a plain dict in the reference's layout, layers stacked on
axis 0 (``params["layers"]["attn"]["wq"]`` is [n, d, H, Dh]), so a reader
finds each counterpart and ``params_from_jax`` carries the reference's
weights across as they are. A Python loop over the layers takes the place
of ``lax.scan``; nothing is jitted.

API (the reference's names):
  init_params(cfg, seed=0, device=None)          -> params
  params_from_jax(params_np, cfg, device=None)   -> params
  init_cache(cfg, batch, max_seq, device=None)   -> {"k", "v"}: [n, B, S, KH, Dh]
  prefill(params, cfg, batch, cache)             -> (last_logits, cache)
  decode_step(params, cfg, tokens, pos, cache)   -> (logits, cache)
The cache is updated in place and returned for the reference's signature.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
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


def _require_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP queue A "
            "item 10); the port runs the dense family"
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
    _require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d, dt = cfg.num_layers, cfg.d_model, param_dtype(cfg)
    params: Params = {"embed": init_embedding(gen, cfg.vocab_size, d, cfg, device=dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, d, cfg, device=dev)
    params["final_norm"] = ones_init((d,), dt, device=dev)
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
    without one), in ``cfg.dtype``. The layout is the same: layers stacked
    on axis 0, the embedding tied unless ``unembed`` is present."""
    _require_dense(cfg)
    dev = resolve_device(device)
    dt = param_dtype(cfg)

    def put(tree):
        if isinstance(tree, dict):
            return {k: put(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree, np.float32)).to(device=dev, dtype=dt)

    params = put(params_np)
    expect = {"embed", "final_norm", "layers"} | (set() if cfg.tie_embeddings else {"unembed"})
    if set(params) != expect:
        raise ValueError(f"parameter tree has {sorted(params)}, expected {sorted(expect)}")
    if params["layers"]["ln1"].shape[0] != cfg.num_layers:
        raise ValueError(f"{params['layers']['ln1'].shape[0]} layers for {cfg.num_layers}")
    return params


def init_cache(cfg, batch: int, max_seq: int, device: DeviceLike = None) -> Params:
    _require_dense(cfg)
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


def _run_stacks(params, cfg, x, positions, *, cache=None, cache_pos=None):
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
    ``cache`` (rows 0..S-1, the rest cleared) in place; return the last
    position's float32 logits [B, V] and the cache."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = embed_fn(params["embed"], tokens, cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    h = _run_stacks(params, cfg, x, positions, cache=cache)
    return unembed_logits(_unembed_table(params, cfg), h[:, -1], cfg), cache


@torch.no_grad()
def decode_step(params, cfg, tokens, pos, cache):
    """One decode step. tokens [B, 1], pos [B] (the row each new token
    occupies); the cache is written in place. Returns float32 logits [B, V]
    and the cache."""
    _require_dense(cfg)
    x = embed_fn(params["embed"], tokens, cfg)
    pos = pos.to(device=x.device, dtype=torch.int64)
    h = _run_stacks(params, cfg, x, pos[:, None], cache=cache, cache_pos=pos)
    return unembed_logits(_unembed_table(params, cfg), h[:, 0], cfg), cache
