"""Decoder stacks of every family the reference defines: dense, MoE (with
MLA), SSM, hybrid, vision and audio (the port of the reference's
``models/transformer.py``).

Parameters are a plain dict in the reference's layout, layers stacked on
axis 0 (``params["layers"]["attn"]["wq"]`` is [n, d, H, Dh],
``params["layers"]["ssm"]["in_proj"]`` [n, d, d_in_proj]), so a reader
finds each counterpart and ``params_from_jax`` carries the reference's
weights across as they are. A Python loop over the layers takes the place
of ``lax.scan``; nothing is jitted.

The families' trees: dense and vlm {"embed", ["unembed"], "final_norm",
"layers"}, vlm adding the vision "projector"; audio a stacked
``embed.table`` [K, V, d] and "heads" [K, d, V] in place of the unembedding;
ssm {"embed", "final_norm", "layers"}; hybrid (zamba2) "mamba" (the
Mamba2 blocks, stacked) and "shared" (``num_shared_blocks`` attention blocks
at 2 * d_model with their "down" projection) in place of "layers"; moe
"dense_layers" (the ``first_k_dense`` leading layers, an MLP of width
``d_ff_dense``, when there are any) and "moe_layers" (the rest, with
``moe.moe_ffn``) in place of "layers", their attention GQA or, with
``cfg.mla``, MLA, and with ``mtp_depth`` the multi-token-prediction head
"mtp" {"block", "norm1", "norm2", "proj"}. MTP's forward is training only
(the reference's ``loss_fn``) and comes with the training port; its
weights are drawn and carried across here.

API (the reference's names):
  init_params(cfg, seed=0, device=None)          -> params
  params_from_jax(params_np, cfg, device=None)   -> params
  init_cache(cfg, batch, max_seq, device=None)   -> dense/vlm/audio/moe: {"k", "v"}: [n, B, S, KH, Dh]
                                                    MLA: {"ckv": [n, B, S, kv_lora_rank],
                                                          "kr": [n, B, S, qk_rope_head_dim]}
                                                    ssm: {"conv": [n, B, W-1, C],
                                                          "ssm": [n, B, H, P, N]}
                                                    hybrid: {"mamba": the ssm cache over
                                                             num_layers, "shared": the k/v
                                                             cache over the groups}
  forward(params, cfg, batch)                    -> (h [B, S, d], metrics)
  prefill(params, cfg, batch, cache)             -> (last_logits, cache)
  decode_step(params, cfg, tokens, pos, cache)   -> (logits, cache)
The cache is updated in place and returned for the reference's signature.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import PORTED_FAMILIES
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    F32,
    dense_init,
    embed as embed_fn,
    init_embedding,
    init_mlp,
    mlp,
    ones_init,
    param_dtype,
    rms_norm,
    rope_angles,
    unembed_logits,
    zeros_init,
)

Params = Dict[str, Any]


# leaves the reference keeps in float32 whatever the model's dtype
FLOAT32_PARAMS = ssm_mod.FLOAT32_PARAMS + moe_mod.FLOAT32_PARAMS


def _require_ported(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one the reference defines; "
            f"the port runs the families {PORTED_FAMILIES}"
        )


def layer_meta(cfg, n: int, offset: int = 0) -> Tuple[List[int], List[float], List[bool]]:
    """(window, theta, use_rope) per layer, built from ``attn_pattern``; the
    stack's first layer is layer ``offset`` of the pattern (a MoE stack
    after ``first_k_dense`` dense layers)."""
    kinds = [cfg.attn_pattern[(offset + i) % len(cfg.attn_pattern)] for i in range(n)]
    theta_local = cfg.rope_theta_local or cfg.rope_theta
    window = [cfg.window_size if k == "local" else 0 for k in kinds]
    theta = [theta_local if k == "local" else cfg.rope_theta for k in kinds]
    use_rope = [k != "nope_global" for k in kinds]
    return window, theta, use_rope


def _zamba_groups(cfg) -> Tuple[int, int]:
    """(groups of ``hybrid_period`` Mamba2 blocks, each followed by a shared
    block; Mamba2 blocks left over after the last group)."""
    return cfg.num_layers // cfg.hybrid_period, cfg.num_layers % cfg.hybrid_period


def _init_attn_stack(gen, cfg, n: int, d: int, dev, ffn: str = "mlp",
                     d_ff: Optional[int] = None) -> Params:
    """n stacked attention blocks at width d: MLA when ``cfg.mla`` is set,
    else GQA; ``ffn`` "mlp" (of width ``d_ff``, default ``cfg.d_ff``) or
    "moe"."""
    dt = param_dtype(cfg)
    layers: Params = {"ln1": ones_init((d,), dt, n, dev), "ln2": ones_init((d,), dt, n, dev)}
    if cfg.post_norms:
        layers["ln1_post"] = ones_init((d,), dt, n, dev)
        layers["ln2_post"] = ones_init((d,), dt, n, dev)
    if cfg.mla is not None:
        layers["attn"] = attn_mod.init_mla(gen, cfg, stacked=n, device=dev)
    else:
        layers["attn"] = attn_mod.init_attn(gen, cfg, d_in=d, stacked=n, device=dev)
    if ffn == "moe":
        layers["ffn"] = moe_mod.init_moe(gen, cfg, stacked=n, device=dev)
    else:
        layers["ffn"] = init_mlp(gen, d, d_ff or cfg.d_ff, cfg, stacked=n, device=dev)
    return layers


def _init_ssm_stack(gen, cfg, n: int, dev) -> Params:
    return {"ln": ones_init((cfg.d_model,), param_dtype(cfg), n, dev),
            "ssm": ssm_mod.init_ssm(gen, cfg, stacked=n, device=dev)}


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (None = CUDA, raising without one)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, dt = cfg.d_model, param_dtype(cfg)
    params: Params = {}
    if cfg.modality == "audio":
        K, V = cfg.num_codebooks, cfg.vocab_size
        params["embed"] = {"table": dense_init(gen, (V, d), fan_in=d, dtype=dt, stacked=K,
                                               device=dev)}
        params["heads"] = dense_init(gen, (K, d, V), fan_in=d, dtype=dt, device=dev)
    else:
        params["embed"] = init_embedding(gen, cfg.vocab_size, d, cfg, device=dev)
        if not cfg.tie_embeddings:
            params["unembed"] = init_embedding(gen, cfg.vocab_size, d, cfg, device=dev)
    if cfg.modality == "vision":
        params["projector"] = {
            "w1": dense_init(gen, (cfg.d_frontend, d), dtype=dt, device=dev),
            "b1": zeros_init((d,), dt, device=dev),
            "w2": dense_init(gen, (d, d), dtype=dt, device=dev),
            "b2": zeros_init((d,), dt, device=dev),
        }
    params["final_norm"] = ones_init((d,), dt, device=dev)
    if cfg.family == "ssm":
        params["layers"] = _init_ssm_stack(gen, cfg, cfg.num_layers, dev)
    elif cfg.family == "hybrid":
        nsb = cfg.num_shared_blocks
        params["mamba"] = _init_ssm_stack(gen, cfg, cfg.num_layers, dev)
        params["shared"] = _init_attn_stack(gen, cfg, nsb, 2 * d, dev)
        params["shared"]["down"] = dense_init(gen, (2 * d, d), dtype=dt, stacked=nsb,
                                              device=dev)
    elif cfg.moe is not None:
        fkd = cfg.moe.first_k_dense
        if fkd:
            params["dense_layers"] = _init_attn_stack(gen, cfg, fkd, d, dev,
                                                      d_ff=cfg.moe.d_ff_dense or cfg.d_ff)
        params["moe_layers"] = _init_attn_stack(gen, cfg, cfg.num_layers - fkd, d, dev,
                                                ffn="moe")
        if cfg.mtp_depth:
            params["mtp"] = {
                "block": _init_attn_stack(gen, cfg, 1, d, dev, ffn="moe"),
                "norm1": ones_init((d,), dt, device=dev),
                "norm2": ones_init((d,), dt, device=dev),
                "proj": dense_init(gen, (2 * d, d), dtype=dt, device=dev),
            }
    else:
        params["layers"] = _init_attn_stack(gen, cfg, cfg.num_layers, d, dev)
    return params


def _expected_tree(cfg) -> Dict[str, int]:
    """The top-level keys of ``cfg``'s parameter tree; stacks map to their
    leading (layer) dimension, the other keys to 0."""
    keys = {"embed": 0, "final_norm": 0}
    if cfg.modality == "audio":
        keys["heads"] = 0
    elif not cfg.tie_embeddings:
        keys["unembed"] = 0
    if cfg.modality == "vision":
        keys["projector"] = 0
    if cfg.family == "hybrid":
        keys.update(mamba=cfg.num_layers, shared=cfg.num_shared_blocks)
    elif cfg.moe is not None:
        fkd = cfg.moe.first_k_dense
        if fkd:
            keys["dense_layers"] = fkd
        keys["moe_layers"] = cfg.num_layers - fkd
        if cfg.mtp_depth:
            keys["mtp"] = 0
    else:
        keys["layers"] = cfg.num_layers
    return keys


def params_from_jax(params_np: Params, cfg, device: DeviceLike = None) -> Params:
    """The reference's parameter tree (numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``, bfloat16 leaves
    included) as the port's parameters on ``device`` (None = CUDA, raising
    without one), in ``cfg.dtype`` except the leaves the reference keeps in
    float32 whatever the model's dtype (``FLOAT32_PARAMS``: the SSM's
    ``A_log``, ``dt_bias`` and ``D``, in ``layers`` or ``mamba``; the MoE
    router's ``router`` and ``router_bias``), which stay float32. The layout
    is the same: layers stacked on axis 0, the embedding tied unless
    ``unembed`` is present."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dt = param_dtype(cfg)

    def put(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = put(v)
            else:
                leaf_dt = torch.float32 if k in FLOAT32_PARAMS else dt
                out[k] = torch.from_numpy(np.array(v, np.float32)).to(device=dev, dtype=leaf_dt)
        return out

    params = put(params_np)
    expect = _expected_tree(cfg)
    if set(params) != set(expect):
        raise ValueError(f"parameter tree has {sorted(params)}, expected {sorted(expect)}")
    for key, n_want in expect.items():
        n = next(iter(_leaves(params[key]))).shape[0] if n_want else 0
        if n != n_want:
            raise ValueError(f"{key}: {n} layers for {n_want}")
    return params


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _stacked(one: Params, n: int) -> Params:
    return {k: v[None].repeat(n, *([1] * v.dim())) for k, v in one.items()}


def init_cache(cfg, batch: int, max_seq: int, device: DeviceLike = None) -> Params:
    _require_ported(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return _stacked(ssm_mod.init_ssm_cache(cfg, batch, device=dev), cfg.num_layers)
    if cfg.mla is not None:
        return _stacked(attn_mod.init_mla_cache(cfg, batch, max_seq, device=dev),
                        cfg.num_layers)
    attn = attn_mod.init_attn_cache(cfg, batch, max_seq, device=dev)
    if cfg.family == "hybrid":
        # one k/v cache per group (13 for zamba2-7b), though the groups
        # alternate between the num_shared_blocks shared blocks' weights
        return {"mamba": _stacked(ssm_mod.init_ssm_cache(cfg, batch, device=dev),
                                  cfg.num_layers),
                "shared": _stacked(attn, _zamba_groups(cfg)[0])}
    return _stacked(attn, cfg.num_layers)


def _attn_block_body(cfg, lp, x, positions, win, theta, rope_flag, cache_l, cache_pos, rope,
                     ffn: str = "mlp"):
    """One attention block (GQA, or MLA with ``cfg.mla``; ``rope`` is then
    MLA's angles) and its FFN; returns x and the MoE's metrics ({} for an
    MLP)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a_out, _ = attn_mod.mla_attention(lp["attn"], cfg, h, positions, cache=cache_l,
                                          cache_positions=cache_pos, rope=rope)
    else:
        a_out, _ = attn_mod.attention(
            lp["attn"], cfg, h, positions, window=win, theta=theta, use_rope=rope_flag,
            cache=cache_l, cache_positions=cache_pos, rope=rope,
        )
    if cfg.post_norms:
        a_out = rms_norm(a_out, lp["ln1_post"], cfg.norm_eps)
    x = x + a_out
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    metrics = {}
    if ffn == "moe":
        f_out, metrics = moe_mod.moe_ffn(lp["ffn"], cfg, h)
    else:
        f_out = mlp(lp["ffn"], h, cfg)
    if cfg.post_norms:
        f_out = rms_norm(f_out, lp["ln2_post"], cfg.norm_eps)
    return x + f_out, metrics


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _ssm_layers(stack, cfg, x, layers, *, cache=None, decode=False):
    for i in layers:
        lp = _layer(stack, i)
        cache_l = None if cache is None else {k: v[i] for k, v in cache.items()}
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        x = x + ssm_mod.ssm_block(lp["ssm"], cfg, h, cache=cache_l, decode=decode)
    return x


def _shared_block_apply(cfg, sp, x, x0, positions, cache_l, cache_pos, rope):
    """Zamba2 shared attention block at 2 * d_model on concat(x, x0),
    projected back to d_model by ``down`` and added to x."""
    inp = torch.cat([x, x0], dim=-1)
    h = rms_norm(inp, sp["ln1"], cfg.norm_eps)
    a_out, _ = attn_mod.attention(
        sp["attn"], cfg, h, positions, window=0, theta=cfg.rope_theta, use_rope=True,
        cache=cache_l, cache_positions=cache_pos, rope=rope,
    )
    r = inp + a_out
    h2 = rms_norm(r, sp["ln2"], cfg.norm_eps)
    r = r + mlp(sp["ffn"], h2, cfg)
    return x + r @ sp["down"]


def _run_hybrid(params, cfg, x, positions, *, cache=None, cache_pos=None, decode=False):
    """Groups of ``hybrid_period`` Mamba2 blocks, each followed by shared
    block g % num_shared_blocks with group g's own k/v cache, then the
    blocks left over. The shared blocks read the stack's input x0."""
    n_groups, _ = _zamba_groups(cfg)
    p = cfg.hybrid_period
    x0 = x
    m_cache = None if cache is None else cache["mamba"]
    rope = rope_angles(positions, cfg.rope_theta, cfg.head_dim)
    for g in range(n_groups):
        x = _ssm_layers(params["mamba"], cfg, x, range(g * p, (g + 1) * p), cache=m_cache,
                        decode=decode)
        sp = _layer(params["shared"], g % cfg.num_shared_blocks)
        sc = None if cache is None else {k: v[g] for k, v in cache["shared"].items()}
        x = _shared_block_apply(cfg, sp, x, x0, positions, sc, cache_pos, rope)
    return _ssm_layers(params["mamba"], cfg, x, range(n_groups * p, cfg.num_layers),
                       cache=m_cache, decode=decode)


def _attn_stacks(cfg) -> List[Tuple[str, str, int, int]]:
    """The attention family's stacks in order: (params key, ffn, layers,
    first layer's index in the model and its stacked cache)."""
    if cfg.moe is None:
        return [("layers", "mlp", cfg.num_layers, 0)]
    fkd = cfg.moe.first_k_dense
    stacks = [("dense_layers", "mlp", fkd, 0)] if fkd else []
    return stacks + [("moe_layers", "moe", cfg.num_layers - fkd, fkd)]


def _run_attn_layers(params, cfg, x, positions, *, cache=None, cache_pos=None):
    """The attention stacks (a MoE model's dense then MoE layers) over the
    layers' views of the one stacked cache; the metrics are the MoE layers'
    ``moe_drop_fraction`` averaged, as the reference's scan averages them."""
    angles: Dict[float, Tuple[torch.Tensor, torch.Tensor]] = {}  # one (cos, sin) per theta
    mla_rope = attn_mod.mla_rope(cfg, positions) if cfg.mla is not None else None
    drops = []
    for key, ffn, n, first in _attn_stacks(cfg):
        windows, thetas, use_rope = layer_meta(cfg, n, first)
        for j in range(n):
            rope = mla_rope
            if mla_rope is None and use_rope[j]:
                if thetas[j] not in angles:
                    angles[thetas[j]] = rope_angles(positions, thetas[j], cfg.head_dim)
                rope = angles[thetas[j]]
            cache_l = None if cache is None else {k: v[first + j] for k, v in cache.items()}
            x, metrics = _attn_block_body(cfg, _layer(params[key], j), x, positions,
                                          windows[j], thetas[j], use_rope[j], cache_l,
                                          cache_pos, rope, ffn)
            if metrics:
                drops.append(metrics["moe_drop_fraction"])
    if not drops:
        return x, {}
    # the mean as the reference's jnp.mean computes it: the sum times 1/n
    return x, {"moe_drop_fraction": torch.stack(drops).sum() * (1.0 / len(drops))}


def _run_stacks(params, cfg, x, positions, *, cache=None, cache_pos=None, decode=False):
    """The model's stacks and the final norm: (h, metrics)."""
    metrics: Dict[str, torch.Tensor] = {}
    if cfg.family == "ssm":
        x = _ssm_layers(params["layers"], cfg, x, range(cfg.num_layers), cache=cache,
                        decode=decode)
    elif cfg.family == "hybrid":
        x = _run_hybrid(params, cfg, x, positions, cache=cache, cache_pos=cache_pos,
                        decode=decode)
    else:
        x, metrics = _run_attn_layers(params, cfg, x, positions, cache=cache,
                                      cache_pos=cache_pos)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), metrics


def _embed_codebooks(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Audio: the sum over codebooks k of table[k][tokens[:, k]], in the
    table's dtype; tokens [B, K, S] -> [B, S, d]."""
    x = table[0][tokens[:, 0]]
    for k in range(1, table.shape[0]):
        x = x + table[k][tokens[:, k]]
    return x


def _embed_input(params, cfg, batch) -> torch.Tensor:
    """The stack's input [B, S, d]: the codebook sum for audio (tokens
    [B, K, S]); for vision with ``batch["vision_embeds"]`` [B, P, d_frontend]
    the projected patches tanh(v @ w1 + b1) @ w2 + b2 in front of the
    tokens' embeddings (positions then run over P + S)."""
    tokens = batch["tokens"]
    if cfg.modality == "audio":
        return _embed_codebooks(params["embed"]["table"], tokens)
    x = embed_fn(params["embed"], tokens, cfg)
    if cfg.modality == "vision" and "vision_embeds" in batch:
        pj = params["projector"]
        v = batch["vision_embeds"].to(device=x.device, dtype=x.dtype)
        v = torch.tanh(v @ pj["w1"] + pj["b1"]) @ pj["w2"] + pj["b2"]
        x = torch.cat([v, x], dim=1)
    return x


def _unembed_table(params, cfg):
    return params["embed"]["table"] if cfg.tie_embeddings else params["unembed"]["table"]


def _logits(params, cfg, last: torch.Tensor) -> torch.Tensor:
    """float32 logits of the last hidden state [B, d]: [B, V], or audio's
    [B, K, V] from the per-codebook heads."""
    if cfg.modality == "audio":
        return torch.einsum("bd,kdv->bkv", last.to(F32), params["heads"].to(F32))
    return unembed_logits(_unembed_table(params, cfg), last, cfg)


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[0], x.shape[1]
    return torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)


@torch.no_grad()
def forward(params, cfg, batch):
    """The stack over ``batch`` without a cache: the final-normed hidden
    states [B, S, d] and the metrics (a MoE model's ``moe_drop_fraction``,
    the mean over its MoE layers; {} otherwise)."""
    _require_ported(cfg)
    x = _embed_input(params, cfg, batch)
    return _run_stacks(params, cfg, x, _positions(x))


@torch.no_grad()
def prefill(params, cfg, batch, cache):
    """Run the prompt ``batch["tokens"]`` [B, S] (audio: [B, K, S]; vision
    may add ``batch["vision_embeds"]``) through the stack, filling ``cache``
    in place (attention: rows 0..S-1, the rest cleared; SSM: the conv tail
    and the state, overwritten, the scan started from a zero state); return
    the last position's float32 logits [B, V] (audio: [B, K, V]) and the
    cache."""
    _require_ported(cfg)
    x = _embed_input(params, cfg, batch)
    h, _ = _run_stacks(params, cfg, x, _positions(x), cache=cache)
    return _logits(params, cfg, h[:, -1]), cache


@torch.no_grad()
def decode_step(params, cfg, tokens, pos, cache):
    """One decode step. tokens [B, 1] (audio: [B, K, 1]), pos [B] (the row
    each new token occupies; the SSM family does not read it); the cache is
    written in place. Returns float32 logits [B, V] (audio: [B, K, V]) and
    the cache."""
    _require_ported(cfg)
    if cfg.modality == "audio":
        x = _embed_codebooks(params["embed"]["table"], tokens)
    else:
        x = embed_fn(params["embed"], tokens, cfg)
    pos = pos.to(device=x.device, dtype=torch.int64)
    h, _ = _run_stacks(params, cfg, x, pos[:, None], cache=cache, cache_pos=pos, decode=True)
    return _logits(params, cfg, h[:, 0]), cache
