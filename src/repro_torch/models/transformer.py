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
"mtp" {"block", "norm1", "norm2", "proj"}, whose forward runs in
``loss_fn`` only (training), as in the reference.

API (the reference's names):
  init_params(cfg, seed=0, device=None)          -> params
  param_specs(cfg), cache_specs(cfg)             -> the reference's spec trees
                                                    (``init_params(...)[1]``,
                                                    ``init_cache(...)[1]``)
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
  loss_fn(params, cfg, batch)                    -> (loss, metrics)   (training)
  prefill(params, cfg, batch, cache)             -> (last_logits, cache)
  decode_step(params, cfg, tokens, pos, cache)   -> (logits, cache)
The cache is updated in place and returned for the reference's signature.

Serving (``forward``, ``prefill``, ``decode_step``) runs under
``torch.no_grad()``. ``loss_fn`` runs the same stacks with autograd
recording (``_forward``): with ``cfg.remat`` each layer (a Mamba2 block, an
attention block, a hybrid's shared block) is one ``torch.utils.checkpoint``
call (``use_reentrant=False``), its activations recomputed in backward;
``remat_policy="dots"`` keeps the matrix products' outputs through a
selective-checkpoint context and recomputes the rest, as the reference's
``dots_with_no_batch_dims_saveable`` policy does. On the card the
attention kernel's backward is a kernel (``FlashAttentionFn``); the
kernels without one raise under grad (``kernels/*/ops.py``).

On ``device="meta"`` ``init_params`` and ``init_cache`` give every leaf
its shape and dtype and draw nothing (the dry run's ``eval_shape``). Under
``distributed.sharding.use_mesh`` each block's output passes
``constrain(x, (BATCH, None, None))``, where the reference constrains it,
and the MoE blocks take their expert-parallel form.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import PORTED_FAMILIES
from repro_torch.distributed.sharding import BATCH, FSDP, TP, constrain
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    F32,
    chunked_ce_loss,
    cross_entropy,
    dense_init,
    embed as embed_fn,
    embedding_specs,
    init_embedding,
    init_generator,
    init_mlp,
    mlp,
    mlp_specs,
    ones_init,
    param_dtype,
    rms_norm,
    rope_angles,
    stack_spec,
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


# the products "dots" keeps for backward (the reference's
# dots_with_no_batch_dims_saveable: matmul outputs saved, the rest recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """``fn`` run under ``torch.utils.checkpoint`` when autograd records
    (training: serving runs under ``torch.no_grad()``) and ``cfg.remat`` is
    on, else ``fn`` itself."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


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
    on ``device`` (None = CUDA, raising without one); on ``meta`` the
    shapes and dtypes only."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = init_generator(dev, seed)
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


def _attn_stack_specs(cfg, n: int, ffn: str = "mlp") -> Params:
    """``_init_attn_stack``'s spec tree (the norms' width over ``FSDP``)."""
    specs: Params = {"ln1": (None, FSDP), "ln2": (None, FSDP)}
    if cfg.post_norms:
        specs["ln1_post"] = (None, FSDP)
        specs["ln2_post"] = (None, FSDP)
    specs["attn"] = attn_mod.mla_specs(n) if cfg.mla is not None else attn_mod.attn_specs(cfg, n)
    specs["ffn"] = moe_mod.moe_specs(cfg, n) if ffn == "moe" else mlp_specs(cfg, n)
    return specs


def _ssm_stack_specs(n: int) -> Params:
    return {"ln": (None, FSDP), "ssm": ssm_mod.ssm_specs(n)}


def param_specs(cfg) -> Params:
    """The spec tree of ``init_params(cfg)``: the reference's
    ``init_params(cfg, key)[1]``, leaf for leaf."""
    _require_ported(cfg)
    specs: Params = {}
    if cfg.modality == "audio":
        specs["embed"] = {"table": (None, TP, FSDP)}
        specs["heads"] = (None, FSDP, TP)
    else:
        specs["embed"] = embedding_specs()
        if not cfg.tie_embeddings:
            specs["unembed"] = embedding_specs()
    if cfg.modality == "vision":
        specs["projector"] = {"w1": (None, FSDP), "b1": (None,), "w2": (FSDP, None),
                              "b2": (None,)}
    specs["final_norm"] = (FSDP,)
    if cfg.family == "ssm":
        specs["layers"] = _ssm_stack_specs(cfg.num_layers)
    elif cfg.family == "hybrid":
        specs["mamba"] = _ssm_stack_specs(cfg.num_layers)
        specs["shared"] = _attn_stack_specs(cfg, cfg.num_shared_blocks)
        specs["shared"]["down"] = (None, FSDP, None)
    elif cfg.moe is not None:
        fkd = cfg.moe.first_k_dense
        if fkd:
            specs["dense_layers"] = _attn_stack_specs(cfg, fkd)
        specs["moe_layers"] = _attn_stack_specs(cfg, cfg.num_layers - fkd, ffn="moe")
        if cfg.mtp_depth:
            specs["mtp"] = {"block": _attn_stack_specs(cfg, 1, ffn="moe"), "norm1": (FSDP,),
                            "norm2": (FSDP,), "proj": (FSDP, None)}
    else:
        specs["layers"] = _attn_stack_specs(cfg, cfg.num_layers)
    return specs


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


def _stacked_specs(one: Params) -> Params:
    return {k: stack_spec(v, 1) for k, v in one.items()}


def cache_specs(cfg) -> Params:
    """The spec tree of ``init_cache(cfg, ...)``: the reference's
    ``init_cache(...)[1]`` (a replicated layer axis in front)."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        return _stacked_specs(ssm_mod.ssm_cache_specs())
    if cfg.family == "hybrid":
        return {"mamba": _stacked_specs(ssm_mod.ssm_cache_specs()),
                "shared": _stacked_specs(attn_mod.attn_cache_specs())}
    if cfg.mla is not None:
        return _stacked_specs(attn_mod.mla_cache_specs())
    return _stacked_specs(attn_mod.attn_cache_specs())


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
    return constrain(x + f_out, (BATCH, None, None)), metrics


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _ssm_layers(stack, cfg, x, layers, *, cache=None, decode=False):
    for i in layers:
        lp = _layer(stack, i)
        cache_l = None if cache is None else {k: v[i] for k, v in cache.items()}

        def block(x, lp=lp, cache_l=cache_l):
            h = rms_norm(x, lp["ln"], cfg.norm_eps)
            out = ssm_mod.ssm_block(lp["ssm"], cfg, h, cache=cache_l, decode=decode)
            return constrain(x + out, (BATCH, None, None))

        x = _remat(block, cfg)(x)
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
        x = _remat(functools.partial(_shared_block_apply, cfg, sp), cfg)(
            x, x0, positions, sc, cache_pos, rope)
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


def layer_stacks(cfg, train: bool = False) -> Dict[Tuple[str, ...], int]:
    """The parameter tree's stacks of layers by path (every leaf below one
    holds the layer on axis 0, ``stack_spec``'s leading None), each with how
    many layers one forward pass applies from it: the hybrid's shared
    blocks once per group, the MTP block in training only. Each layer is
    one remat unit."""
    if cfg.family == "ssm":
        return {("layers",): cfg.num_layers}
    if cfg.family == "hybrid":
        return {("mamba",): cfg.num_layers, ("shared",): _zamba_groups(cfg)[0]}
    stacks = {(key,): n for key, _, n, _ in _attn_stacks(cfg)}
    if cfg.moe is not None and cfg.mtp_depth:
        stacks[("mtp", "block")] = int(train)
    return stacks


def head_passes(cfg, train: bool = False) -> int:
    """How many times one forward pass looks tokens up in the embedding and
    projects onto the vocabulary: twice in training with the MTP head."""
    return 2 if train and cfg.moe is not None and cfg.mtp_depth else 1


def _attn_layers(stack, cfg, x, positions, *, ffn: str, n: int, first: int = 0, cache=None,
                 cache_pos=None, angles=None, mla_rope=None, drops=None):
    """n attention blocks of one stack, the first being layer ``first`` of
    the pattern and of the stacked ``cache``; ``angles`` shares one
    (cos, sin) per theta across stacks, ``drops`` collects the MoE blocks'
    drop fractions."""
    angles = {} if angles is None else angles
    windows, thetas, use_rope = layer_meta(cfg, n, first)
    for j in range(n):
        rope = mla_rope
        if mla_rope is None and use_rope[j]:
            if thetas[j] not in angles:
                angles[thetas[j]] = rope_angles(positions, thetas[j], cfg.head_dim)
            rope = angles[thetas[j]]
        cache_l = None if cache is None else {k: v[first + j] for k, v in cache.items()}
        block = functools.partial(_attn_block_body, cfg, _layer(stack, j))
        x, metrics = _remat(block, cfg)(x, positions, windows[j], thetas[j], use_rope[j],
                                        cache_l, cache_pos, rope, ffn)
        if metrics and drops is not None:
            drops.append(metrics["moe_drop_fraction"])
    return x


def _run_attn_layers(params, cfg, x, positions, *, cache=None, cache_pos=None):
    """The attention stacks (a MoE model's dense then MoE layers) over the
    layers' views of the one stacked cache; the metrics are the MoE layers'
    ``moe_drop_fraction`` averaged, as the reference's scan averages them."""
    angles: Dict[float, Tuple[torch.Tensor, torch.Tensor]] = {}  # one (cos, sin) per theta
    mla_rope = attn_mod.mla_rope(cfg, positions) if cfg.mla is not None else None
    drops: List[torch.Tensor] = []
    for key, ffn, n, first in _attn_stacks(cfg):
        x = _attn_layers(params[key], cfg, x, positions, ffn=ffn, n=n, first=first,
                         cache=cache, cache_pos=cache_pos, angles=angles, mla_rope=mla_rope,
                         drops=drops)
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


def _forward(params, cfg, batch):
    """The stack over ``batch`` without a cache, recorded by autograd when
    it is enabled (each layer checkpointed under ``cfg.remat``):
    (h [B, S, d], positions [B, S], metrics)."""
    _require_ported(cfg)
    x = _embed_input(params, cfg, batch)
    positions = _positions(x)
    h, metrics = _run_stacks(params, cfg, x, positions)
    return h, positions, metrics


@torch.no_grad()
def forward(params, cfg, batch):  # repro: device-region static[cfg]
    """The stack over ``batch`` without a cache: the final-normed hidden
    states [B, S, d] and the metrics (a MoE model's ``moe_drop_fraction``,
    the mean over its MoE layers; {} otherwise)."""
    h, _, metrics = _forward(params, cfg, batch)
    return h, metrics


def loss_fn(params, cfg, batch):
    """Next-token CE, the reference's ``loss_fn``: chunked over the sequence
    (``layers.chunked_ce_loss``) against the unembedding; audio's CE over
    every codebook's head ([B, K, S] tokens); vision with
    ``vision_embeds`` [B, P, d_frontend] predicts the text tokens only,
    from the last patch's position on; with ``mtp_depth`` (deepseek-v3)
    0.3 times the MTP head's CE on the token after next is added and
    reported as ``mtp_loss``. Autograd records it; each layer is
    rematerialised under ``cfg.remat``. Returns (loss, metrics)."""
    h, positions, metrics = _forward(params, cfg, batch)
    tokens = batch["tokens"]
    if cfg.modality == "audio":
        logits = torch.einsum("bsd,kdv->bksv", h[:, :-1].to(F32), params["heads"].to(F32))
        loss, _ = cross_entropy(logits, tokens[:, :, 1:])
        return loss, metrics

    table = _unembed_table(params, cfg)
    if cfg.modality == "vision" and "vision_embeds" in batch:
        P = batch["vision_embeds"].shape[1]
        h_pred, labels = h[:, P - 1:-1], tokens  # the text tokens 0..S-1
    else:
        h_pred, labels = h[:, :-1], tokens[:, 1:]
    loss, _ = chunked_ce_loss(table, h_pred, labels, cfg)

    if cfg.mtp_depth and "mtp" in params:
        mtp = params["mtp"]
        emb_next = embed_fn(params["embed"], tokens[:, 1:], cfg)
        h_in = torch.cat([rms_norm(h[:, :-1], mtp["norm1"], cfg.norm_eps),
                          rms_norm(emb_next, mtp["norm2"], cfg.norm_eps)], dim=-1) @ mtp["proj"]
        pos = positions[:, :h_in.shape[1]]
        mla_rope = attn_mod.mla_rope(cfg, pos) if cfg.mla is not None else None
        h_mtp = _attn_layers(mtp["block"], cfg, h_in, pos, ffn="moe", n=1, mla_rope=mla_rope)
        mtp_loss, _ = chunked_ce_loss(table, h_mtp[:, :-1], tokens[:, 2:], cfg)
        loss = loss + 0.3 * mtp_loss
        metrics = dict(metrics, mtp_loss=mtp_loss)
    return loss, metrics


@torch.no_grad()
def prefill(params, cfg, batch, cache):  # repro: device-region static[cfg]
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
def decode_step(params, cfg, tokens, pos, cache):  # repro: device-region static[cfg]
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
