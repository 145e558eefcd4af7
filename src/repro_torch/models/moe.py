"""Mixture-of-Experts FFN with capacity-based sort dispatch (the port of the
local path of the reference's ``models/moe.py``).

  1. router logits in float32 -> top-k (expert id, gate weight) per token
  2. flatten the (token, k) assignments, stable-sort them by expert id
  3. rank within the expert from exclusive cumulative counts
  4. scatter the tokens into an [E, C, D] buffer (slots >= capacity drop)
  5. dense per-expert products over the whole buffer: every expert is
     computed, an empty one too, as in the reference
  6. gather back, weight by the gates in float32, sum over k; add the
     shared experts

The reference computes all of this outside Pallas (XLA's sort, scatter,
gather and einsums), so this module holds no kernel: it runs plain torch
on every device, as the reference leaves it to XLA. Routing is a discrete
decision, like a cache hit: the router's product is float32 (callers that
compare with the reference run with TF32 off, ``backend.full_fp32``), and
the top-k breaks ties to the lower expert index, as ``lax.top_k`` does,
through a stable descending sort (``torch.topk`` promises no order for
ties). The reference's ``mode="drop"`` scatter silently drops the
assignments past an expert's capacity; here they land in one spare slot
column that is sliced off, so no index is out of range and nothing waits
on the host.

The expert-parallel mesh form (the reference's ``_moe_ffn_sharded``, under
``shard_map``) comes with the distributed port (ROADMAP queue A item A12).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.models.layers import F32, activation, dense_init, param_dtype, zeros_init

# leaves the reference keeps in float32 whatever the model's dtype
FLOAT32_PARAMS = ("router", "router_bias")


def _experts(gen, E: int, shape, fan_in: int, dtype, stacked: int, device) -> torch.Tensor:
    """[(stacked,) E, *shape], drawn one expert at a time (one of
    deepseek-v3's [256, 7168, 2048] stacks drawn at once would need 15 GB of
    float32 scratch)."""
    w = dense_init(gen, shape, fan_in=fan_in, dtype=dtype, stacked=max(stacked, 1) * E,
                   device=device)
    return w.view(((stacked,) if stacked else ()) + (E,) + tuple(shape))


def init_moe(gen, cfg, stacked: int = 0, device=None) -> dict:
    """The router [D, E] (and ``router_bias`` [E] for ``sigmoid_bias``) in
    float32, the experts' w_gate/w_up [E, D, F] and w_down [E, F, D], and the
    shared experts' gated MLP, in the model's dtype."""
    mo = cfg.moe
    D, E, Fd = cfg.d_model, mo.num_experts, mo.d_ff_expert
    dt = param_dtype(cfg)
    kw = dict(dtype=dt, stacked=stacked, device=device)
    params = {
        "router": dense_init(gen, (D, E), dtype=F32, stacked=stacked, device=device),
        "w_gate": _experts(gen, E, (D, Fd), D, **kw),
        "w_up": _experts(gen, E, (D, Fd), D, **kw),
        "w_down": _experts(gen, E, (Fd, D), Fd, **kw),
    }
    if mo.router == "sigmoid_bias":
        params["router_bias"] = zeros_init((E,), F32, stacked, device)
    if mo.num_shared_experts:
        Fs = mo.d_ff_shared * mo.num_shared_experts
        params["shared_gate"] = dense_init(gen, (D, Fs), **kw)
        params["shared_up"] = dense_init(gen, (D, Fs), **kw)
        params["shared_down"] = dense_init(gen, (Fs, D), fan_in=Fs, **kw)
    return params


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, cfg, x_flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(expert_idx [T, k] int64, gate weights [T, k] float32)."""
    mo = cfg.moe
    logits = x_flat.to(F32) @ params["router"].to(F32)  # [T, E]
    if mo.router == "sigmoid_bias":
        # choose by score + bias, weigh by the unbiased scores
        scores = torch.sigmoid(logits)
        _, idx = _top_k(scores + params["router_bias"].to(F32)[None, :], mo.top_k)
        gates = torch.gather(scores, -1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        gates = gates * mo.routed_scaling
    else:
        gates, idx = _top_k(torch.softmax(logits, dim=-1), mo.top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return idx, gates


def _dispatch_compute(params, cfg, x_flat, expert_idx, gates, capacity: int):
    """Capacity dispatch and the expert products over all T tokens. Returns
    (y [T, D], dropped assignments, assignments), the counts float32."""
    mo = cfg.moe
    T, D = x_flat.shape
    K, E = mo.top_k, mo.num_experts
    dev = x_flat.device

    flat_e = expert_idx.reshape(-1)  # every id is in [0, E): no expert shard here
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # bincount as a scatter-add (torch.bincount on the card reads its max on the host)
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - offsets[sorted_e]
    kept = rank < capacity
    slot = torch.where(kept, rank, capacity)

    token_of = order // K
    buf = x_flat.new_zeros((E, capacity + 1, D))  # column `capacity` takes the drops
    buf[sorted_e, slot] = x_flat[token_of]
    buf = buf[:, :capacity]

    h = activation(torch.einsum("ecd,edf->ecf", buf, params["w_gate"]), cfg.act)
    h = h * torch.einsum("ecd,edf->ecf", buf, params["w_up"])
    out_buf = torch.einsum("ecf,efd->ecd", h, params["w_down"])

    y_sorted = out_buf[sorted_e, torch.clamp(slot, max=capacity - 1)]
    y_sorted = torch.where(kept[:, None], y_sorted, 0)
    inv = torch.argsort(order, stable=True)
    y_flat = y_sorted[inv].reshape(T, K, D)
    y = torch.sum(y_flat.to(F32) * gates[..., None], dim=1).to(x_flat.dtype)

    dropped = torch.sum((~kept).to(F32))
    total_assigned = torch.tensor(float(max(T * K, 1)), dtype=F32, device=dev)
    return y, dropped, total_assigned


def capacity_of(cfg, tokens: int, capacity_factor: float = 0.0) -> int:
    """Slots per expert for ``tokens`` tokens: the reference's
    max(ceil(T k / E cf), min(8, T)), in Python floats as it computes it."""
    mo = cfg.moe
    cf = capacity_factor or mo.capacity_factor
    return max(int(math.ceil(tokens * mo.top_k / mo.num_experts * cf)), min(8, tokens))


def moe_ffn(params, cfg, x: torch.Tensor,
            capacity_factor: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> ([B, S, D], {"moe_drop_fraction": float32 scalar})."""
    mo = cfg.moe
    B, S, D = x.shape
    capacity = capacity_of(cfg, B * S, capacity_factor)
    x_flat = x.reshape(B * S, D)
    expert_idx, gates = _route(params, cfg, x_flat)
    y, dropped, assigned = _dispatch_compute(params, cfg, x_flat, expert_idx, gates, capacity)
    if mo.num_shared_experts:
        hs = activation(x_flat @ params["shared_gate"], cfg.act) * (x_flat @ params["shared_up"])
        y = y + hs @ params["shared_down"]
    return y.reshape(B, S, D), {"moe_drop_fraction": dropped / assigned}
