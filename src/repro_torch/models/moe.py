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

Under ``distributed.sharding.use_mesh`` with a ``model`` axis that
divides the experts, ``moe_ffn`` takes the expert-parallel form, the
reference's ``_moe_ffn_sharded`` (a ``shard_map``) on the single-controller
``Mesh``: the batch is split over ``pod`` and ``data`` (while their product
divides it), and each batch shard's tokens go to every ``model`` position.
Position m routes them with the full router, dispatches only the
assignments to its experts [m E_loc, (m + 1) E_loc) into an
[E_loc, C, D] buffer (the capacity C from the shard's token count), runs
its experts and its F-slice of the shared experts, and keeps the partial
output in x's dtype, as each rank of the reference does before its
``psum``. The partials are summed over ``model`` in position order on the
first position's device, and the drop fraction is the dropped over the
assigned summed over ``model``, then its mean over the batch shards.
Positions run one after another; weights move to a position's device only
where it is another (positions that repeat a device take views).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import FSDP, TP, current_mesh
from repro_torch.models.layers import (
    F32,
    activation,
    dense_init,
    param_dtype,
    stack_spec,
    zeros_init,
)

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


def moe_specs(cfg, stacked: int = 0) -> dict:
    """``init_moe``'s spec tree: experts over ``TP``, the model width over
    ``FSDP``, the router's table over ``FSDP`` (its bias replicated)."""
    mo = cfg.moe
    specs = {
        "router": stack_spec((FSDP, None), stacked),
        "w_gate": stack_spec((TP, FSDP, None), stacked),
        "w_up": stack_spec((TP, FSDP, None), stacked),
        "w_down": stack_spec((TP, None, FSDP), stacked),
    }
    if mo.router == "sigmoid_bias":
        specs["router_bias"] = stack_spec((None,), stacked)
    if mo.num_shared_experts:
        specs["shared_gate"] = stack_spec((FSDP, TP), stacked)
        specs["shared_up"] = stack_spec((FSDP, TP), stacked)
        specs["shared_down"] = stack_spec((TP, FSDP), stacked)
    return specs


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


def _dispatch_compute(params, cfg, x_flat, expert_idx, gates, capacity: int,
                      e_lo: int = 0, num_local_experts: int = 0):
    """Capacity dispatch and the expert products over all T tokens. Returns
    (y [T, D], dropped assignments, assignments), the counts float32.

    ``e_lo`` / ``num_local_experts`` restrict it to an expert shard (the
    mesh form): ``params`` then hold experts [e_lo, e_lo + n_loc), and the
    assignments to other experts go to a drop bucket (another position
    serves them) and count neither as assigned nor as dropped."""
    mo = cfg.moe
    T, D = x_flat.shape
    K = mo.top_k
    E_loc = num_local_experts or mo.num_experts
    dev = x_flat.device

    if num_local_experts:
        rel = expert_idx - e_lo
        in_shard = ((rel >= 0) & (rel < E_loc)).reshape(-1)
        flat_e = torch.where(in_shard, rel.reshape(-1), E_loc)  # E_loc = the drop bucket
    else:
        in_shard = None
        flat_e = expert_idx.reshape(-1)  # every id is in [0, E)
    buckets = E_loc + (in_shard is not None)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # bincount as a scatter-add (torch.bincount on the card reads its max on the host)
    counts = torch.zeros(buckets, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - offsets[sorted_e]
    kept = rank < capacity
    if in_shard is not None:
        kept = kept & (sorted_e < E_loc)
    slot = torch.where(kept, rank, capacity)

    token_of = order // K
    buf = x_flat.new_zeros((buckets, capacity + 1, D))  # column `capacity` takes the drops
    buf[sorted_e, slot] = x_flat[token_of]
    buf = buf[:E_loc, :capacity]

    h = activation(torch.einsum("ecd,edf->ecf", buf, params["w_gate"]), cfg.act)
    h = h * torch.einsum("ecd,edf->ecf", buf, params["w_up"])
    out_buf = torch.einsum("ecf,efd->ecd", h, params["w_down"])

    y_sorted = out_buf[torch.clamp(sorted_e, max=E_loc - 1), torch.clamp(slot, max=capacity - 1)]
    y_sorted = torch.where(kept[:, None], y_sorted, 0)
    inv = torch.argsort(order, stable=True)
    y_flat = y_sorted[inv].reshape(T, K, D)
    y = torch.sum(y_flat.to(F32) * gates[..., None], dim=1).to(x_flat.dtype)

    if in_shard is None:
        dropped = torch.sum((~kept).to(F32))
        total_assigned = torch.full((), float(max(T * K, 1)), dtype=F32, device=dev)
    else:
        assigned = in_shard[order]
        dropped = torch.sum((assigned & ~kept).to(F32))
        total_assigned = torch.clamp(torch.sum(assigned.to(F32)), min=1.0)
    return y, dropped, total_assigned


def capacity_of(cfg, tokens: int, capacity_factor: float = 0.0) -> int:
    """Slots per expert for ``tokens`` tokens: the reference's
    max(ceil(T k / E cf), min(8, T)), in Python floats as it computes it."""
    mo = cfg.moe
    cf = capacity_factor or mo.capacity_factor
    return max(int(math.ceil(tokens * mo.top_k / mo.num_experts * cf)), min(8, tokens))


def moe_ffn(params, cfg, x: torch.Tensor,  # repro: device-region static[cfg, capacity_factor]
            capacity_factor: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> ([B, S, D], {"moe_drop_fraction": float32 scalar}).
    Under ``use_mesh`` with a ``model`` axis that divides the experts this
    is the expert-parallel form (``_moe_ffn_sharded``); otherwise
    everything is local."""
    mo = cfg.moe
    mesh = current_mesh()
    if mesh is not None and "model" in mesh.axis_names and (
            mo.num_experts % mesh.shape["model"] == 0):
        return _moe_ffn_sharded(params, cfg, x, mesh, capacity_factor)
    B, S, D = x.shape
    capacity = capacity_of(cfg, B * S, capacity_factor)
    x_flat = x.reshape(B * S, D)
    expert_idx, gates = _route(params, cfg, x_flat)
    y, dropped, assigned = _dispatch_compute(params, cfg, x_flat, expert_idx, gates, capacity)
    if mo.num_shared_experts:
        hs = activation(x_flat @ params["shared_gate"], cfg.act) * (x_flat @ params["shared_up"])
        y = y + hs @ params["shared_down"]
    return y.reshape(B, S, D), {"moe_drop_fraction": dropped / assigned}


def batch_axes(mesh, B: int) -> Tuple[Tuple[str, ...], int]:
    """The batch axes among ("pod", "data"), each kept while the product
    of the kept axes divides B, and that product."""
    axes, n = [], 1
    for a in ("pod", "data"):
        if a in mesh.axis_names and B % (n * mesh.shape[a]) == 0:
            axes.append(a)
            n *= mesh.shape[a]
    return tuple(axes), n


# repro: device-region static[cfg, mesh, capacity_factor]
def _moe_ffn_sharded(params, cfg, x: torch.Tensor, mesh, capacity_factor: float = 0.0
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The expert-parallel form on ``mesh`` (see the module docstring)."""
    mo = cfg.moe
    B, S, D = x.shape
    axes, n_batch = batch_axes(mesh, B)
    n_model = mesh.shape["model"]
    E_loc = mo.num_experts // n_model
    B_loc = B // n_batch
    capacity = capacity_of(cfg, B_loc * S, capacity_factor)
    Fs = mo.d_ff_shared * mo.num_shared_experts
    if Fs % n_model:
        raise ValueError(f"shared experts' width {Fs} does not split over model={n_model}")
    Fs_loc = Fs // n_model
    sizes = [mesh.shape[a] for a in axes]
    out_dev = mesh.devices.flat[0]
    ys, fracs = [], []
    for b, shard in enumerate(np.ndindex(*sizes)):
        # replicas along the axes the batch does not use compute the same:
        # index 0 of them serves
        coords = dict.fromkeys(mesh.axis_names, 0)
        coords.update(zip(axes, shard))
        x_b = x[b * B_loc:(b + 1) * B_loc]
        y_b = dropped = assigned = None
        for m in range(n_model):
            coords["model"] = m
            dev = mesh.devices[tuple(coords[a] for a in mesh.axis_names)]
            x_flat = x_b.to(dev).reshape(B_loc * S, D)
            rp = {k: params[k].to(dev) for k in FLOAT32_PARAMS if k in params}
            expert_idx, gates = _route(rp, cfg, x_flat)
            sl = slice(m * E_loc, (m + 1) * E_loc)
            lp = {k: params[k][sl].to(dev) for k in ("w_gate", "w_up", "w_down")}
            y, d_m, a_m = _dispatch_compute(lp, cfg, x_flat, expert_idx, gates, capacity,
                                            e_lo=m * E_loc, num_local_experts=E_loc)
            if mo.num_shared_experts:
                fs = slice(m * Fs_loc, (m + 1) * Fs_loc)
                hs = (activation(x_flat @ params["shared_gate"][:, fs].to(dev), cfg.act)
                      * (x_flat @ params["shared_up"][:, fs].to(dev)))
                y = y + hs @ params["shared_down"][fs].to(dev)
            y, d_m, a_m = y.to(out_dev), d_m.to(out_dev), a_m.to(out_dev)
            if y_b is None:
                y_b, dropped, assigned = y, d_m, a_m
            else:  # the psum over model, in position order
                y_b, dropped, assigned = y_b + y, dropped + d_m, assigned + a_m
        ys.append(y_b.reshape(B_loc, S, D))
        fracs.append(dropped / assigned)
    frac = fracs[0]
    for f in fracs[1:]:
        frac = frac + f
    if axes:  # the pmean over the batch axes
        frac = frac / n_batch
    return torch.cat(ys, 0), {"moe_drop_fraction": frac}
