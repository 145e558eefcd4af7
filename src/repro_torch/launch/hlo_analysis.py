"""Collective bytes per device for the dry run, from the spec trees (the port
of the reference's ``launch/hlo_analysis.py``).

The reference parses the partitioned HLO that XLA's SPMD partitioner
writes and adds up the operand bytes of every collective instruction,
per device, weighted by loop trip counts. The port has no HLO: its
model runs eagerly, and on a mesh of cards only the MoE's expert-parallel
form splits work by position. This module keeps the reference's contract
— bytes per device for each of ``COLLECTIVES``, plus ``"total"``, each an
instruction's OPERAND bytes on one device — and computes them from the
resolved spec trees by stated rules, one function each:

``fsdp_all_gather``
    every parameter sharded over ``data`` (FSDP) is gathered before its
    use: operand = its per-device shard, once per forward pass, again in
    the backward pass of a train step under ``cfg.remat``.
``grad_reduce_scatter``
    a train step's gradient of a ``data``-sharded parameter is
    reduce-scattered over ``data``: operand = the gradient's block before
    the scatter (the shard times the ``data`` split); a parameter
    replicated over ``data`` has its gradient all-reduced instead
    (operand = its block), where ``data`` > 1.
``tp_all_reduce``
    a product whose contracted dimension is ``model``-sharded leaves
    partial sums that are all-reduced over ``model``: operand = the
    product's output block [tokens per device, output features]. Forward
    products contract the weight's input dimensions (``PRODUCTS``); a
    train step's backward product dx = dy W^T contracts its output
    dimensions, and under ``cfg.remat`` a layer's forward runs twice. The
    embedding lookup on a vocabulary-sharded table counts as a product
    contracting the vocabulary (with no dx); the unembedding (the tied
    table, the untied one, audio's heads) contracts the model width
    forward and the vocabulary in its backward. A layer's uses come from
    ``transformer.layer_stacks``, the embedding's from ``head_passes``.
``moe_psum``
    each MoE layer's expert-parallel form sums its partial outputs over
    ``model``: operand = [tokens per batch shard, d_model] in the
    activations' dtype, per forward pass (twice under remat in training)
    and once more in backward.
``pod_grad_all_reduce``
    on a mesh with ``pod`` > 1, every gradient block left after the
    ``data`` reduce-scatter is all-reduced over ``pod``.
``cache_candidate_gather``
    the sharded cache lookup gathers each position's [Q, k] scores
    (float32) and ids (int32) over each shard axis, innermost first (the
    hierarchical merge).

Where XLA may differ: it may fuse or combine collectives (one all-gather
for several leaves, all-reduce as reduce-scatter + all-gather), keep a
gathered weight alive across forward and backward instead of gathering it
again, shard activations over ``model`` between products (sequence
parallelism, turning all-reduces into reduce-scatters and all-gathers),
all-reduce the softmax statistics of a vocabulary-sharded cross entropy
(not counted here), and choose its own layout where a spec leaves a
dimension free. These rules count what the specs force; they are a
model of the partitioned program, not a trace of one.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import NamedSharding, shardings_for, tree_map_specs
from repro_torch.models.transformer import head_passes, layer_stacks

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


class Product(NamedTuple):
    """A product of the activations with a weight of rank ``rank`` (axes
    before it index the weight's applications: a stack's layer, audio's
    codebook) contracting the weight's axes ``contracted``; ``backward``:
    a train step computes dx through it (an embedding lookup has no dx)."""
    rank: int
    contracted: Tuple[int, ...]
    backward: bool = True


_LOOKUP = Product(2, (0,), backward=False)  # a one-hot product over the vocabulary
_UNEMBED = Product(2, (1,))  # h [.., d] @ table[V, d]^T

# weight leaf -> its products; leaves absent here are no product (norms,
# biases, the depthwise conv), are never sharded over ``model`` (the
# projector, the hybrid's down projection, the MTP's projection), or are
# counted by another rule (the MoE's experts, shared experts and router:
# ``moe_psum``)
PRODUCTS = {
    ("attn", "wq"): (Product(3, (0,)),), ("attn", "wk"): (Product(3, (0,)),),
    ("attn", "wv"): (Product(3, (0,)),), ("attn", "wo"): (Product(3, (0, 1)),),
    ("attn", "wq_a"): (Product(2, (0,)),), ("attn", "wq_b"): (Product(3, (0,)),),
    ("attn", "wkv_a"): (Product(2, (0,)),), ("attn", "wkv_b"): (Product(3, (0,)),),
    ("ffn", "wi"): (Product(2, (0,)),), ("ffn", "wi_gate"): (Product(2, (0,)),),
    ("ffn", "wi_up"): (Product(2, (0,)),), ("ffn", "wo"): (Product(2, (0,)),),
    ("ssm", "in_proj"): (Product(2, (0,)),), ("ssm", "out_proj"): (Product(2, (0,)),),
    ("embed", "table"): (_LOOKUP,),
    ("unembed", "table"): (_UNEMBED,),
    ("heads",): (Product(2, (0,)),),  # audio's [K, d, V], one per codebook
}


def _products(path: Tuple, cfg) -> Tuple[Product, ...]:
    key = tuple(path[-2:])
    found = PRODUCTS.get(key, ())
    if key == ("embed", "table") and cfg.tie_embeddings and cfg.modality != "audio":
        found = found + (_UNEMBED,)  # the tied table is the unembedding too
    return found


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _nbytes(shape, dtype: torch.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * _itemsize(dtype)


def resolved(specs: Any, tree: Any, mesh) -> List[Tuple[Tuple, NamedSharding, Any]]:
    """(path, sharding, leaf) for every tensor leaf, each sharding from
    ``shardings_for``."""
    out = []

    def one(path, sh, x):
        if isinstance(x, torch.Tensor):
            out.append((path, sh, x))

    tree_map_specs(one, shardings_for(mesh, specs, tree), tree, path=())
    return out


def block_bytes(sh: NamedSharding, x: torch.Tensor, dtype=None) -> int:
    """Bytes of one device's block of ``x`` (in ``dtype``, default x's)."""
    return _nbytes(sh.shard_shape(x.shape), x.dtype if dtype is None else dtype)


def shard_bytes(specs: Any, tree: Any, mesh) -> int:
    """Bytes one device holds of ``tree`` sharded by ``specs``."""
    return sum(block_bytes(sh, x) for _, sh, x in resolved(specs, tree, mesh))


def _out(counts: Dict[str, float]) -> Dict[str, float]:
    counts = {k: float(v) for k, v in counts.items() if v}
    counts["total"] = float(sum(counts.values()))
    return counts


def fsdp_all_gather(param_specs, params, mesh, passes: int) -> Dict[str, float]:
    total = sum(block_bytes(sh, x) for _, sh, x in resolved(param_specs, params, mesh)
                if sh.axis_split("data") > 1)
    return {"all-gather": passes * total}


def grad_reduce_scatter(param_specs, params, mesh) -> Dict[str, float]:
    rs = ar = 0
    data = mesh.shape.get("data", 1)
    for _, sh, x in resolved(param_specs, params, mesh):
        block, k = block_bytes(sh, x), sh.axis_split("data")
        if k > 1:
            rs += block * k
        elif data > 1:
            ar += block
    return {"reduce-scatter": rs, "all-reduce": ar}


def pod_grad_all_reduce(param_specs, params, mesh) -> Dict[str, float]:
    if mesh.shape.get("pod", 1) < 2:
        return {}
    return {"all-reduce": shard_bytes(param_specs, params, mesh)}


def _stack_of(path: Tuple, stacks: Dict[Tuple, int]):
    """The number of layers a forward pass applies from the stack holding
    ``path``, or None outside every stack."""
    for prefix, n in stacks.items():
        if path[:len(prefix)] == prefix:
            return n
    return None


def tp_all_reduce(param_specs, params, mesh, cfg, tokens: int, act_dtype: torch.dtype,
                  train: bool) -> Dict[str, float]:
    """``tokens``: the tokens one device's batch shard runs through a
    forward pass (batch per device times sequence)."""
    if mesh.shape.get("model", 1) < 2:
        return {}
    stacks, heads = layer_stacks(cfg, train), head_passes(cfg, train)
    remat_passes = 2 if train and cfg.remat else 1
    total = 0
    for path, sh, x in resolved(param_specs, params, mesh):
        layers = _stack_of(path, stacks)
        for prod in _products(path, cfg):
            lead = x.dim() - prod.rank
            dims = x.shape[lead:]
            model = sh.over("model")[lead:]
            inner = prod.contracted
            outer = [i for i in range(prod.rank) if i not in inner]
            per_use = 0
            if any(model[i] for i in inner):  # forward partial sums
                passes = remat_passes if layers is not None else 1
                per_use += passes * tokens * int(np.prod([dims[i] for i in outer]))
            if train and prod.backward and any(model[i] for i in outer):  # backward dx
                per_use += tokens * int(np.prod([dims[i] for i in inner]))
            uses = layers if layers is not None else (
                int(np.prod(x.shape[:lead], dtype=np.int64)) * heads)
            total += uses * per_use * _itemsize(act_dtype)
    return {"all-reduce": total}


def moe_psum(cfg, mesh, tokens: int, act_dtype: torch.dtype, train: bool,
             mtp_tokens: int = 0) -> Dict[str, float]:
    """``tokens``: one batch shard's tokens per forward pass."""
    if cfg.moe is None or mesh.shape.get("model", 1) < 2 or (
            cfg.moe.num_experts % mesh.shape["model"]):
        return {}
    layers = cfg.num_layers - cfg.moe.first_k_dense
    passes = ((2 if cfg.remat else 1) + 1) if train else 1
    width = cfg.d_model * _itemsize(act_dtype)
    total = passes * layers * tokens * width
    if train and cfg.mtp_depth:
        total += passes * mtp_tokens * width
    return {"all-reduce": total}


def cache_candidate_gather(mesh, q: int, k: int) -> Dict[str, float]:
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    return {"all-gather": len(axes) * q * k * (4 + 4)}


def combine(*parts: Dict[str, float]) -> Dict[str, float]:
    """Sum rule results by collective kind, with their ``"total"``."""
    out: Dict[str, float] = defaultdict(float)
    for p in parts:
        for k, v in p.items():
            if k != "total":
                out[k] += v
    return _out(out)
