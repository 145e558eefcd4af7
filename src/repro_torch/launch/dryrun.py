"""Multi-pod dry run (the port of the reference's ``launch/dryrun.py``).

For every (architecture x input shape) cell, run the real step function —
``make_train_step``, ``prefill`` or ``decode_step`` — on the production
mesh, single-pod (16, 16) and multi-pod (2, 16, 16), with every leaf
placed by its spec tree, and record per device:

  * memory  — argument / output / alias bytes, exact from the ``meta``
              trees' dtypes and each leaf's shard shape; temp bytes from
              the peak of live ``meta`` storage => fits the H100's HBM?
  * cost    — FLOPs (``torch.utils.flop_counter.FlopCounterMode``),
              transcendentals and bytes accessed (an operator counter),
              over the whole mesh's work divided by its positions
  * collective bytes — by the spec-tree rules of ``hlo_analysis.py``

plus a ``cache_lookup`` pseudo-cell running the paper's sharded cache
search on the same meshes. Results append to a JSON file as they come, so
a long sweep resumes where it left off.

Everything runs on ``torch.device("meta")``, always: the mesh's positions
are meta (``make_production_mesh``), so no value is computed and nothing
is allocated. The reference lowers onto 512 forced host devices and reads
XLA's compiled program; here the step runs eagerly on meta tensors and
the counts are taken as it runs. The kernels' wrappers take their plain
versions on meta. Each record's ``method`` says how every field was
obtained. Nothing here is measured on a card: the figures are computed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch qwen1.5-0.5b \\
      --out build/dry.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, SHAPES, cells_for, get_config
from repro_torch.distributed.sharding import BATCH, tree_map_specs, use_mesh
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.specs import abstract_params, input_specs
from repro_torch.models import transformer as T
from repro_torch.models.moe import batch_axes
from repro_torch.training.train_loop import abstract_train_state, make_train_step, opt_config

# NVIDIA H100 80GB HBM3: torch.cuda.get_device_properties(0).total_memory
HBM_PER_CHIP = 85_017_493_504
HBM_CARD = "NVIDIA H100 80GB HBM3"

METHOD = {
    "argument_bytes": "exact: each input leaf's shard shape (its spec resolved on the mesh) "
                      "times its dtype's size",
    "output_bytes": "exact: the step's outputs, sharded like their inputs (state, cache), "
                    "logits over the batch axes, metrics replicated",
    "alias_bytes": "exact: the donated state (train) or cache (prefill, decode)",
    "temp_bytes": "upper bound: the peak of live meta storage while one batch shard's "
                  "microbatch runs the step without the mesh (activations not split over "
                  "model; the plain attention's score matrices and the plain scan's chunk "
                  "terms counted, which the kernels hold on chip); in training the "
                  "activations' backward with the weights frozen, plus the gradients, the "
                  "accumulators and one leaf's float32 optimizer transients per device "
                  "from the spec trees",
    "code_bytes": "0: no compiled program (the kernels' code is not counted)",
    "flops": "FlopCounterMode over the step on meta for one batch shard (grad_accum folded "
             "to 1: the same tokens) over the model axis, divided by its positions (every "
             "batch shard runs the same shapes); products only",
    "transcendentals": "operator counter: one per output element of exp, log, tanh, "
                       "sigmoid, sqrt, rsqrt, sin, cos, erf, softmax, silu, gelu and their "
                       "kin (logsumexp: per input element), per position as the flops",
    "bytes_accessed": "operator counter: every operator's inputs read once and outputs "
                      "written once (views free), per position as the flops",
    "collective_bytes_per_device": "spec-tree rules of launch/hlo_analysis.py",
}

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid", "rsqrt", "sqrt",
    "sin", "cos", "erf", "erfinv", "_softmax", "_log_softmax", "silu", "gelu", "softplus",
    "silu_backward", "gelu_backward", "pow",
}
_FREE = {"empty", "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense"}


class OpCounter(TorchDispatchMode):
    """Transcendentals and bytes accessed per operator; with ``live``, also
    the peak bytes of the storages created under it that are alive at once
    (``ignore``: tensors whose storages were there before — arguments and
    their views do not count)."""

    def __init__(self, live: bool = False, ignore=()):
        super().__init__()
        self.transcendentals = 0
        self.bytes_accessed = 0
        self.live = live
        self.cur = self.peak = 0
        self._ignore = {t.untyped_storage()._cdata for t in ignore}
        self._storages: Dict[int, Tuple[Any, int]] = {}
        self._ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view and name not in _FREE:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        elif name == "logsumexp":
            self.transcendentals += args[0].numel()
        if self.live:
            self._track(outs)
        return out

    def _track(self, outs):
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._ignore:
                continue
            old = self._storages.get(key)
            if old is not None and not old[0].expired():
                continue
            if old is not None:
                self.cur -= old[1]
            self._storages[key] = (StorageWeakRef(st), st.nbytes())
            self.cur += st.nbytes()
        self.peak = max(self.peak, self.cur)
        self._ops += 1
        if self._ops % 64 == 0:
            for key, (ref, n) in list(self._storages.items()):
                if ref.expired():
                    del self._storages[key]
                    self.cur -= n


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.devices.shape)


def _batch_shards(mesh, B: int) -> int:
    return batch_axes(mesh, B)[1]


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _slice_batch(tree, dim: int, n: int):
    """Views of ``tree``'s leaves cut to the first ``n`` along ``dim``."""
    if isinstance(tree, dict):
        return {k: _slice_batch(v, dim, n) for k, v in tree.items()}
    return tree.narrow(dim, 0, n)


def despec_params_for_inference(specs):
    """Drop the FSDP (``data``) axis from parameter specs: inference wants
    TP-sharded, data-replicated weights (no per-layer all-gathers). Only
    valid when the parameters fit at 1/TP scale."""

    def one(spec):
        if spec is None:
            return None
        out = []
        for e in spec:
            if e == "data":
                out.append(None)
            elif isinstance(e, tuple):
                kept = tuple(a for a in e if a != "data")
                out.append(kept if kept else None)
            else:
                out.append(e)
        return tuple(out)

    return tree_map_specs(one, specs)


def _run(kind: str, cfg, args):  # repro: device-region static[kind, cfg]
    if kind == "train":
        return make_train_step(cfg)(*args)
    if kind == "prefill":
        return T.prefill(*args[:1], cfg, *args[1:])
    return T.decode_step(*args[:1], cfg, *args[1:])


def _cell_args(cfg, spec) -> Tuple[tuple, tuple, Any]:
    """(the step's arguments, their spec trees, the donated argument)."""
    kind = spec["kind"]
    if kind == "train":
        state, state_specs = abstract_train_state(cfg)
        return (state, spec["batch"]), (state_specs, spec["batch_specs"]), 0
    params, p_specs = abstract_params(cfg)
    if cfg.infer_params_tp_only:
        p_specs = despec_params_for_inference(p_specs)
    if kind == "prefill":
        return ((params, spec["batch"], spec["cache"]),
                (p_specs, spec["batch_specs"], spec["cache_specs"]), 2)
    return ((params, spec["tokens"], spec["pos"], spec["cache"]),
            (p_specs, spec["tokens_spec"], spec["pos_spec"], spec["cache_specs"]), 3)


def _outputs(kind: str, args, arg_specs, out, B: int):
    """(spec tree, tree) pairs of the step's outputs at the global batch:
    the new state (shaped as the state) and replicated metrics, or the
    logits over the batch axes and the cache (shaped as the cache)."""
    if kind == "train":
        return [(arg_specs[0], args[0]), ({k: () for k in out[1]}, out[1])]
    logits = torch.empty((B,) + tuple(out[0].shape[1:]), dtype=out[0].dtype, device="meta")
    return [((BATCH,) + (None,) * (logits.dim() - 1), logits), (arg_specs[-1], args[-1])]


def _shard_args(kind: str, args, b: int):
    """The step's arguments with the batch cut to its first ``b`` rows
    (views): the batch leaves along axis 0, a cache along axis 1 (behind
    its layer axis)."""
    if kind == "train":
        return args[0], _slice_batch(args[1], 0, b)
    head, cache = args[:-1], args[-1]
    return (head[0],) + tuple(_slice_batch(a, 0, b) for a in head[1:]) + (
        _slice_batch(cache, 1, b),)


def _model_mesh(mesh):
    """The mesh with every axis but ``model`` cut to one position: one
    batch shard's devices."""
    shape = tuple(mesh.shape[a] if a == "model" else 1 for a in mesh.axis_names)
    return make_test_mesh(shape, mesh.axis_names, device="meta")


def _temp_pass(cfg, kind: str, args, b: int) -> int:
    """The peak live bytes of one batch shard's microbatch of ``b`` rows,
    without the mesh."""
    if kind == "train":
        frozen = _freeze(args[0].params)
        frozen["embed"]["table"].requires_grad_(True)
        batch = _slice_batch(args[1], 0, b)
        with OpCounter(live=True, ignore=_tensors(frozen) + _tensors(batch)) as oc:
            loss, _ = T.loss_fn(frozen, cfg, batch)
            loss.backward()
        return oc.peak
    local = _shard_args(kind, args, b)
    with OpCounter(live=True, ignore=_tensors(local)) as oc:
        _run(kind, cfg, local)
    return oc.peak


def _freeze(params):
    """The parameters detached: with only the embedding table then
    recording gradients, the backward runs through every activation and
    computes no weight gradient but the table's."""
    return {k: _freeze(v) if isinstance(v, dict) else v.detach() for k, v in params.items()}


def _train_extra_bytes(cfg, state, state_specs, mesh) -> int:
    """A train step's per-device gradients (the parameters' dtype), the
    accumulators (``grad_accum`` > 1: float32, bfloat16 under the 8-bit
    optimizer) and the largest leaf's float32 optimizer transients
    (g, m, v, the update)."""
    p_specs, params = state_specs.params, state.params
    grads = H.shard_bytes(p_specs, params, mesh)
    acc = 0
    if cfg.grad_accum > 1:
        acc_dt = torch.bfloat16 if opt_config(cfg).quantized else torch.float32
        acc = H.shard_bytes(p_specs, _retype(params, acc_dt), mesh)
    largest = max(H.block_bytes(sh, x, torch.float32)
                  for _, sh, x in H.resolved(p_specs, params, mesh))
    return grads + acc + 4 * largest


def _retype(tree, dtype):
    if isinstance(tree, dict):
        return {k: _retype(v, dtype) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=dtype, device="meta")


def _tokens(kind: str, spec) -> Tuple[int, int]:
    """(global batch, positions per sequence in one forward pass)."""
    if kind == "decode":
        return spec["tokens"].shape[0], 1
    tokens = spec["batch"]["tokens"]
    seq = tokens.shape[-1]
    if "vision_embeds" in spec["batch"]:
        seq += spec["batch"]["vision_embeds"].shape[1]
    return tokens.shape[0], seq


def collective_bytes(cfg, kind: str, spec, params, p_specs, mesh) -> Dict[str, float]:
    """Every rule of ``hlo_analysis`` that applies to the cell."""
    train = kind == "train"
    B, seq = _tokens(kind, spec)
    shards = _batch_shards(mesh, B)
    tokens = (B // shards) * seq
    act = getattr(torch, cfg.dtype)
    gather_passes = (2 if cfg.remat else 1) if train else 1
    used, used_specs = params, p_specs
    if not train and "mtp" in params:  # the MTP head runs in training only
        used = {k: v for k, v in params.items() if k != "mtp"}
        used_specs = {k: v for k, v in p_specs.items() if k != "mtp"}
    parts = [H.fsdp_all_gather(used_specs, used, mesh, gather_passes),
             H.tp_all_reduce(used_specs, used, mesh, cfg, tokens, act, train),
             H.moe_psum(cfg, mesh, tokens, act, train, mtp_tokens=(B // shards) * (seq - 1))]
    if train:
        parts += [H.grad_reduce_scatter(p_specs, params, mesh),
                  H.pod_grad_all_reduce(p_specs, params, mesh)]
    return H.combine(*parts)


def lower_cell(arch: str, shape_name: str, mesh, *, cfg=None, adapt_accum: bool = True,
               temp: bool = True) -> Dict[str, Any]:
    """Run one cell on meta; returns its record."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape_name]
    # memory-optimal grad accumulation, as the reference sets it: one
    # sequence per batch shard per microbatch
    if adapt_accum and shape.kind == "train":
        accum = max(shape.global_batch // _batch_shards(mesh, shape.global_batch), 1)
        cfg = dataclasses.replace(cfg, grad_accum=accum)
    spec = input_specs(cfg, shape)
    kind = spec["kind"]
    n_dev = len(mesh.devices.flatten())
    args, arg_specs, donated = _cell_args(cfg, spec)

    # one batch shard's work over the model axis: every batch shard runs
    # the same shapes, so its counts over its positions are the whole
    # mesh's over all of them
    B = shape.global_batch
    shards = _batch_shards(mesh, B)
    sub = _model_mesh(mesh)
    t0 = time.time()
    run_cfg = dataclasses.replace(cfg, grad_accum=1)  # the same tokens in one pass
    with use_mesh(sub), FlopCounterMode(display=False) as fc, OpCounter() as oc:
        out = _run(kind, run_cfg, _shard_args(kind, args, B // shards))
    lower_s = time.time() - t0
    per = len(sub.devices.flatten())

    memory = {
        "argument_bytes": sum(H.shard_bytes(s, a, mesh) for s, a in zip(arg_specs, args)),
        "output_bytes": sum(H.shard_bytes(s, o, mesh)
                            for s, o in _outputs(kind, args, arg_specs, out, B)),
        "temp_bytes": 0,
        "alias_bytes": H.shard_bytes(arg_specs[donated], args[donated], mesh),
        "code_bytes": 0,
    }
    rec = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh), "devices": n_dev,
        "kind": kind, "lower_s": round(lower_s, 1),
        "cost": {"flops": fc.get_total_flops() / per,
                 "transcendentals": oc.transcendentals / per,
                 "bytes_accessed": oc.bytes_accessed / per},
        "method": dict(METHOD, device="meta (nothing computed or allocated)"),
    }
    if temp:
        t1 = time.time()
        b = max(B // shards // max(cfg.grad_accum, 1), 1) if kind == "train" else B // shards
        peak = _temp_pass(cfg, kind, args, b)
        if kind == "train":
            peak += _train_extra_bytes(cfg, args[0], arg_specs[0], mesh)
        memory["temp_bytes"] = int(peak)
        rec["temp_batch"] = b
        rec["temp_s"] = round(time.time() - t1, 1)
    rec["memory"] = memory
    total = sum(memory[k] for k in ("argument_bytes", "output_bytes", "temp_bytes"))
    rec["bytes_per_device"] = int(total - memory["alias_bytes"])
    rec["fits_hbm"] = bool(rec["bytes_per_device"] <= HBM_PER_CHIP)
    rec["hbm_per_chip"] = HBM_PER_CHIP
    params = args[0].params if kind == "train" else args[0]
    p_specs = arg_specs[0].params if kind == "train" else arg_specs[0]
    rec["collective_bytes_per_device"] = collective_bytes(cfg, kind, spec, params, p_specs,
                                                          mesh)
    return rec


def _unit_layers(cfg) -> Tuple[int, int]:
    """The smallest and the double-unit depths whose layer composition
    matches the full stack's repeating unit (pattern cycle / hybrid
    group)."""
    if cfg.family == "hybrid":
        u = cfg.hybrid_period
    elif cfg.family == "ssm":
        u = 1
    else:
        u = len(cfg.attn_pattern)
    base = cfg.moe.first_k_dense if cfg.moe else 0
    return base + u, base + 3 * u


def extrapolate_costs(arch: str, shape_name: str, mesh, cfg=None) -> Dict[str, Any]:
    """The cost terms from two shallow runs and their per-layer slope:
        total(L) = f(L1) + (f(L2) - f(L1)) / (L2 - L1) * (L - L1).
    The reference needs this because XLA's cost analysis counts a loop body
    once; on meta the full-depth count is direct, so here it is a check
    that the counts are linear in depth (``lower_cell``'s ``cost`` is the
    direct figure)."""
    cfg = cfg if cfg is not None else get_config(arch)
    L_full = cfg.num_layers
    L1, L2 = _unit_layers(cfg)
    points = {}
    t0 = time.time()
    for L in (L1, L2):
        cfg_s = dataclasses.replace(cfg, num_layers=L, grad_accum=1)
        points[L] = lower_cell(arch, shape_name, mesh, cfg=cfg_s, adapt_accum=False,
                               temp=False)

    def lerp(get):
        f1, f2 = get(points[L1]), get(points[L2])
        return f1 + (f2 - f1) / (L2 - L1) * (L_full - L1)

    keys = set(points[L1]["collective_bytes_per_device"]) | set(
        points[L2]["collective_bytes_per_device"])
    return {
        "method": f"meta L={L1},{L2} -> {L_full}",
        "flops": lerp(lambda r: r["cost"]["flops"]),
        "bytes_accessed": lerp(lambda r: r["cost"]["bytes_accessed"]),
        "transcendentals": lerp(lambda r: r["cost"]["transcendentals"]),
        "collectives": {k: lerp(lambda r: r["collective_bytes_per_device"].get(k, 0.0))
                        for k in keys},
        "lower_s": round(time.time() - t0, 1),
    }


def lower_cache_lookup(mesh, *, n_entries: int = 1 << 20, dim: int = 768, q: int = 16,
                       k: int = 8) -> Dict[str, Any]:
    """The paper's sharded cache lookup on the production mesh, on meta."""
    from repro_torch.distributed.sharded_store import make_sharded_lookup, position_topk

    n_dev = len(mesh.devices.flatten())
    n = n_entries - (n_entries % n_dev)
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    shards = 1
    for a in axes:
        shards *= mesh.shape[a]
    db = torch.empty((n, dim), dtype=torch.float32, device="meta")
    valid = torch.empty((n,), dtype=torch.bool, device="meta")
    qv = torch.empty((q, dim), dtype=torch.float32, device="meta")
    lookup = make_sharded_lookup(mesh, k=k)
    t0 = time.time()
    with FlopCounterMode(display=False) as fc, OpCounter() as oc:
        scores, idx = lookup(db, valid, qv)
    rows = n // shards
    db_l, v_l = db[:rows].view(1, rows, dim), valid[:rows].view(1, rows)
    with OpCounter(live=True, ignore=[db, valid, qv]) as live:
        position_topk(db_l, v_l, qv, k, "cosine", False)
    memory = {
        "argument_bytes": (db.nbytes + valid.nbytes) // shards + qv.nbytes,
        "output_bytes": scores.nbytes + idx.nbytes,
        "temp_bytes": int(live.peak), "alias_bytes": 0, "code_bytes": 0,
    }
    rec = {
        "arch": "cache_lookup", "shape": f"n{n_entries >> 20}m_d{dim}_q{q}_k{k}",
        "mesh": _mesh_name(mesh), "devices": n_dev, "kind": "cache",
        "lower_s": round(time.time() - t0, 1), "memory": memory,
        "cost": {"flops": fc.get_total_flops() / n_dev,
                 "transcendentals": oc.transcendentals / n_dev,
                 "bytes_accessed": oc.bytes_accessed / n_dev},
        "collective_bytes_per_device": H.combine(H.cache_candidate_gather(mesh, q, k)),
        "method": dict(METHOD, temp_bytes="the peak of live meta storage of one position's "
                                          "plain top-k over its shard",
                       device="meta (nothing computed or allocated)"),
    }
    rec["bytes_per_device"] = int(sum(memory[k] for k in ("argument_bytes", "output_bytes",
                                                          "temp_bytes")))
    rec["fits_hbm"] = bool(rec["bytes_per_device"] <= HBM_PER_CHIP)
    rec["hbm_per_chip"] = HBM_PER_CHIP
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all for arch)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--skip-cache-cell", action="store_true")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--force", action="store_true", help="redo cells already in --out")
    args = ap.parse_args(argv)

    results = []
    done = set()
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)
        done = {(r["arch"], r["shape"], r["mesh"]) for r in results if "error" not in r}

    def save(key, rec):
        nonlocal results
        results = [r for r in results if (r["arch"], r["shape"], r["mesh"]) != key]
        results.append(rec)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(make_production_mesh(multi_pod=False))
    if args.mesh in ("multi", "both"):
        meshes.append(make_production_mesh(multi_pod=True))

    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    for mesh in meshes:
        mesh_name = _mesh_name(mesh)
        for arch in archs:
            for shape_name in [args.shape] if args.shape else cells_for(arch):
                key = (arch, shape_name, mesh_name)
                if key in done:
                    print(f"[skip] {key}")
                    continue
                print(f"[cell] {arch} x {shape_name} on {mesh_name} ...", flush=True)
                try:
                    rec = lower_cell(arch, shape_name, mesh)
                    if len(mesh.axis_names) == 2 and not args.no_extrapolate:
                        # the per-layer slope (single-pod pass only)
                        rec["cost_extrapolated"] = extrapolate_costs(arch, shape_name, mesh)
                    gb = rec["bytes_per_device"] / 2**30
                    print(f"  ok  lower={rec['lower_s']}s mem/dev={gb:.2f}GiB "
                          f"fits={rec['fits_hbm']} flops/dev={rec['cost']['flops']:.3e}",
                          flush=True)
                except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"  FAIL {type(e).__name__}: {str(e)[:200]}", flush=True)
                save(key, rec)
        if not args.skip_cache_cell:
            key = ("cache_lookup", "n1m_d768_q16_k8", mesh_name)
            if key not in done:
                print(f"[cell] cache_lookup on {mesh_name} ...", flush=True)
                rec = lower_cache_lookup(mesh)
                save(key, rec)
                print(f"  ok  lower={rec['lower_s']}s", flush=True)

    n_ok = sum(1 for r in results if "error" not in r)
    print(f"\ndone: {n_ok}/{len(results)} cells ran clean -> {args.out}")
    return results


if __name__ == "__main__":
    main()
