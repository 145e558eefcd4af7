"""The port's spec trees and shape-only trees against the reference's, for
all ten architectures at their full configs.

* ``param_specs`` / ``cache_specs`` / ``train_state_specs`` equal the
  reference's ``abstract_params(cfg)[1]``, ``abstract_cache(cfg, 2, 64)[1]``
  and ``abstract_train_state(cfg)[1]`` leaf for leaf (deepseek-v3's 8-bit
  moments with their ``{"q", "scale"}`` specs included, and the moments
  over ``pod`` under ``opt_pod_sharded``).
* ``init_params`` / ``init_cache`` / ``init_train_state`` on ``meta`` give
  every leaf ``jax.eval_shape``'s shape and dtype, and allocate nothing
  (every leaf is a meta tensor; deepseek-v3 has 682,636,480,256
  parameters).
* On both production meshes every leaf's resolved spec and per-device
  bytes equal what the reference's ``resolve_spec`` gives (a duck-typed
  mesh with ``axis_names`` and ``shape``; no devices).
"""
import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import ARCH_NAMES, get_config as j_get_config
from repro.distributed import sharding as JS
from repro.launch.specs import abstract_cache as j_abstract_cache
from repro.launch.specs import abstract_params as j_abstract_params
from repro.training.train_loop import abstract_train_state as j_abstract_train_state
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import named_sharding
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.specs import abstract_cache, abstract_params
from repro_torch.training import abstract_train_state, init_train_state
from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_leaves

torch.set_num_threads(1)


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _flat(tree, path=""):
    """{path: leaf} over nested dicts and NamedTuples (a spec leaf is a
    plain tuple or None)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{path}/{k}"))
        return out
    return {path: tree}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


_REF = {}


def _reference(arch, **kw):
    """The reference's (params, specs), (cache, specs) and (state, specs),
    computed once per config."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _REF:
        cfg = dataclasses.replace(j_get_config(arch), **kw)
        _REF[key] = (j_abstract_params(cfg), j_abstract_cache(cfg, 2, 64),
                     j_abstract_train_state(cfg))
    return _REF[key]


def _port(arch, **kw):
    cfg = dataclasses.replace(get_config(arch), **kw)
    return abstract_params(cfg), abstract_cache(cfg, 2, 64), abstract_train_state(cfg)


def _assert_same_shapes(got, want, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), (what, sorted(set(g) ^ set(w)))
    for k in w:
        assert tuple(g[k].shape) == tuple(w[k].shape), (what, k, g[k].shape, w[k].shape)
        assert _dtype_name(g[k].dtype) == str(w[k].dtype), (what, k, g[k].dtype, w[k].dtype)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_trees_and_meta_shapes_match_reference(arch):
    (jp, jps), (jc, jcs), (js, jss) = _reference(arch)
    (tp, tps), (tc, tcs), (ts, tss) = _port(arch)
    assert _flat(tps) == _flat(jps)
    assert _flat(tcs) == _flat(jcs)
    assert _flat(tss) == _flat(jss)
    assert type(tss).__name__ == type(jss).__name__ == "TrainState"
    _assert_same_shapes(tp, jp, "params")
    _assert_same_shapes(tc, jc, "cache")
    _assert_same_shapes({"params": ts.params, "opt_state": ts.opt_state},
                        {"params": js.params, "opt_state": js.opt_state}, "state")
    assert tuple(ts.step.shape) == tuple(js.step.shape) == ()
    for leaf in tree_leaves(tp) + tree_leaves(tc) + tree_leaves(ts.params) + tree_leaves(
            ts.opt_state):
        assert leaf.is_meta  # nothing allocated, nothing drawn


def test_deepseek_moments_over_pod_and_eight_bit():
    """deepseek-v3 trains with 8-bit moments: {"q", "scale"} per moment, the
    scale's spec without the last axis; ``opt_pod_sharded`` extends the
    moments' ``data`` entries to ("pod", "data"), leaving the parameters'
    specs as they are."""
    arch = "deepseek-v3-671b"
    (_, _, (js, jss)) = _reference(arch, opt_pod_sharded=True)
    (_, _, (ts, tss)) = _port(arch, opt_pod_sharded=True)
    assert _flat(tss) == _flat(jss)
    _assert_same_shapes(ts.opt_state, js.opt_state, "moments")
    m = tss.opt_state["moe_layers"]["ffn"]["w_gate"]["m"]
    assert m == {"q": (None, "model", ("pod", "data"), None),
                 "scale": (None, "model", ("pod", "data"), None)}
    assert tss.params["moe_layers"]["ffn"]["w_gate"] == (None, "model", "data", None)
    assert ts.opt_state["moe_layers"]["ffn"]["w_gate"]["m"]["q"].dtype == torch.int8


def test_deepseek_parameter_count_on_meta():
    (tp, _), _, _ = _port("deepseek-v3-671b")
    assert sum(x.numel() for x in tree_leaves(tp)) == 682_636_480_256


def test_meta_state_and_eight_bit_moments_build_shapes_only():
    """``init_train_state`` and the 8-bit ``init_opt_state`` on meta at
    deepseek-v3's full config: every leaf meta, the moments int8 with
    float32 row scales, the step an int32 0-d tensor."""
    cfg = get_config("deepseek-v3-671b")
    state = init_train_state(cfg, device="meta")
    assert all(x.is_meta for x in tree_leaves(state.params) + tree_leaves(state.opt_state))
    w = state.params["moe_layers"]["ffn"]["w_down"]
    mom = init_opt_state({"w": w}, AdamWConfig(quantized=True))["w"]["v"]
    assert mom["q"].is_meta and mom["q"].dtype == torch.int8 and mom["q"].shape == w.shape
    assert mom["scale"].shape == w.shape[:-1] + (1,) and mom["scale"].dtype == torch.float32
    assert state.step.dtype == torch.int32 and state.step.shape == ()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_resolved_specs_and_bytes_per_device_match_reference(arch, mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    (jp, jps), (jc, jcs), (js, jss) = _reference(arch)
    (tp, tps), (tc, tcs), (ts, tss) = _port(arch)
    pairs = [(tps, tp, jps, jp), (tcs, tc, jcs, jc),
             (tss.opt_state, ts.opt_state, jss.opt_state, js.opt_state)]
    for t_specs, t_tree, j_specs, j_tree in pairs:
        t_spec, t_leaf = _flat(t_specs), _flat(t_tree)
        j_spec, j_leaf = _flat(j_specs), _flat(j_tree)
        want_total = 0
        for k, spec in j_spec.items():
            shape = tuple(j_leaf[k].shape)
            want = JS.resolve_spec(spec, mesh, shape)
            got = named_sharding(mesh, t_spec[k], shape)
            assert PartitionSpec(*got.spec) == want, (k, got.spec, want)
            split = [int(np.prod([mesh.shape[a] for a in
                                  ((e,) if isinstance(e, str) else (e or ()))]))
                     for e in want]
            block = tuple(n // s for n, s in zip(shape, split))
            assert got.shard_shape(shape) == block, k
            want_total += int(np.prod(block)) * np.dtype(j_leaf[k].dtype).itemsize
        assert H.shard_bytes(t_specs, t_tree, mesh) == want_total
