"""The port's dry run (``repro_torch.launch.dryrun``, ``specs``,
``hlo_analysis``) against the reference's tables and against hand-worked
counts. Everything runs on ``meta``; no card is needed.

* ``SHAPES`` and ``cells_for`` equal the reference's; ``input_specs``
  gives the reference's shapes and dtypes for every arch x cell, and
  ``despec_params_for_inference`` the reference's specs.
* ``lower_cell`` for qwen1.5-0.5b x {train_4k, decode_32k} on the
  single-pod mesh: the reference's record keys, and argument bytes equal
  to the sum over the reference's own abstract trees, each leaf cut by the
  reference's ``resolve_spec``.
* FLOPs equal a closed form for this dense model (decode exactly; the
  train step within 1%), and ``extrapolate_costs`` is within 1% of the
  direct count.
* Each collective rule on a hand-worked two-layer case.
* The CLI resumes from its ``--out``.
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import SHAPES as J_SHAPES
from repro.configs import cells_for as j_cells_for
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as JS
from repro.launch import specs as j_specs
from repro_torch.configs import ARCH_NAMES, SHAPES, cells_for, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import transformer as T

torch.set_num_threads(1)

QWEN = "qwen1.5-0.5b"
REC_KEYS = {"arch", "shape", "mesh", "devices", "kind", "memory", "cost", "bytes_per_device",
            "fits_hbm", "collective_bytes_per_device", "method"}


def _ref_despec():
    """The reference's ``despec_params_for_inference``. Its module forces
    512 host devices through XLA_FLAGS at import, so the variable is put
    back before anything starts a JAX backend."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import despec_params_for_inference
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return despec_params_for_inference


def _flat(tree, path=""):
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


def test_shapes_and_cells_match_reference():
    assert set(ARCH_NAMES) == set(J_ARCH_NAMES)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for arch in J_ARCH_NAMES:
        assert cells_for(arch) == j_cells_for(arch)


@pytest.mark.parametrize("arch", J_ARCH_NAMES)
def test_input_specs_match_reference(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    for cell in j_cells_for(arch):
        want = j_specs.input_specs(jc, J_SHAPES[cell])
        got = input_specs(tc, SHAPES[cell])
        assert got["kind"] == want["kind"]
        w, g = _flat({k: v for k, v in want.items() if k != "kind"}), _flat(
            {k: v for k, v in got.items() if k != "kind"})
        assert g.keys() == w.keys(), (cell, sorted(set(g) ^ set(w)))
        for k, leaf in w.items():
            if hasattr(leaf, "shape"):  # an abstract array
                assert tuple(g[k].shape) == tuple(leaf.shape), (cell, k)
                assert str(g[k].dtype).replace("torch.", "") == str(leaf.dtype), (cell, k)
                assert g[k].is_meta
            else:  # a spec
                assert g[k] == leaf, (cell, k)


@pytest.mark.parametrize("arch", J_ARCH_NAMES)
def test_despec_params_for_inference_matches_reference(arch):
    despec = _ref_despec()
    want = despec(j_specs.abstract_params(j_get_config(arch))[1])
    got = D.despec_params_for_inference(T.param_specs(get_config(arch)))
    assert _flat(got) == _flat(want)
    assert all("data" not in str(s) for s in _flat(got).values())


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _ref_bytes(specs, tree, mesh) -> int:
    """Per-device bytes of the reference's abstract tree, each leaf cut by
    the reference's ``resolve_spec``."""
    s, t = _flat(specs), _flat(tree)
    total = 0
    for k, spec in s.items():
        shape = tuple(t[k].shape)
        ps = JS.resolve_spec(spec, mesh, shape)
        block = [n // int(np.prod([mesh.shape[a] for a in
                                   ((e,) if isinstance(e, str) else (e or ()))]))
                 for n, e in zip(shape, ps)]
        total += int(np.prod(block)) * np.dtype(t[k].dtype).itemsize
    return total


@pytest.fixture(scope="module")
def qwen_records():
    mesh = make_production_mesh()
    return {cell: D.lower_cell(QWEN, cell, mesh) for cell in ("train_4k", "decode_32k")}


def test_lower_cell_records_and_argument_bytes(qwen_records):
    mesh = FakeMesh({"data": 16, "model": 16})
    jc = j_get_config(QWEN)
    state, state_specs = _train_state_ref(jc)
    spec = j_specs.input_specs(jc, J_SHAPES["train_4k"])
    want = _ref_bytes(state_specs, state, mesh) + _ref_bytes(spec["batch_specs"], spec["batch"],
                                                             mesh)
    rec = qwen_records["train_4k"]
    assert REC_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "code_bytes"}
    assert set(rec["cost"]) == {"flops", "transcendentals", "bytes_accessed"}
    assert rec["mesh"] == "16x16" and rec["devices"] == 256 and rec["kind"] == "train"
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["alias_bytes"] == _ref_bytes(state_specs, state, mesh)
    assert rec["hbm_per_chip"] == D.HBM_PER_CHIP > 16 * 1024 ** 3
    assert rec["fits_hbm"] == (rec["bytes_per_device"] <= D.HBM_PER_CHIP)
    for k in rec["method"]:
        assert isinstance(rec["method"][k], str)

    params, p_specs = j_specs.abstract_params(jc)
    spec = j_specs.input_specs(jc, J_SHAPES["decode_32k"])
    want = (_ref_bytes(p_specs, params, mesh) + _ref_bytes(spec["cache_specs"], spec["cache"],
                                                          mesh)
            + _ref_bytes(spec["tokens_spec"], spec["tokens"], mesh)
            + _ref_bytes(spec["pos_spec"], spec["pos"], mesh))
    rec = qwen_records["decode_32k"]
    assert rec["kind"] == "decode" and rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["alias_bytes"] == _ref_bytes(spec["cache_specs"], spec["cache"], mesh)


def _train_state_ref(jc):
    from repro.training.train_loop import abstract_train_state

    return abstract_train_state(jc)


def _per_token_products(cfg) -> float:
    """A layer's projection and MLP FLOPs for one token (2 per multiply-add)."""
    d, H, KH, Dh, F = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    return 2 * d * H * Dh + 2 * 2 * d * KH * Dh + 2 * H * Dh * d + 3 * 2 * d * F


def test_flops_match_closed_form(qwen_records):
    """Per device = one batch shard's work over the 16 model positions.
    Decode: every token's products, attention over the whole 32k cache
    (QK and PV) and the unembedding — exactly. The train step: forward,
    the remat recompute and a backward of twice the forward, each over the
    products, the full S x S attention and the chunked unembedding; the
    non-reentrant checkpoint stops its recompute once the saved tensors are
    back, so each block's last product (the MLP's wo) is not recomputed."""
    cfg = get_config(QWEN)
    d, H, Dh, V, L, F = (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.vocab_size,
                         cfg.num_layers, cfg.d_ff)
    S = SHAPES["decode_32k"].seq_len
    per_token = L * (_per_token_products(cfg) + 4 * H * Dh * S) + 2 * V * d
    decode = 8 * per_token / 16  # 128 / 16 sequences, one token each
    assert qwen_records["decode_32k"]["cost"]["flops"] == decode

    S, B = SHAPES["train_4k"].seq_len, 16
    chunk = cfg.loss_chunk
    ce_tokens = math.ceil((S - 1) / chunk) * chunk
    layers = B * S * L * (4 * _per_token_products(cfg) - 2 * d * F) + B * L * 4 * (
        4 * S * S * H * Dh)
    ce = 4 * B * ce_tokens * 2 * V * d
    train = (layers + ce) / 16
    assert qwen_records["train_4k"]["cost"]["flops"] == pytest.approx(train, rel=0.01)


def test_extrapolated_costs_match_direct_count(qwen_records):
    mesh = make_production_mesh()
    for cell in ("train_4k", "decode_32k"):
        ext = D.extrapolate_costs(QWEN, cell, mesh)
        direct = qwen_records[cell]
        assert ext["method"] == "meta L=1,3 -> 24"
        for k in ("flops", "transcendentals", "bytes_accessed"):
            assert ext[k] == pytest.approx(direct["cost"][k], rel=0.01), (cell, k)
        for k, v in direct["collective_bytes_per_device"].items():
            assert ext["collectives"][k] == pytest.approx(v, rel=1e-9), (cell, k)


def _tiny():
    """Two dense layers: d 8, 4 heads of 4 (2 KV heads), d_ff 16, vocab 32,
    bfloat16, tied embeddings, no biases."""
    base = get_config(QWEN, smoke=True)
    return dataclasses.replace(base, num_layers=2, d_model=8, num_heads=4, num_kv_heads=2,
                               head_dim=4, d_ff=16, vocab_size=32, dtype="bfloat16",
                               qkv_bias=False, tie_embeddings=True, remat=True)


def test_collective_rules_on_a_hand_worked_case():
    """data = 2, model = 2. Every leaf of the tiny model is data-sharded;
    per device (bf16): table [32, 8] -> [16, 4] 128 B, final_norm 8 B,
    ln1/ln2 [2, 8] -> [2, 4] 16 B each, wq [2, 8, 4, 4] -> [2, 4, 2, 4]
    128 B, wk/wv [2, 8, 2, 4] -> 64 B each, wo [2, 4, 4, 8] -> 128 B,
    wi_gate/wi_up [2, 8, 16] -> [2, 4, 8] 128 B each, the MLP's wo 128 B:
    936 B. With 16 tokens per device: the lookup's all-reduce 16 x 8 x 2 B
    = 256 B; wo and the MLP's wo (model-sharded contractions) 256 B per
    layer each per forward, twice under remat; wq, wk, wv, wi_gate and
    wi_up (model-sharded outputs) 256 B per layer each in backward, and
    the unembedding's backward (dlogits [16, 32/2] @ table contracts the
    vocabulary) [16, 8] = 256 B, tied or not. Audio (2 codebooks, one MLP
    input ``wi``): the lookup per codebook, and each head's backward."""
    cfg = _tiny()
    mesh = make_test_mesh((2, 2), ("data", "model"), device="meta")
    params, specs = T.init_params(cfg, device="meta"), T.param_specs(cfg)
    assert H.shard_bytes(specs, params, mesh) == 936
    assert H.fsdp_all_gather(specs, params, mesh, passes=1) == {"all-gather": 936}
    assert H.fsdp_all_gather(specs, params, mesh, passes=2) == {"all-gather": 1872}
    assert H.grad_reduce_scatter(specs, params, mesh) == {"reduce-scatter": 1872,
                                                           "all-reduce": 0}
    act = torch.bfloat16
    infer = 256 + 2 * (256 + 256)
    assert H.tp_all_reduce(specs, params, mesh, cfg, 16, act, train=False) == {
        "all-reduce": infer}
    train = 256 + 2 * 2 * (256 + 256) + 2 * 5 * 256 + 256
    assert H.tp_all_reduce(specs, params, mesh, cfg, 16, act, train=True) == {
        "all-reduce": train}
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    u_params, u_specs = T.init_params(untied, device="meta"), T.param_specs(untied)
    assert H.shard_bytes(u_specs, u_params, mesh) == 936 + 128
    assert H.tp_all_reduce(u_specs, u_params, mesh, untied, 16, act, train=True) == {
        "all-reduce": train}
    audio = dataclasses.replace(
        get_config("musicgen-large", smoke=True), num_layers=2, d_model=8, num_heads=4,
        num_kv_heads=2, head_dim=4, d_ff=16, vocab_size=32, num_codebooks=2, remat=True)
    a_params, a_specs = T.init_params(audio, device="meta"), T.param_specs(audio)
    assert H.tp_all_reduce(a_specs, a_params, mesh, audio, 16, act, train=False) == {
        "all-reduce": 2 * 256 + 2 * (256 + 256)}
    assert H.tp_all_reduce(a_specs, a_params, mesh, audio, 16, act, train=True) == {
        "all-reduce": 2 * 256 + 2 * 2 * (256 + 256) + 2 * 4 * 256 + 2 * 256}
    assert H.pod_grad_all_reduce(specs, params, mesh) == {}
    pods = make_test_mesh((2, 2, 2), ("pod", "data", "model"), device="meta")
    assert H.pod_grad_all_reduce(specs, params, pods) == {"all-reduce": 936}
    assert H.cache_candidate_gather(pods, 16, 8) == {"all-gather": 2 * 16 * 8 * 8}
    assert H.cache_candidate_gather(mesh, 16, 8) == {"all-gather": 16 * 8 * 8}
    # the MoE's psum: [16 tokens, 64] bf16 per layer, 2 MoE layers; training
    # adds the remat recompute and the backward
    moe = dataclasses.replace(get_config("llama4-scout-17b-a16e", smoke=True), num_layers=2)
    assert H.moe_psum(moe, mesh, 16, act, train=False) == {"all-reduce": 2 * 16 * 64 * 2}
    assert H.moe_psum(moe, mesh, 16, act, train=True) == {"all-reduce": 3 * 2 * 16 * 64 * 2}
    assert H.moe_psum(cfg, mesh, 16, act, train=True) == {}
    got = H.combine({"all-gather": 1.0}, {"all-reduce": 2.0, "all-gather": 3.0}, {})
    assert got == {"all-gather": 4.0, "all-reduce": 2.0, "total": 6.0}


def test_cli_resumes_from_its_out(tmp_path, capsys):
    out = tmp_path / "dry.json"
    argv = ["--mesh", "single", "--arch", QWEN, "--shape", "decode_32k", "--out", str(out),
            "--no-extrapolate"]
    first = D.main(argv)
    assert [(r["arch"], r["shape"], r["mesh"]) for r in first] == [
        (QWEN, "decode_32k", "16x16"), ("cache_lookup", "n1m_d768_q16_k8", "16x16")]
    assert all("error" not in r for r in first)
    saved = json.loads(out.read_text())
    capsys.readouterr()
    again = D.main(argv)
    text = capsys.readouterr().out
    assert f"[skip] ('{QWEN}', 'decode_32k', '16x16')" in text
    assert json.loads(out.read_text()) == saved == again
    cache = saved[-1]
    assert cache["kind"] == "cache" and cache["collective_bytes_per_device"]["all-gather"] > 0
    # an error record is redone, the others kept
    broken = [dict(saved[0], error="boom")] + saved[1:]
    out.write_text(json.dumps(broken))
    D.main(argv)
    redone = json.loads(out.read_text())
    assert all("error" not in r for r in redone) and len(redone) == 2
