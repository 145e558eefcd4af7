"""The port's expert-parallel MoE (``moe_ffn`` under ``use_mesh``, i.e.
``_moe_ffn_sharded``) against the reference's ``_moe_ffn_sharded`` (a
``shard_map``) on the same meshes, at the two MoE smoke configs:
llama4-scout's softmax top-1 router and deepseek-v3's ``sigmoid_bias``
top-2 router with a nonzero bias, each with its shared expert.

The reference needs as many devices as mesh positions, and tier-1's JAX
has one, so it runs once, in a subprocess with 8 forced host devices: this
file re-executes itself as a script and writes every case's outputs (and
float32 gradients) to an npz. The port runs the same cases on CPU
positions of its single-controller ``Mesh``.

Meshes (1, 4), (2, 2) and (2, 4) data x model and (2, 2, 2) pod x data x
model; a batch that data does not divide (the batch axes drop, as the
reference drops them); a binding capacity factor (drops > 0) and a loose
one; float32 and bfloat16. Expert ids and the drop fraction are exact;
outputs within 1e-5 in float32 and within 2 bfloat16 ulps of the output's
magnitude in bfloat16 (each model position rounds its partial output to
bfloat16 before the sum, in both packages). The gradients of a fixed
linear functional of the output with respect to x and the expert weights
match ``jax.grad`` of the reference's sharded form in float32 (within
1e-5 of each gradient's largest magnitude: sums over every token). The
data-axis identity is checked on the port alone: data = 2 equals the local
path run on each batch half, its drop fraction the mean of the halves'.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ARCHS = {"llama4": "llama4-scout-17b-a16e", "deepseek": "deepseek-v3-671b"}
MESHES = {
    "d1m4": ((1, 4), ("data", "model")),
    "d2m2": ((2, 2), ("data", "model")),
    "d2m4": ((2, 4), ("data", "model")),
    "p2d2m2": ((2, 2, 2), ("pod", "data", "model")),
}
S = 24
# (arch, mesh, batch, capacity factor, dtype)
CASES = [(a, m, 4, 0.5, "float32") for a in ARCHS for m in MESHES]
CASES += [(a, "d2m4", 4, 4.0, "float32") for a in ARCHS]  # loose: nothing drops
CASES += [(a, "d2m2", 3, 0.5, "float32") for a in ARCHS]  # data does not divide B
CASES += [(a, m, 4, 0.5, "bfloat16") for a in ARCHS for m in ("d1m4", "p2d2m2")]
GRAD_LEAVES = ("w_gate", "w_up", "w_down", "shared_gate", "shared_up", "shared_down")


def _name(case):
    a, m, b, cf, dt = case
    return f"{a}-{m}-B{b}-cf{cf}-{dt}"


def _config(get_config, arch, dtype):
    return dataclasses.replace(get_config(ARCHS[arch], smoke=True), dtype=dtype)


def _inputs(cfg, batch, seed):
    """numpy float32 parameters (router_bias nonzero) and x [B, S, D]; the
    tokens share an offset so the router favours some experts (and, at
    the binding factor, every batch shard drops)."""
    rng = np.random.default_rng(seed)
    mo, D = cfg.moe, cfg.d_model
    E, F = mo.num_experts, mo.d_ff_expert
    Fs = mo.d_ff_shared * mo.num_shared_experts
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F),
         "shared_gate": rng.standard_normal((D, Fs)) / np.sqrt(D),
         "shared_up": rng.standard_normal((D, Fs)) / np.sqrt(D),
         "shared_down": rng.standard_normal((Fs, D)) / np.sqrt(Fs)}
    if mo.router == "sigmoid_bias":
        p["router_bias"] = 0.5 * rng.standard_normal((E,))
    x = rng.standard_normal((batch, S, D)) + 1.0
    probe = rng.standard_normal((batch, S, D))  # the fixed linear functional
    return ({k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32),
            probe.astype(np.float32))


def _bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


def _case_inputs(case, cfg):
    p, x, probe = _inputs(cfg, case[2], seed=len(_name(case)) + 7 * case[2])
    if case[4] == "bfloat16":  # the experts and x in bfloat16, the router float32
        p = {k: v if k in ("router", "router_bias") else _bf16_round(v) for k, v in p.items()}
        x = _bf16_round(x)
    return p, x, probe


def _run_reference(path):
    """Every case through the reference's sharded form (8 host devices)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.distributed.sharding import use_mesh
    from repro.launch.mesh import make_test_mesh
    from repro.models import moe

    assert len(jax.devices()) == 8, jax.devices()
    out = {}
    for case in CASES:
        arch, mesh_name, _, cf, dtype = case
        cfg = _config(get_config, arch, dtype)
        p, x, probe = _case_inputs(case, cfg)
        jdt = jnp.dtype(dtype)
        jp = {k: jnp.asarray(v, jnp.float32 if k in ("router", "router_bias") else jdt)
              for k, v in p.items()}
        jx = jnp.asarray(x, jdt)
        shape, axes = MESHES[mesh_name]
        mesh = make_test_mesh(shape, axes)
        name = _name(case)

        def fwd(params, xx, cfg=cfg, cf=cf):
            return moe.moe_ffn(params, cfg, xx, capacity_factor=cf)

        def loss(params, xx, fwd=fwd, probe=jnp.asarray(probe)):
            return jnp.sum(fwd(params, xx)[0] * probe)

        with use_mesh(mesh):
            y, m = jax.jit(fwd)(jp, jx)
            out[f"{name}|y"] = np.asarray(jnp.asarray(y, jnp.float32))
            out[f"{name}|drop"] = np.asarray(m["moe_drop_fraction"], np.float32)
            if dtype == "float32":
                gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jx)
                out[f"{name}|gx"] = np.asarray(gx)
                for k in GRAD_LEAVES:
                    out[f"{name}|g_{k}"] = np.asarray(gp[k])
        idx, _ = moe._route(jp, cfg, jx.reshape(-1, cfg.d_model))
        out[f"{_name(case)}|ids"] = np.asarray(idx)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs on 8 forced host devices, computed once in a
    subprocess that runs this file as a script."""
    out = tmp_path_factory.mktemp("moe_sharded") / "reference.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
    env["JAX_PLATFORMS"] = "cpu"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.path.join(root, "src")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                       cwd=root, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _port(case, grads=False):
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe

    arch, mesh_name, _, cf, dtype = case
    cfg = _config(get_config, arch, dtype)
    p, x, probe = _case_inputs(case, cfg)
    tdt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(v).to(torch.float32 if k in moe.FLOAT32_PARAMS else tdt)
          for k, v in p.items()}
    tx = torch.from_numpy(x).to(tdt)
    if grads:
        for k in GRAD_LEAVES:
            tp[k].requires_grad_(True)
        tx.requires_grad_(True)
    shape, axes = MESHES[mesh_name]
    with use_mesh(make_test_mesh(shape, axes, device="cpu")):
        y, m = moe.moe_ffn(tp, cfg, tx, capacity_factor=cf)
    out = {"y": y, "drop": m["moe_drop_fraction"], "cfg": cfg, "p": tp, "x": tx}
    if grads:
        (y * torch.from_numpy(probe)).sum().backward()
    idx, _ = moe._route(tp, cfg, tx.detach().reshape(-1, cfg.d_model))
    out["ids"] = idx
    return out


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_sharded_moe_matches_reference(reference, case):
    name = _name(case)
    got = _port(case)
    np.testing.assert_array_equal(got["ids"].numpy(), reference[f"{name}|ids"])
    assert np.float32(got["drop"].item()) == reference[f"{name}|drop"]
    cf = case[3]
    assert (got["drop"].item() > 0) == (cf < 1.0)  # the binding factor drops, the loose not
    y = got["y"].detach().to(torch.float32).numpy()
    want = reference[f"{name}|y"]
    assert y.shape == want.shape
    if case[4] == "float32":
        np.testing.assert_allclose(y, want, atol=1e-5, rtol=1e-5)
    else:  # 2 bfloat16 ulps (2^-7 relative each) of the output's magnitude
        tol = 2 * 2.0 ** -7 * np.abs(want).max()
        assert np.abs(y - want).max() <= tol, float(np.abs(y - want).max() / tol)


@pytest.mark.parametrize("case", [c for c in CASES if c[4] == "float32" and c[3] < 1.0],
                         ids=_name)
def test_sharded_moe_gradients_match_reference(reference, case):
    name = _name(case)
    got = _port(case, grads=True)
    pairs = [("x", got["x"].grad, reference[f"{name}|gx"])]
    pairs += [(k, got["p"][k].grad, reference[f"{name}|g_{k}"]) for k in GRAD_LEAVES]
    for k, g, want in pairs:  # 1e-5 of the gradient's largest magnitude
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_data_axis_is_the_local_path_per_batch_half(arch):
    """data = 2, model = 4: the output equals the local path (no mesh) on
    each half of the batch, and the drop fraction is the mean of the
    halves' (the model axis alone, data = 1, is the local path within the
    float32 sums' order)."""
    from repro_torch.models import moe

    case = (arch, "d2m4", 4, 0.5, "float32")
    got = _port(case)
    cfg, p, x = got["cfg"], got["p"], got["x"]
    ys, drops = [], []
    for half in (x[:2], x[2:]):
        y, m = moe.moe_ffn(p, cfg, half, capacity_factor=0.5)
        ys.append(y)
        drops.append(m["moe_drop_fraction"])
    np.testing.assert_allclose(got["y"].numpy(), torch.cat(ys).numpy(), atol=1e-5, rtol=1e-5)
    assert got["drop"].item() == ((drops[0] + drops[1]) / 2).item()
    one = _port((arch, "d1m4", 4, 0.5, "float32"))
    y, m = moe.moe_ffn(p, cfg, x, capacity_factor=0.5)
    np.testing.assert_allclose(one["y"].numpy(), y.numpy(), atol=1e-5, rtol=1e-5)
    assert one["drop"].item() == m["moe_drop_fraction"].item()


def test_positions_on_one_device_take_views(monkeypatch):
    """A mesh whose positions repeat the tensors' device slices the weights
    without a copy (the expert slices share the weights' storage)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe

    cfg = _config(get_config, "llama4", "float32")
    p, x, _ = _inputs(cfg, 2, 0)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    seen = []
    real = moe._dispatch_compute

    def spy(lp, *a, **kw):
        seen.append(all(lp[k].untyped_storage().data_ptr() == tp[k].untyped_storage().data_ptr()
                        for k in ("w_gate", "w_up", "w_down")))
        return real(lp, *a, **kw)

    monkeypatch.setattr(moe, "_dispatch_compute", spy)
    with use_mesh(make_test_mesh((1, 4), ("data", "model"), device="cpu")):
        moe.moe_ffn(tp, cfg, torch.from_numpy(x))
    assert seen == [True] * 4


if __name__ == "__main__":
    _run_reference(sys.argv[1])
