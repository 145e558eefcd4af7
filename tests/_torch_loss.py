"""The training-loss parity check shared by ``test_torch_train_loss*.py``:
the reference's smoke config in float32 with its random weights carried to
the port by ``params_from_jax``, the same seeded numpy batch, and the
port's ``loss_fn`` value and autograd gradients against the reference's
``loss_fn`` under ``jax.value_and_grad``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as TT

# loss and every gradient leaf within 1e-4 relative: of the loss, of the
# leaf's largest gradient, or of 1e-2 where that is smaller (llama4's top-1
# router gets an exactly-zero gradient, the renormalised gate being 1, and
# both sides are rounding noise there)
TOL = 1e-4
MOE_GAP = 1e-4  # the router's k-th against (k+1)-th score, as chip_smoke's moe: reads it


def flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{pre}{k}/"))
        else:
            out[f"{pre}{k}"] = v
    return out


def batch_for(cfg, rng, B=2, S=16, patches=0):
    shape = (B, cfg.num_codebooks, S) if cfg.modality == "audio" else (B, S)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    out = {"tokens": toks}
    if patches:
        out["vision_embeds"] = rng.standard_normal((B, patches, cfg.d_frontend)).astype(np.float32)
    return out


def router_gaps(monkeypatch):
    """Record, for every routing call of the port, the smallest gap between
    a token's k-th and (k+1)-th router score."""
    gaps = []
    route = t_moe._route

    def recording(params, cfg, x_flat):
        mo = cfg.moe
        logits = x_flat.detach().to(torch.float32) @ params["router"].detach().to(torch.float32)
        if mo.router == "sigmoid_bias":
            s = torch.sigmoid(logits) + params["router_bias"].detach().to(torch.float32)
        else:
            s = torch.softmax(logits, dim=-1)
        top = torch.sort(s, dim=-1, descending=True).values
        gaps.append(float((top[:, mo.top_k - 1] - top[:, mo.top_k]).min()))
        return route(params, cfg, x_flat)

    monkeypatch.setattr(t_moe, "_route", recording)
    return gaps


def check_loss_and_grads(arch, *, seed=0, patches=0, monkeypatch=None, **overrides):
    jc = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32", **overrides)
    tc = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **overrides)
    jp, _ = JT.init_params(jc, jax.random.PRNGKey(seed))
    tp = TT.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    for leaf in flat(tp).values():
        leaf.requires_grad_(True)
    batch = batch_for(jc, np.random.default_rng(seed), patches=patches)
    gaps = router_gaps(monkeypatch) if jc.moe is not None else None

    (jl, jm), jg = jax.value_and_grad(lambda p: JT.loss_fn(p, jc, batch_j(batch)),
                                      has_aux=True)(jp)
    tl, tm = TT.loss_fn(tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
    tl.backward()
    if gaps is not None:
        assert gaps and min(gaps) > MOE_GAP, f"a routing decision within {MOE_GAP}: {gaps}"
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert abs(float(tl.detach()) - float(jl)) <= TOL * abs(float(jl))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=TOL, atol=TOL)
    want, got = flat(jax.tree_util.tree_map(np.asarray, jg)), flat(tp)
    assert set(want) == set(got)
    for key, g in want.items():
        t = got[key].grad
        t = np.zeros_like(g) if t is None else t.numpy()
        assert t.shape == g.shape, key
        err = np.abs(t - np.asarray(g, np.float32)).max()
        assert err <= TOL * max(np.abs(g).max(), 1e-2), (key, err)
    return tl, tm


def batch_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}
