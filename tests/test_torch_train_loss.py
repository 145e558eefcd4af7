"""The port's training loss against the reference's, dense, SSM, vision and
audio families: ``transformer.loss_fn`` (next-token CE, vision's text-only
labels after a patch prefix, audio's per-codebook CE) and its gradients by
autograd against ``jax.value_and_grad`` of the reference's ``loss_fn``, each
smoke config in float32 with the reference's weights (``_torch_loss.py``:
1e-4 relative). Also the sequence-chunked CE (``loss_chunk``, a ragged last
chunk), remat on, off and under the "dots" policy giving one gradient, and
``cross_entropy``/``chunked_ce_loss`` against the reference's with a mask."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_loss import check_loss_and_grads, flat

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.training.optimizer import tree_map

torch.set_num_threads(1)

ARCHS = ("qwen1.5-0.5b", "qwen3-8b", "gemma2-27b", "llava-next-mistral-7b", "musicgen-large",
         "mamba2-1.3b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, monkeypatch):
    check_loss_and_grads(arch, monkeypatch=monkeypatch)


def test_vision_prefix_predicts_text_only(monkeypatch):
    check_loss_and_grads("llava-next-mistral-7b", patches=4, monkeypatch=monkeypatch)


def test_chunked_loss_with_a_ragged_chunk(monkeypatch):
    # 15 predicted positions in chunks of 4: the last chunk padded
    check_loss_and_grads("qwen1.5-0.5b", loss_chunk=4, monkeypatch=monkeypatch)


@pytest.mark.parametrize("mask", [False, True])
def test_ce_functions_match_the_reference(mask):
    rng = np.random.default_rng(3)
    cfg = dataclasses.replace(get_config("gemma2-27b", smoke=True), loss_chunk=5,
                              dtype="float32")
    jcfg = dataclasses.replace(j_get_config("gemma2-27b", smoke=True), loss_chunk=5,
                               dtype="float32")
    table = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(np.float32)
    h = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    m = (rng.random((2, 13)) < 0.7).astype(np.float32) if mask else None
    tm = None if m is None else torch.from_numpy(m)
    jm = None if m is None else jnp.asarray(m)
    got = TL.chunked_ce_loss(torch.from_numpy(table), torch.from_numpy(h),
                             torch.from_numpy(labels), cfg, tm)
    want = JL.chunked_ce_loss(jnp.asarray(table), jnp.asarray(h), jnp.asarray(labels), jcfg, jm)
    whole = TL.cross_entropy(TL.unembed_logits(torch.from_numpy(table), torch.from_numpy(h), cfg),
                             torch.from_numpy(labels), tm)
    for g in (got, whole):
        np.testing.assert_allclose([float(g[0]), float(g[1])], [float(want[0]), float(want[1])],
                                   rtol=1e-5)


def test_remat_policies_give_one_gradient():
    """remat off, "full" and "dots" (each layer checkpointed, the last
    keeping its matrix products) differentiate the same function."""
    base = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True), dtype="float32")
    params = TT.init_params(base, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, base.vocab_size, (2, 12)))
    grads = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        tree = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
        loss, _ = TT.loss_fn(tree, cfg, {"tokens": toks})
        loss.backward()
        grads.append({k: v.grad for k, v in flat(tree).items()})
    for other in grads[1:]:
        for k, g in grads[0].items():
            torch.testing.assert_close(other[k], g, rtol=1e-6, atol=1e-7)
