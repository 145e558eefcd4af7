"""The port's training loss against the reference's, MoE (llama4-scout's
top-1 softmax router, deepseek-v3's MLA, sigmoid_bias top-2 router and
its multi-token-prediction head at weight 0.3, reported as ``mtp_loss``),
the hybrid (zamba2) and gemma3's local/global layers: ``loss_fn`` and its
autograd gradients against ``jax.value_and_grad`` of the reference's, each
smoke config in float32 with the reference's weights (``_torch_loss.py``:
1e-4 relative). Before comparing, every routing decision of the port is
checked to lie more than 1e-4 from a tie, so no expert can flip between
the two packages; ``moe_drop_fraction`` is compared as well."""
import pytest
import torch
from _torch_loss import check_loss_and_grads

torch.set_num_threads(1)

ARCHS = ("gemma3-4b", "zamba2-7b", "llama4-scout-17b-a16e", "deepseek-v3-671b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, monkeypatch):
    _, metrics = check_loss_and_grads(arch, monkeypatch=monkeypatch)
    if arch == "deepseek-v3-671b":
        assert set(metrics) == {"moe_drop_fraction", "mtp_loss"}
