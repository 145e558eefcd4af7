"""The port's training end to end on the CPU: the reference's
``tests/test_system.py::test_training_loss_decreases`` and
``::test_checkpoint_restart_resumes_identically`` and
``tests/test_models_smoke.py::test_forward_and_train_step`` (every arch of
``ARCH_NAMES``) and ``::test_param_count_deepseek_scale`` as port cases,
through ``repro_torch.launch.train.main`` and ``transformer.loss_fn``; the
configs' parameter counts against the reference's; the launcher and the
example refusing to run without a card unless ``--device cpu`` is given;
``make_eval_step``."""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch.train import main as train_main
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import tree_leaves, tree_map
from repro_torch.training.train_loop import init_train_state, make_eval_step

torch.set_num_threads(1)


def test_training_loss_decreases():
    losses = train_main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--steps", "60",
                         "--global-batch", "8", "--seq-len", "64", "--lr", "3e-3"])
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_checkpoint_restart_resumes_identically(tmp_path):
    ck = str(tmp_path / "ck")
    # fixed warmup/total so all phases share one LR schedule
    args = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--global-batch", "4",
            "--seq-len", "64", "--lr", "3e-3", "--warmup", "2", "--total-steps", "20",
            "--ckpt-dir", ck]
    full = train_main(args + ["--steps", "20", "--ckpt-every", "100"])
    shutil.rmtree(ck)
    train_main(args + ["--steps", "10", "--ckpt-every", "5"])
    resumed = train_main(args + ["--steps", "20", "--ckpt-every", "5"])
    assert np.allclose(resumed[-1], full[-1], rtol=1e-3), (resumed[-1], full[-1])


def _batch(cfg, rng, B=2, S=32):
    if cfg.modality == "audio":
        return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                        (B, cfg.num_codebooks, S)))}
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.modality == "vision":
        out["vision_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.vision_patches, cfg.d_frontend)).astype(np.float32))
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_and_train_step(arch):
    cfg = get_config(arch, smoke=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, np.random.default_rng(0))
    loss, metrics = T.loss_fn(params, cfg, batch)
    assert loss.shape == () and bool(torch.isfinite(loss)), f"{arch} loss not finite"
    # one gradient step moves the loss
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = T.loss_fn(tracked, cfg, batch)
    leaves = tree_leaves(tracked)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    gn = sum(float(torch.sum(torch.square(g.float()))) for g in grads if g is not None)
    assert np.isfinite(gn) and gn > 0
    it = iter(grads)
    params2 = tree_map(lambda p: p - 0.3 * (g.to(p.dtype) if (g := next(it)) is not None else 0),
                       params)
    loss2, _ = T.loss_fn(params2, cfg, batch)
    assert float(loss2) < float(loss.detach()), f"{arch}: step did not reduce loss"


def test_eval_step_reports_the_loss_without_grad():
    cfg = get_config("deepseek-v3-671b", smoke=True)
    state = init_train_state(cfg, seed=0, device="cpu")
    out = make_eval_step(cfg)(state.params, _batch(cfg, np.random.default_rng(1)))
    assert set(out) == {"loss", "moe_drop_fraction", "mtp_loss"}
    assert not out["loss"].requires_grad and bool(torch.isfinite(out["loss"]))


def test_launcher_and_example_need_a_card_unless_told_cpu(monkeypatch):
    import importlib.util
    from pathlib import Path

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--smoke", "--steps", "1"])
    path = Path(__file__).resolve().parents[1] / "examples" / "torch_train_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main(["--steps", "1"])
    first, last = example.main(["--steps", "2", "--batch", "2", "--seq", "32", "--device", "cpu"])
    assert np.isfinite(first) and np.isfinite(last)


def test_a_layer_cut_keeps_full_width():
    losses = train_main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--layers", "1",
                         "--steps", "2", "--global-batch", "2", "--seq-len", "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True), num_layers=1)
    assert T.init_params(cfg, device="cpu")["layers"]["ln1"].shape[0] == 1


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_parameter_counts_match_the_reference(arch, smoke):
    from repro.configs import get_config as j_get_config

    jc, tc = j_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert tc.layer_kinds() == jc.layer_kinds()
    assert tc.total_params() == jc.total_params()
    assert tc.active_params_per_token() == jc.active_params_per_token()


def test_param_count_deepseek_scale():
    """deepseek-v3 totals ~671B params, ~37B active (the reference's check)."""
    cfg = get_config("deepseek-v3-671b")
    assert 6.0e11 < cfg.total_params() < 7.5e11
    assert 3.0e10 < cfg.active_params_per_token() < 4.5e10
