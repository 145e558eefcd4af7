"""The shapes the backward kernels meet in training, on the CPU: every SSM
and hybrid config of ``repro_torch.configs`` has a state shape that
``ssd_scan.kernel.ssd_scan_bwd_cuda`` takes, every attention config has
widths that ``flash_attention.kernel`` is built for or refuses by its width
check, and what the wrappers do not take is refused before a library is
loaded or a launch counted. Whether each shape fits a block's shared memory
is the library's own answer (``ssd_scan_bwd_plan``), checked on the card in
``tests/test_torch_cuda.py``."""
import dataclasses

import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.ssd_scan import kernel as sk


def _configs():
    return [get_config(n, smoke=s) for n in ARCH_NAMES for s in (False, True)]


SSM_CONFIGS = [c for c in _configs() if c.ssm is not None]


@pytest.mark.parametrize("cfg", SSM_CONFIGS, ids=[f"{c.name}-N{c.ssm.d_state}" for c in SSM_CONFIGS])
def test_every_ssm_config_is_a_shape_the_backward_takes(cfg):
    m = cfg.ssm
    H = cfg.d_inner // m.headdim
    assert m.headdim in sk.HEAD_DIMS and m.d_state <= sk.BWD_MAX_N
    assert H % m.ngroups == 0


def _attention_widths():
    """(Dh, Dv) of every attention config, full and smoke, and MLA's pair."""
    out = set()
    for cfg in _configs():
        if cfg.mla is not None:
            out.add((cfg.mla.qk_head_dim, cfg.mla.v_head_dim))
        elif cfg.num_heads and cfg.head_dim and cfg.family != "ssm":
            out.add((cfg.head_dim, cfg.head_dim))
    return sorted(out)


WIDTHS = _attention_widths()


@pytest.mark.parametrize("widths", WIDTHS, ids=[f"{a}x{b}" for a, b in WIDTHS])
def test_every_attention_config_width_is_built_or_refused(widths):
    """A config width is one the kernels are built for, or (the MLA smoke
    model's q/k 24, v 16, which trains on the CPU) one the width check
    refuses with a ValueError."""
    Dh, Dv = widths
    if Dh in fk.HEAD_DIMS and Dh == Dv or widths in fk.WIDTH_PAIRS:
        fk._check_widths(Dh, Dv)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            fk._check_widths(Dh, Dv)


@pytest.mark.parametrize("widths", [(48, 48), (192, 64), (300, 300)])
def test_flash_widths_it_is_not_built_for_are_refused(widths):
    with pytest.raises(ValueError, match="head_dim"):
        fk._check_widths(*widths)


def _no_load():
    raise AssertionError("the library was loaded for a refused call")


@pytest.mark.parametrize("P,N,match", [(48, 32, "P=48"), (64, 300, "N <= 256")])
def test_ssd_bwd_refuses_before_loading(P, N, match, monkeypatch):
    """A state shape the backward does not take (P outside ``HEAD_DIMS``, N
    past ``BWD_MAX_N``) is refused by the wrapper: the library is neither
    built nor loaded, and nothing is counted as launched."""
    monkeypatch.setattr(sk, "require_sm90", lambda *a: None)
    monkeypatch.setattr(sk.LIB_BWD, "load", _no_load)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 64, 4, P), generator=g)
    bm = torch.randn((1, 64, 1, N), generator=g)
    dt, A, D = torch.full((1, 64, 4), 0.1), -torch.ones(4), torch.ones(4)
    before = sk.bwd_launches
    with pytest.raises(ValueError, match=match):
        sk.ssd_scan_bwd_cuda(x, bm, bm, dt, A, D, x, chunk=64)
    assert sk.bwd_launches == before


def test_ssm_cuts_keep_their_widths():
    """The card-vs-CPU line's zamba2 cut (one Mamba2 block, one application
    of one shared block) keeps every width of the full config."""
    full = get_config("zamba2-7b")
    cut = dataclasses.replace(full, num_layers=1, hybrid_period=1, num_shared_blocks=1)
    for f in ("d_model", "num_heads", "head_dim", "d_ff", "vocab_size", "ssm"):
        assert getattr(cut, f) == getattr(full, f)
