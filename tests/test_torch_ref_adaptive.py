"""The reference's ``tests/test_adaptive.py`` retargeted to the port: the same
cases and assertions against ``repro_torch``, on the CPU (``device=None``
read as ``"cpu"``, see ``_torch_cpu.py``). The reference's docstring:

Adaptive threshold machinery (§2, §3.1): content policy, controllers.
"""
import pytest

from repro_torch.core.adaptive import (
    DEFAULT_PRICE_TABLE,
    CostController,
    ModelCostInfo,
    QualityRateController,
    ThresholdPolicy,
    classify_content,
)
import torch  # noqa: E402
from _torch_cpu import cpu_by_default  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    cpu_by_default(monkeypatch)


def test_classify_content():
    assert classify_content("Write a python function to sort a list") == "code"
    assert classify_content("def foo(x): return x") == "code"
    assert classify_content("What is the capital of France?") == "text"
    assert classify_content("Explain the history of the Roman empire") == "text"


def test_code_gets_higher_threshold():
    p = ThresholdPolicy(base=0.8)
    t_code = p.compute("Write a python function to parse JSON")
    t_text = p.compute("Tell me about the weather in Paris")
    assert t_code > t_text


def test_expensive_model_lowers_threshold():
    """§2: gpt-4-32k requests should hit the cache more readily than 3.5."""
    p = ThresholdPolicy(base=0.8)
    cheap = p.compute("some question", {"model_info": DEFAULT_PRICE_TABLE["gpt-3.5-turbo-0125"]})
    pricey = p.compute("some question", {"model_info": DEFAULT_PRICE_TABLE["gpt-4-32k"]})
    assert pricey < cheap


def test_token_limit_scales_cost_term():
    p = ThresholdPolicy(base=0.8)
    info = DEFAULT_PRICE_TABLE["gpt-4-32k"]
    small = p.compute("q", {"model_info": info, "max_tokens": 64})
    large = p.compute("q", {"model_info": info, "max_tokens": 4096})
    assert large < small


def test_poor_connectivity_lowers_threshold():
    p = ThresholdPolicy(base=0.8)
    assert p.compute("q", {"connectivity": 0.0}) < p.compute("q", {"connectivity": 1.0})


def test_bounds_respected():
    p = ThresholdPolicy(base=0.95, t_max=0.98)
    assert p.compute("write code to do x " * 3) <= 0.98
    p2 = ThresholdPolicy(base=0.55, t_min=0.5)
    assert p2.compute("q", {"model_info": ModelCostInfo(100, 200, 60), "connectivity": 0.0}) >= 0.5


def test_quality_controller_raises_on_low_quality():
    p = ThresholdPolicy(base=0.8)
    ctl = QualityRateController(p, target=0.8, band=0.05, step=0.02, min_samples=5)
    for _ in range(10):
        ctl.record(False)  # all low-quality hits
    assert p.base > 0.8


def test_quality_controller_lowers_on_high_quality():
    p = ThresholdPolicy(base=0.8)
    ctl = QualityRateController(p, target=0.8, band=0.05, step=0.02, min_samples=5)
    for _ in range(10):
        ctl.record(True)
    assert p.base < 0.8


def test_quality_controller_converges_to_target():
    """Servo convergence: simulated user whose satisfaction rises with t_s."""
    import random

    rnd = random.Random(0)
    p = ThresholdPolicy(base=0.6)
    ctl = QualityRateController(p, target=0.8, band=0.03, step=0.01, window=40)
    for _ in range(400):
        p_high = min(1.0, max(0.0, (p.base - 0.4) / 0.45))  # quality grows with t_s
        ctl.record(rnd.random() < p_high)
    assert 0.65 < abs(ctl.quality_rate) <= 1.0
    assert 0.7 < p.base < 0.9  # settled near where p_high ~ 0.8


def test_cost_controller_targets_hit_rate():
    p = ThresholdPolicy(base=0.9)
    ctl = CostController(p, target_cost_per_request=0.25, step=0.02, min_samples=4)
    # LLM calls cost 1.0 -> target hit rate 0.75; observed 0 hits -> lower t_s
    for _ in range(10):
        ctl.record(1.0, was_hit=False)
    assert abs(ctl.target_hit_rate - 0.75) < 1e-9
    assert p.base < 0.9


def test_cost_controller_backs_off_when_over_hitting():
    p = ThresholdPolicy(base=0.7)
    ctl = CostController(p, target_cost_per_request=0.9, step=0.02, min_samples=4)
    ctl.record(1.0, was_hit=False)
    for _ in range(20):
        ctl.record(0.0, was_hit=True)  # hit rate ~1 >> target 0.1
    assert p.base > 0.7
