"""Adaptive thresholds in action (§2, §3.1): content type, model cost,
connectivity, and the two feedback servos.

Run:  PYTHONPATH=src python examples/torch_adaptive_tuning.py
"""
import random

from repro_torch.core.adaptive import (
    DEFAULT_PRICE_TABLE,
    CostController,
    QualityRateController,
    ThresholdPolicy,
)


def main():
    p = ThresholdPolicy(base=0.8)
    print("== effective t_s varies per query/runtime context (§2)")
    rows = [
        ("text query", "Tell me about the french revolution", {}),
        ("code query", "Write a python function to reverse a list", {}),
        ("expensive model", "Tell me about X", {"model_info": DEFAULT_PRICE_TABLE["gpt-4-32k"]}),
        ("cheap model", "Tell me about X", {"model_info": DEFAULT_PRICE_TABLE["gpt-3.5-turbo-0125"]}),
        ("offline", "Tell me about X", {"connectivity": 0.0}),
        ("big response budget", "Tell me about X",
         {"model_info": DEFAULT_PRICE_TABLE["gpt-4-32k"], "max_tokens": 4096}),
    ]
    for name, q, ctx in rows:
        print(f"   {name:20s} t_s = {p.compute(q, ctx):.3f}")

    print("\n== quality-rate servo: drive quality toward t4 = 0.8 (§3.1)")
    rnd = random.Random(0)
    p2 = ThresholdPolicy(base=0.55)
    ctl = QualityRateController(p2, target=0.8, band=0.03, step=0.01, window=40)
    for i in range(400):
        p_high = min(1.0, max(0.0, (p2.base - 0.4) / 0.45))
        ctl.record(rnd.random() < p_high)
        if i % 100 == 0:
            print(f"   step {i:3d}: t_s={p2.base:.3f} quality_rate={ctl.quality_rate:.2f}")
    print(f"   settled: t_s={p2.base:.3f}, quality_rate={ctl.quality_rate:.2f}")

    print("\n== cost servo: steer hit rate toward (c2-c1)/c2")
    p3 = ThresholdPolicy(base=0.95)
    cctl = CostController(p3, target_cost_per_request=0.25, step=0.01)
    rnd = random.Random(1)
    for _ in range(600):
        p_hit = min(1.0, max(0.0, (0.98 - p3.base) / 0.35))
        hit = rnd.random() < p_hit
        cctl.record(0.0 if hit else 1.0, hit)
    print(f"   target hit rate={cctl.target_hit_rate:.2f} "
          f"measured={cctl.measured_hit_rate:.2f} final t_s={p3.base:.3f}")


if __name__ == "__main__":
    main()
