"""Adaptive similarity-threshold machinery (§2, §3.1).

The paper's position: t_s should vary with (a) content type — code demands
higher thresholds than prose; (b) the monetary cost and expected latency of
the request's target model — expensive/slow => lower t_s to favor hits;
(c) connectivity — poor connectivity => serve more from cache; (d) explicit
user preference; and it should be *servoed* by feedback:

  * QualityRateController — users mark cache hits high/low quality; drive
    quality_rate toward target t4 by raising t_s when quality is low and
    lowering it when quality is above target (the paper's §3.1 pseudo-code;
    note its published listing says "increase" in both branches — an obvious
    typo; we implement the stated intent of the surrounding text).
  * CostController — drive the hit rate toward (c2 - c1) / c2 where c1 is
    the user's preferred average cost/request and c2 the observed cost of
    actual LLM calls.
"""
from __future__ import annotations

import re
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ModelCostInfo:
    """Per-model pricing/latency, used to scale t_s (§2).

    Defaults table mirrors the paper's May-13-2024 OpenAI numbers.
    """

    usd_per_mtok_in: float = 0.5
    usd_per_mtok_out: float = 1.5
    expected_latency_s: float = 3.0


# The paper's reference price points (§2): gpt-4-32k output is 80x
# gpt-3.5-turbo-0125 output; input 120x; gpt-4 latencies are higher.
DEFAULT_PRICE_TABLE: Dict[str, ModelCostInfo] = {
    "gpt-3.5-turbo-0125": ModelCostInfo(0.5, 1.5, 3.0),
    "gpt-4-32k": ModelCostInfo(60.0, 120.0, 20.0),
    "gpt-4": ModelCostInfo(30.0, 60.0, 12.0),
    "free-local": ModelCostInfo(0.0, 0.0, 1.0),
}


_CODE_RE = re.compile(
    r"```|\bdef \w+\(|\bclass \w+|\breturn\b|#include|;\s*$|"
    r"\b(write|generate|implement|fix|debug|refactor)\b.{0,40}\b(code|function|script|program|class|method|sql|regex)\b",
    re.IGNORECASE | re.MULTILINE,
)


def classify_content(query: str) -> str:
    """'code' queries need near-exact matches; 'text' tolerates lower t_s."""
    return "code" if _CODE_RE.search(query) else "text"


@dataclass
class ThresholdPolicy:
    """Computes the effective t_s per query from base + runtime terms."""

    base: float = 0.8
    t_min: float = 0.5
    t_max: float = 0.98
    content_offsets: Dict[str, float] = field(
        default_factory=lambda: {"text": 0.0, "code": 0.12}
    )
    # scaling for cost/latency: a model at `cost_ref` USD/mtok-out or
    # `latency_ref` seconds pulls t_s down by up to `cost_pull`/`latency_pull`.
    cost_ref: float = 120.0
    cost_pull: float = 0.10
    latency_ref: float = 30.0
    latency_pull: float = 0.05

    def compute(self, query: str, context: Optional[dict] = None) -> float:
        ctx = context or {}
        t = self.base
        t += self.content_offsets.get(classify_content(query), 0.0)
        info: Optional[ModelCostInfo] = ctx.get("model_info")
        if info is not None:
            cost_frac = min(info.usd_per_mtok_out / self.cost_ref, 1.0)
            # expected response size scales cost: honor a max_tokens hint
            size_frac = min(ctx.get("max_tokens", 1024) / 4096.0, 1.0)
            t -= self.cost_pull * cost_frac * (0.5 + 0.5 * size_frac)
            t -= self.latency_pull * min(info.expected_latency_s / self.latency_ref, 1.0)
        connectivity = ctx.get("connectivity", 1.0)  # 0 = offline, 1 = healthy
        t -= 0.15 * (1.0 - connectivity)
        t += ctx.get("user_threshold_offset", 0.0)
        return float(min(max(t, self.t_min), self.t_max))


class QualityRateController:
    """§3.1 feedback servo on the base threshold."""

    def __init__(
        self,
        policy: ThresholdPolicy,
        target: float = 0.8,
        band: float = 0.05,
        step: float = 0.02,
        window: int = 50,
        min_samples: int = 5,
    ):
        self.policy = policy
        self.target = target
        self.band = band
        self.step = step
        self.min_samples = min_samples
        self._feedback = deque(maxlen=window)

    @property
    def quality_rate(self) -> float:
        if not self._feedback:
            return 1.0
        return sum(self._feedback) / len(self._feedback)

    def record(self, high_quality: bool) -> None:
        self._feedback.append(1.0 if high_quality else 0.0)
        self.maybe_adjust()

    def maybe_adjust(self) -> float:
        if len(self._feedback) >= self.min_samples:
            qr = self.quality_rate
            if qr < self.target - self.band:
                self.policy.base = min(self.policy.base + self.step, self.policy.t_max)
            elif qr > self.target + self.band:
                self.policy.base = max(self.policy.base - self.step, self.policy.t_min)
        return self.policy.base


class CostController:
    """§3.1 cost servo: steer hit rate toward (c2 - c1) / c2."""

    def __init__(
        self,
        policy: ThresholdPolicy,
        target_cost_per_request: float,
        step: float = 0.02,
        window: int = 100,
        min_samples: int = 5,
    ):
        self.policy = policy
        self.c1 = target_cost_per_request
        self.step = step
        self.min_samples = min_samples
        self._requests = deque(maxlen=window)  # (cost_usd, was_hit)

    def record(self, cost_usd: float, was_hit: bool) -> None:
        self._requests.append((cost_usd, was_hit))
        self.maybe_adjust()

    @property
    def measured_hit_rate(self) -> float:
        if not self._requests:
            return 0.0
        return sum(1 for _, h in self._requests if h) / len(self._requests)

    @property
    def llm_cost_per_call(self) -> float:
        costs = [c for c, h in self._requests if not h]
        return sum(costs) / len(costs) if costs else 0.0

    @property
    def target_hit_rate(self) -> float:
        c2 = self.llm_cost_per_call
        if c2 <= self.c1 or c2 == 0.0:
            return 0.0
        return (c2 - self.c1) / c2

    def maybe_adjust(self) -> float:
        if len(self._requests) >= self.min_samples:
            if self.measured_hit_rate < self.target_hit_rate:
                self.policy.base = max(self.policy.base - self.step, self.policy.t_min)
            elif self.measured_hit_rate > self.target_hit_rate + 0.05:
                self.policy.base = min(self.policy.base + self.step, self.policy.t_max)
        return self.policy.base
