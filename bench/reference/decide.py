"""The cache's read decision, restated from the paper (§2-§4) in plain
PyTorch: an exact search of every row of every level, the secondary
semantic check, the generative rule, the L1 > L2 walk, the cross-level
generative pool and the template synthesis of a generative answer.

    hit at a level   iff best > t_s(level)
    generative       iff X = {top max_sources with s > t_single} is not
                     empty and sum(X) > t_combined (and best <= t_s)
    pool             the levels' top-k merged, deduplicated by (query,
                     response[:64]), above L1's t_single, capped at
                     max_sources; a hit iff its sum > t_combined

Rows are unit-normalised; scores are float32 dot products (TF32 off).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# the policy's test for code (a code query needs a higher threshold)
_CODE_RE = re.compile(
    r"```|\bdef \w+\(|\bclass \w+|\breturn\b|#include|;\s*$|"
    r"\b(write|generate|implement|fix|debug|refactor)\b.{0,40}\b(code|function|script|program|class|method|sql|regex)\b",
    re.IGNORECASE | re.MULTILINE,
)
SIM_RE = re.compile(r"sim=(-?\d+\.\d{3})")


def policy_threshold(query: str, base: float, policy: dict, max_tokens: int) -> float:
    """The adaptive threshold of the level a client's policy governs (§2):
    base, +offset for code, pulled down by the target model's price and
    latency (its price unknown to the table: the default entry)."""
    t = base + (policy["code_offset"] if _CODE_RE.search(query) else 0.0)
    cost_frac = min(policy["usd_per_mtok_out"] / policy["cost_ref"], 1.0)
    size_frac = min(max_tokens / 4096.0, 1.0)
    t -= policy["cost_pull"] * cost_frac * (0.5 + 0.5 * size_frac)
    t -= policy["latency_pull"] * min(policy["expected_latency_s"] / policy["latency_ref"], 1.0)
    return float(min(max(t, policy["t_min"]), policy["t_max"]))


def synthesize(sources: Sequence[Tuple[float, str, str]]) -> str:
    """The template answer of a generative hit from (score, query,
    response) sources, best first."""
    ordered = sorted(sources, key=lambda s: -s[0])
    parts = [f"[combined from {len(ordered)} cached answers]"]
    parts += [f"- (sim={s:.3f}) Re: {q}\n{r}" for s, q, r in ordered]
    return "\n".join(parts)


@dataclass
class Level:
    """One cache level as the reference sees it: its unit rows [N, d]
    (float32, on the device) and each row's (query, response)."""

    name: str
    rows: torch.Tensor
    entries: List[Tuple[str, str]]


@dataclass
class Decision:
    status: str  # "hit" | "miss"
    level: str  # "L2:semantic", "L1:generative", "multi-level:generative", "miss"
    text: Optional[str]
    best: float  # the winning level's best score (the pool's best for a pool hit)
    sources: List[Tuple[float, str]] = field(default_factory=list)  # (score, query)
    margin: float = float("inf")  # nearest distance of a deciding quantity to its edge


@torch.no_grad()
def top_candidates(q: torch.Tensor, level: Level, k: int, block: int = 256, rnd=None):
    """Exact top-k (scores, slots) of every query against every row of
    the level, in blocks of queries; ``rnd`` rounds the product's
    operands (the control)."""
    s_out, i_out = [], []
    rows = level.rows if rnd is None else rnd(level.rows)
    for b in range(0, q.shape[0], block):
        qb = q[b:b + block] if rnd is None else rnd(q[b:b + block])
        s = qb @ rows.T
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        s_out.append(v.cpu())
        i_out.append(i.cpu())
    return torch.cat(s_out), torch.cat(i_out)


def decide(query: str, cands: Sequence[Tuple[List[float], List[int]]], levels: Sequence[Level],
           thresholds: Sequence[float], t_single: float, t_combined: float,
           max_sources: int) -> Decision:
    """One query's decision from each level's top ``max_sources + 1``
    candidates (float32 scores, best first)."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    margins = []
    t_single32, t_comb32 = f32(t_single), f32(t_combined)
    for (scores, slots), level, thr in zip(cands, levels, thresholds):
        thr32 = f32(thr)
        best = scores[0]
        margins.append(abs(best - thr32))
        margins += [abs(a - b) for a, b in zip(scores[:max_sources], scores[1:max_sources + 1])]
        X = [(s, e) for s, e in zip(scores[:max_sources], slots[:max_sources]) if s > t_single32]
        margins += [abs(s - t_single32) for s in scores[:max_sources]]
        comb = f32(sum(s for s, _ in X))
        if X:
            margins.append(abs(comb - t_comb32))
        if best > thr32:
            q_, r_ = level.entries[slots[0]]
            return Decision("hit", f"{level.name}:semantic", r_, best, [(best, q_)], min(margins))
        if X and comb > t_comb32:
            src = [(s, *level.entries[e]) for s, e in X]
            return Decision("hit", f"{level.name}:generative", synthesize(src), best,
                            [(s, q_) for s, q_, _ in src], min(margins))
    pooled, seen = [], set()
    for (scores, slots), level in zip(cands, levels):
        for s, e in zip(scores[:max_sources], slots[:max_sources]):
            q_, r_ = level.entries[e]
            if s > t_single and (q_, r_[:64]) not in seen:
                seen.add((q_, r_[:64]))
                pooled.append((s, q_, r_))
    pooled.sort(key=lambda x: -x[0])
    pooled = pooled[:max_sources]
    comb = sum(s for s, _, _ in pooled)
    if pooled:
        margins.append(abs(comb - t_combined))
    if pooled and comb > t_combined:
        return Decision("hit", "multi-level:generative", synthesize(pooled), pooled[0][0],
                        [(s, q_) for s, q_, _ in pooled], min(margins))
    return Decision("miss", "miss", None, max(c[0][0] for c in cands), [], min(margins))


def decide_all(queries: Sequence[str], q: torch.Tensor, levels: Sequence[Level],
               thresholds: Sequence[Sequence[float]], t_single: float, t_combined: float,
               max_sources: int, rnd=None) -> List[Decision]:
    """Every query's decision; ``thresholds`` [n][level]."""
    tops = [top_candidates(q, lv, max_sources + 1, rnd=rnd) for lv in levels]
    out = []
    for i, text in enumerate(queries):
        cands = [(t[0][i].tolist(), t[1][i].tolist()) for t in tops]
        out.append(decide(text, cands, levels, thresholds[i], t_single, t_combined,
                          max_sources))
    return out


def mask_sims(text: str) -> Tuple[str, List[float]]:
    """A synthesised answer with its printed scores taken out, and those
    scores."""
    return SIM_RE.sub("sim=*", text), [float(x) for x in SIM_RE.findall(text)]
