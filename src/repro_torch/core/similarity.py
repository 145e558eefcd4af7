"""Semantic similarity calculator (pluggable metrics, batched scoring)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

METRICS = ("cosine", "dot", "euclidean")


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-9)


def scores(db: torch.Tensor, q: torch.Tensor, metric: str = "cosine") -> torch.Tensor:
    """db [N, D], q [Q, D] -> similarity scores [Q, N] (higher = more similar)."""
    if metric == "cosine":
        return _normalize(q) @ _normalize(db).T
    if metric == "dot":
        return q @ db.T
    if metric == "euclidean":
        d2 = (q * q).sum(-1)[:, None] - 2 * (q @ db.T) + (db * db).sum(-1)[None, :]
        return -torch.sqrt(torch.clamp(d2, min=0.0))
    raise ValueError(f"unknown metric {metric!r}")


def top_k_scores(
    db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor, k: int, metric: str = "cosine"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k search. valid [N] bool. Returns (scores [Q,k], idx [Q,k]);
    ties keep the lower index (stable descending sort)."""
    s = scores(db, q, metric).masked_fill(~valid[None, :], float("-inf"))
    top_s, top_i = torch.sort(s, dim=-1, descending=True, stable=True)
    return top_s[:, :k], top_i[:, :k]


def pairwise_similarity(a: np.ndarray, b: np.ndarray, metric: str = "cosine") -> float:
    ta = torch.as_tensor(np.asarray(a, np.float32))[None]
    tb = torch.as_tensor(np.asarray(b, np.float32))[None]
    return float(scores(tb, ta, metric)[0, 0])
