"""Plain PyTorch oracle for the fused similarity + top-k cache lookup
(the port of the reference package's ``similarity_topk/ref.py``)."""
from __future__ import annotations

import torch


def similarity_topk_ref(db, valid, q, k: int, metric: str = "cosine"):
    """db [N, D], valid [N] bool, q [Q, D] -> (scores [Q, k], idx [Q, k]);
    invalid rows score -inf, ties keep the lower index (stable sort)."""
    db = db.to(torch.float32)
    q = q.to(torch.float32)
    if metric == "cosine":
        db = db / torch.clamp(torch.linalg.vector_norm(db, dim=-1, keepdim=True), min=1e-9)
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-9)
    elif metric != "dot":
        raise ValueError(f"unsupported metric {metric!r}")
    s = q @ db.T
    s = s.masked_fill(~valid[None, :], float("-inf"))
    top_s, top_i = torch.sort(s, dim=-1, descending=True, stable=True)
    return top_s[:, :k], top_i[:, :k]


def similarity_topk_lanes_ref(db, valid, q, k: int, metric: str = "cosine"):
    """db [L, N, D], valid [L, N], q [Q, D] -> ([Q, L, k], [Q, L, k]):
    L independent single-lane lookups, stacked along axis 1."""
    outs = [similarity_topk_ref(db[l], valid[l], q, k, metric) for l in range(db.shape[0])]
    return torch.stack([o[0] for o in outs], 1), torch.stack([o[1] for o in outs], 1)
