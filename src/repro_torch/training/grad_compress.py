"""Gradient compression for the cross-pod axis (the port of the reference's
``training/grad_compress.py``).

int8 absmax compression with error feedback: before a slow all-reduce,
gradients are quantized to int8 with per last-axis row scales, and the
quantization residual is carried into the next step's gradient (error
feedback keeps the scheme unbiased over time). ``compress_with_error_feedback``
returns the round trip, what the reduce would transport. The sharded
trainer that would call it comes with ROADMAP A15.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training.optimizer import tree_map

F32 = torch.float32


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = torch.amax(torch.abs(g), dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_with_error_feedback(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Returns (compressed-then-decompressed grads, new error state); a
    None ``error`` starts from zeros."""
    error = init_error_state(grads) if error is None else error

    def one(g, e):
        g32 = g.to(F32) + e
        deq = decompress(*compress(g32))
        return deq.to(g.dtype), g32 - deq

    pairs = tree_map(one, grads, error)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def init_error_state(grads_template: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), grads_template)
