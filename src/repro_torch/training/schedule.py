"""LR schedules (the port of the reference's ``training/schedule.py``):
float32 scalars computed on the host, as the reference computes them in
float32."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``final_frac * peak_lr`` at ``total_steps``."""
    step = torch.as_tensor(step, dtype=F32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step, dtype=F32), peak_lr)
