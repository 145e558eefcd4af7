"""Token sampling for the serving engine (the port of the reference's
``serving/sampler.py``).

Greedy takes the first maximum, as ``jnp.argmax`` does. Temperature
sampling is Gumbel-max over uniforms drawn from an explicit
``torch.Generator`` — the same rule as ``jax.random.categorical``, but not
its random numbers, so the two packages agree at temperature 0 only."""
from __future__ import annotations

from typing import Optional

import torch


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits [..., V] -> token ids [...] (int32). temperature 0 = greedy."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / temperature
    if top_k:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)
