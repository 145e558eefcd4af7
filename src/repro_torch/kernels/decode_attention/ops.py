"""Public wrapper for decode attention: the reference's ``decode_attention``
signature without its TPU knobs (``block_s`` tiles a sequential TPU grid,
``interpret``/``use_kernel`` pick a Pallas backend). The tensor's device
picks the Hopper kernel (CUDA) or its plain version (CPU) — see
``kernel.py``."""
from __future__ import annotations

from repro_torch.kernels.decode_attention import kernel as _kernel


def decode_attention(q, k, v, lengths, *, window=0, softcap=0.0, scale=None):
    """q [B,H,Dh], k/v [B,S,KH,Dh], lengths [B] -> [B,H,Dh]."""
    on_cpu = q.device.type == "cpu"
    run = _kernel.decode_attention_plain if on_cpu else _kernel.decode_attention_cuda
    return run(q, k, v, lengths, window=window, softcap=softcap, scale=scale)
