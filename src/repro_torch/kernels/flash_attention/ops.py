"""Public wrapper for prefill attention: the reference's ``flash_attention``
signature without its TPU knobs (``block_q``/``block_k`` tile a sequential
TPU grid, ``interpret``/``use_kernel`` pick a Pallas backend). The tensor's
device picks the Hopper kernel (CUDA) or its plain version (CPU) — see
``kernel.py``."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel as _kernel


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """q [B,S,H,Dh], k [B,S,KH,Dh], v [B,S,KH,Dv] -> [B,S,H,Dv] (GQA by head
    grouping; Dv = Dh, or MLA's value width)."""
    on_cpu = q.device.type == "cpu"
    run = _kernel.flash_attention_plain if on_cpu else _kernel.flash_attention_cuda
    return run(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
