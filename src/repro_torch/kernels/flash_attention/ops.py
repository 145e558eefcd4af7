"""Public wrapper for prefill attention: the reference's ``flash_attention``
signature without its TPU knobs (``block_q``/``block_k`` tile a sequential
TPU grid, ``interpret``/``use_kernel`` pick a Pallas backend). The tensor's
device picks the Hopper kernel (CUDA) or its plain version (CPU; and
``meta``, where the dry run counts shapes and operations and nothing is
computed) — see ``kernel.py``. Where autograd records the call (grad
enabled and an input that requires it), a CUDA tensor goes through ``FlashAttentionFn``, the
forward kernel paired with the backward kernels; a CPU tensor's plain
version is differentiated by autograd itself."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel


# repro: device-region static[causal, window, softcap, scale]
def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """q [B,S,H,Dh], k [B,S,KH,Dh], v [B,S,KH,Dv] -> [B,S,H,Dv] (GQA by head
    grouping; Dv = Dh, or MLA's value width)."""
    if q.device.type in ("cpu", "meta"):
        return _kernel.flash_attention_plain(q, k, v, causal=causal, window=window,
                                             softcap=softcap, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _kernel.FlashAttentionFn.apply(q, k, v, causal, window, softcap, scale)
    return _kernel.flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                        scale=scale)
