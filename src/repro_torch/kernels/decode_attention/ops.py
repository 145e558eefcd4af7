"""Public wrapper for decode attention: the reference's ``decode_attention``
signature without its TPU knobs (``block_s`` tiles a sequential TPU grid,
``interpret``/``use_kernel`` pick a Pallas backend). The tensor's device
picks the Hopper kernel (CUDA) or its plain version (CPU; and ``meta``,
where the dry run counts shapes and operations and nothing is computed) —
see ``kernel.py``."""
from __future__ import annotations

from repro_torch.kernels.decode_attention import kernel as _kernel


# repro: device-region static[window, softcap, scale]
def decode_attention(q, k, v, lengths, *, window=0, softcap=0.0, scale=None):
    """q [B,H,Dh], k/v [B,S,KH,Dh], lengths [B] -> [B,H,Dh]."""
    plain = q.device.type in ("cpu", "meta")
    run = _kernel.decode_attention_plain if plain else _kernel.decode_attention_cuda
    return run(q, k, v, lengths, window=window, softcap=softcap, scale=scale)
