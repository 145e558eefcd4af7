"""Public wrapper for the SSD chunked scan: the reference's ``ssd_scan``
signature without its TPU knobs (``interpret``/``use_kernel`` pick a Pallas
backend). The tensor's device picks the Hopper kernel (CUDA) or its plain
version (CPU; and ``meta``, where the dry run counts shapes and operations
and nothing is computed) — see ``kernel.py``. ``Bm``/``Cm`` may carry G groups shared
by H // G heads each, as well as one row per head (G = H).

Where autograd records the call (grad enabled and an input that requires
it), a CUDA tensor goes through ``SsdScanFn``, the forward kernel paired
with the backward kernels; a CPU tensor's plain version is differentiated
by autograd itself."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel as _kernel


def ssd_scan(x, Bm, Cm, dt, A, D, *, chunk: int = 128):  # repro: device-region static[chunk]
    """x [B,S,H,P], Bm/Cm [B,S,G,N], dt [B,S,H] f32, A/D [H] f32
    -> (y [B,S,H,P] in x's dtype, final state [B,H,P,N] f32)."""
    if x.device.type in ("cpu", "meta"):
        return _kernel.ssd_scan_plain(x, Bm, Cm, dt, A, D, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, Bm, Cm, dt, A, D)):
        return _kernel.SsdScanFn.apply(x, Bm, Cm, dt, A, D, chunk)
    return _kernel.ssd_scan_cuda(x, Bm, Cm, dt, A, D, chunk=chunk)
