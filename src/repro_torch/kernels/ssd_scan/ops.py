"""Public wrapper for the SSD chunked scan: the reference's ``ssd_scan``
signature without its TPU knobs (``interpret``/``use_kernel`` pick a Pallas
backend). The tensor's device picks the Hopper kernel (CUDA) or its plain
version (CPU) — see ``kernel.py``. ``Bm``/``Cm`` may carry G groups shared
by H // G heads each, as well as one row per head (G = H)."""
from __future__ import annotations

from repro_torch.kernels.ssd_scan import kernel as _kernel


def ssd_scan(x, Bm, Cm, dt, A, D, *, chunk: int = 128):
    """x [B,S,H,P], Bm/Cm [B,S,G,N], dt [B,S,H] f32, A/D [H] f32
    -> (y [B,S,H,P] in x's dtype, final state [B,H,P,N] f32)."""
    on_cpu = x.device.type == "cpu"
    run = _kernel.ssd_scan_plain if on_cpu else _kernel.ssd_scan_cuda
    return run(x, Bm, Cm, dt, A, D, chunk=chunk)
