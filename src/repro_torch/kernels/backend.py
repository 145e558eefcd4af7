"""Device selection for the port: the tensor's device decides.

There is no interpret/compiled matrix here. A kernel wrapper given a CUDA
tensor launches its hand-written Hopper kernel or raises; given a CPU
tensor it runs the kernel's plain PyTorch version. No override or
environment variable swaps the plain version in on the card, where it
would hide the kernel.

Entry points take ``device=None``, which means ``"cuda"``; without a CUDA
device they raise unless the caller asked for ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and absent —
    nothing quietly moves to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def full_fp32() -> None:
    """Run float32 matmuls and convolutions in full float32 (no TF32). TF32
    moves cosine scores by ~1e-3, enough to flip a hit near its threshold,
    so every comparison against a reference runs with this set."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def stage_pinned(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host block for an upcoming device scatter: through pinned memory when
    the target is a CUDA device (the copy can then run asynchronously),
    a plain tensor view of the numpy block on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(rows))
    if device.type == "cuda":
        t = t.pin_memory()
    return t


def to_device(a, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Upload a host array (or pass a tensor through) to ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def fetch(*tensors: torch.Tensor) -> tuple:
    """Copy device tensors to host numpy arrays with ONE synchronisation:
    every copy is queued asynchronously, then the stream is waited on once."""
    if not tensors:
        return ()
    dev = tensors[0].device
    if dev.type != "cuda":
        return tuple(t.detach().numpy() for t in tensors)
    host = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(dev).synchronize()
    return tuple(h.numpy() for h in host)
