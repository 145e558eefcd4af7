"""Run a retargeted reference test against the port on the CPU.

The reference's cache tests build stores, caches, encoders and engines
without naming a device; the port's entry points take ``device=None`` to
mean CUDA and raise without a card. ``cpu_by_default`` makes the port's
device resolution read ``None`` as ``"cpu"`` for one test, in every
``repro_torch`` module that resolves devices, so a test copied from the
reference holds the port to the same assertions with ``device="cpu"``.
An explicit device (``"cuda"``) still means that device."""
import sys

import pytest

from repro_torch.kernels import backend

_resolve = backend.resolve_device


def _cpu_unless_named(device=None):
    return _resolve("cpu" if device is None else device)


def cpu_by_default(monkeypatch: pytest.MonkeyPatch) -> None:
    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch") and getattr(mod, "resolve_device", None) is _resolve:
            monkeypatch.setattr(mod, "resolve_device", _cpu_unless_named)
