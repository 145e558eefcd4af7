"""Device meshes for the sharded cache.

A ``Mesh`` here is a single-controller grid of ``torch.device`` positions
with named axes, the shape of ``jax.sharding.Mesh`` as the reference uses
it: one process drives every position, each position holds its slice of
the sharded store on its device, and the candidates of every position are
gathered onto the first position's device. It is not
``torch.distributed.DeviceMesh``: there is no process group, and positions
may repeat a device (eight shards on one card run as eight positions on
that card).

Axes:
  pod   — the outer shard axis (a multi-pod deployment)
  data  — the shard axis of a cache deployment
  model — an axis the sharded read path does not shard over
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device


class Mesh:
    """Named axes over an array of ``torch.device`` positions.

    ``axis_names`` is the axis order, ``shape`` maps each axis to its size
    (in that order, as ``jax.sharding.Mesh.shape`` does) and ``devices`` is
    the object array of devices with that shape."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis names: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, devices.shape))


def _positions(n: int, device: DeviceLike) -> list:
    """``n`` devices: all on ``device`` when one is given, else cycling over
    the visible CUDA devices (raising without one)."""
    if device is not None:
        return [resolve_device(device)] * n
    resolve_device(None)  # raises without a card
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device: DeviceLike) -> Mesh:
    shape = tuple(int(s) for s in shape)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} must be positive")
    devs = np.empty(int(np.prod(shape)), dtype=object)
    for i, d in enumerate(_positions(devs.size, device)):
        devs[i] = d
    return Mesh(devs.reshape(shape), axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *, device: DeviceLike = None) -> Mesh:
    """Small mesh for tests: ``device`` (e.g. ``"cpu"``) at every position,
    or the visible CUDA devices in turn when it is None."""
    return _mesh(tuple(shape), tuple(axes), device)


def make_cache_mesh(n_shards=None, *, device: DeviceLike = None) -> Mesh:
    """1-axis ("data",) mesh for a sharded cache DB: the store's key-sharded
    lanes spread over ``n_shards`` positions. With ``device`` None the
    positions take the visible CUDA devices in turn, one per device by
    default, and it raises without a card; with ``device`` given every
    position is on it (one position by default)."""
    if n_shards is None:
        if device is None:
            resolve_device(None)  # raises without a card
            n_shards = torch.cuda.device_count()
        else:
            n_shards = 1
    return _mesh((int(n_shards),), ("data",), device)
