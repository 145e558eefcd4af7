"""Logical-axis sharding rules resolved against whatever mesh is in use.

Specs in this codebase are written against the *production* axis names
``("pod", "data", "model")``. ``resolve_spec`` adapts a spec to the actual
mesh: axes absent from the mesh are dropped (a single-pod mesh has no
"pod"; test meshes may have neither), and axes that do not divide the
concrete dimension are dropped (e.g. 4 KV heads cannot shard over
model=16 — the sequence axis picks up the slack instead).

The mesh is any object with ``axis_names`` and ``shape`` (axis -> size),
such as ``repro_torch.launch.mesh.Mesh``. A resolved spec is a plain tuple
with one entry per dimension: None, an axis name, or a tuple of names.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np

Axis = Union[None, str, Tuple[str, ...]]

# Canonical logical axes.
BATCH: Axis = ("pod", "data")  # data-parallel batch dim
FSDP: Axis = "data"  # parameter/optimizer fsdp dim
TP: Axis = "model"  # tensor-parallel dim (heads / d_ff / vocab / experts)
SEQ: Axis = "data"  # context-parallel sequence dim (long-context KV)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name]


def _filter_entry(entry: Axis, mesh, dim: Optional[int], used: set) -> Axis:
    """Drop mesh-absent / non-dividing / already-used axes."""
    if entry is None:
        return None
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    kept = []
    prod = 1
    for n in names:
        if n not in mesh.axis_names or n in used:
            continue
        size = _axis_size(mesh, n)
        if dim is not None and dim % (prod * size) != 0:
            continue
        kept.append(n)
        used.add(n)
        prod *= size
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def resolve_spec(
    spec: Sequence[Axis], mesh, shape: Optional[Sequence[int]] = None
) -> Tuple[Axis, ...]:
    """Two-pass resolution with cross-dim axis tracking:

    Pass 1 gives plain-string dims their axis (primary assignments, e.g.
    KV heads -> model); pass 2 lets tuple dims pick up whatever remains
    (fallbacks, e.g. the KV sequence axis takes `model` only when the head
    count couldn't use it). An axis is never assigned to two dims — specs
    may therefore freely list fallbacks without producing an invalid spec.
    """
    used: set = set()
    entries: list = [None] * len(spec)
    order = sorted(range(len(spec)), key=lambda i: isinstance(spec[i], tuple))
    for i in order:
        dim = None if shape is None else shape[i]
        entries[i] = _filter_entry(spec[i], mesh, dim, used)
    return tuple(entries)


def is_spec_leaf(x: Any) -> bool:
    """A spec leaf is None or a plain tuple of axis entries (NOT a NamedTuple,
    which is also a tuple subclass)."""
    if x is None:
        return True
    return (
        isinstance(x, tuple)
        and not hasattr(x, "_fields")
        and all(e is None or isinstance(e, (str, tuple)) for e in x)
    )


def mesh_num_devices(mesh) -> int:
    """Positions of the mesh (the product of its axis sizes)."""
    return int(np.prod(list(mesh.shape.values())))
