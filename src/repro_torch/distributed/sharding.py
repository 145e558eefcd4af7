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

The placement half: a ``NamedSharding`` is a mesh plus a resolved spec;
its ``shard_shape`` is one position's block and ``index`` that block's
slices. ``shardings_for`` maps a spec tree (nested dicts, tuples such as
``TrainState``) to shardings, ``device_put_tree`` splits a tensor tree
into each position's shards on that position's device, and
``use_mesh`` makes a mesh the target of ``constrain``, which the model
calls on its activations and which checks the spec against the mesh. It
moves nothing: activations stay where the model computes them, and only
the MoE's expert-parallel form (``models/moe.py``) reads the mesh to
split its work by position.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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


def _axes_of(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A mesh and a spec resolved against it (one entry per dimension)."""

    def __init__(self, mesh, spec: Sequence[Axis]):
        self.mesh = mesh
        self.spec = tuple(spec)

    def splits(self) -> Tuple[int, ...]:
        """How many blocks each dimension is cut into."""
        return tuple(int(np.prod([self.mesh.shape[a] for a in _axes_of(e)]))
                     for e in self.spec)

    def over(self, axis: str) -> Tuple[bool, ...]:
        """Whether each dimension is cut over mesh axis ``axis``."""
        return tuple(axis in _axes_of(e) for e in self.spec)

    def axis_split(self, axis: str) -> int:
        """How many blocks the spec cuts over mesh axis ``axis`` (1 where it
        is unused)."""
        return self.mesh.shape[axis] if any(self.over(axis)) else 1

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One position's block of a ``shape`` array."""
        if len(shape) != len(self.spec):
            raise ValueError(f"spec {self.spec} for a {len(shape)}-d shape {tuple(shape)}")
        out = []
        for n, k in zip(shape, self.splits()):
            if n % k:
                raise ValueError(f"{n} does not split into {k} blocks ({self.spec})")
            out.append(n // k)
        return tuple(out)

    def index(self, coords, shape: Sequence[int]) -> Tuple[slice, ...]:
        """The slices of the position at ``coords`` (axis -> index): a
        dimension over axes (a, b) takes block ``i_a * size_b + i_b``
        (row-major over the entry's axes, as a ``PartitionSpec`` does)."""
        block = self.shard_shape(shape)
        out = []
        for e, n in zip(self.spec, block):
            i = 0
            for a in _axes_of(e):
                i = i * self.mesh.shape[a] + int(coords[a])
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)


def named_sharding(mesh, spec: Sequence[Axis], shape: Optional[Sequence[int]] = None
                   ) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(spec, mesh, shape))


def tree_map_specs(fn, specs: Any, *trees: Any, path: Optional[Tuple] = None) -> Any:
    """``fn(spec, *leaves)`` over a spec tree and trees of the same
    structure: nested dicts, lists and tuples (``TrainState`` too), a spec
    leaf (``is_spec_leaf``, or a ``NamedSharding`` in a tree of them)
    meeting a leaf or a whole subtree of the others. Given ``path=()``,
    ``fn(path, spec, *leaves)`` with the keys from the root (a NamedTuple's
    field names)."""
    if is_spec_leaf(specs) or isinstance(specs, NamedSharding):
        return fn(specs, *trees) if path is None else fn(path, specs, *trees)

    def sub(key, v, i):
        return tree_map_specs(fn, v, *(t[i] for t in trees),
                              path=None if path is None else path + (key,))

    if isinstance(specs, dict):
        return {k: sub(k, v, k) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        names = getattr(specs, "_fields", range(len(specs)))
        out = [sub(name, v, i) for i, (name, v) in enumerate(zip(names, specs))]
        return type(specs)(*out) if hasattr(specs, "_fields") else type(specs)(out)
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def _shape_of(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def shardings_for(mesh, specs: Any, shapes: Any = None) -> Any:
    """Map a tree of raw specs (tuples), and the matching tree of tensors or
    shapes, to ``NamedSharding``s."""
    if shapes is None:
        return tree_map_specs(lambda s: named_sharding(mesh, s), specs)
    return tree_map_specs(lambda s, x: named_sharding(mesh, s, _shape_of(x)), specs, shapes)


_MESH = None


class use_mesh:
    """Context manager: make ``mesh`` the target of ``constrain`` and the
    mesh the MoE splits its experts over. Outside it (unit tests, one
    device) both are local."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._prev = None

    def __enter__(self):
        global _MESH
        self._prev, _MESH = _MESH, self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _MESH
        _MESH = self._prev
        return False


def current_mesh():
    return _MESH


def constrain(x: torch.Tensor, spec: Sequence[Axis]) -> torch.Tensor:
    """The reference's sharding constraint on an activation: a no-op
    outside ``use_mesh``; under it the spec must resolve against x's shape
    (``NamedSharding.shard_shape`` raises where it cannot), and x is
    returned as it is — a single-controller mesh keeps activations where
    they were computed."""
    if _MESH is not None:
        named_sharding(_MESH, spec, x.shape).shard_shape(x.shape)
    return x


def device_put_tree(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf of ``tree`` as an object array of the mesh's shape holding
    every position's shard, on that position's device (a view where the
    leaf is on that device already)."""

    def one(spec, x):
        sh = named_sharding(mesh, spec, x.shape)
        out = np.empty(mesh.devices.shape, dtype=object)
        for idx in np.ndindex(*mesh.devices.shape):
            coords = dict(zip(mesh.axis_names, idx))
            out[idx] = x[sh.index(coords, x.shape)].to(mesh.devices[idx])
        return out

    return tree_map_specs(one, specs, tree)
