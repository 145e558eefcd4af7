"""Fault-tolerant checkpointing: npz + atomic manifest (the port of the
reference's ``checkpoint/checkpoint.py``, in its layout, so a checkpoint
crosses between the two packages in both directions).

Layout: ``<dir>/step_<n:08d>/arrays.npz`` + ``manifest.json``, written in a
``.tmp`` directory that ``os.replace`` commits last, so a crash mid-save
never corrupts the latest valid checkpoint; ``keep`` bounds how many are
retained. Leaves are keyed by their path in the tree (``params/embed/table``,
``opt_state/embed/table/m``, ``step``; a NamedTuple by its field names,
lists by index), "/" written as "|" in the npz. Arrays are saved whole, on
the host; restore puts each on the template leaf's device and dtype.

bfloat16. numpy has no bfloat16; the reference's leaves are ml_dtypes
bfloat16 arrays, which ``np.savez`` stores as 2-byte void (``|V2``) and its
restore views back. The port writes a bfloat16 tensor's bits the same way
(its int16 view as ``|V2``) and reads a ``|V2`` leaf as int16 viewed as
``torch.bfloat16``; the manifest names the dtype "bfloat16" on both sides.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _rebuild(template: Any, leaf, prefix: str = "") -> Any:
    """``template``'s structure with each leaf replaced by ``leaf(key, t)``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, leaf, f"{prefix}{k}/") for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, k), leaf, f"{prefix}{k}/")
                                for k in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaf, f"{prefix}{i}/") for i, v in enumerate(template))
    return leaf(prefix[:-1], template)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:  # the reference's layout: 2-byte void
            return v.view(torch.int16).numpy().view(np.dtype("V2"))
        return v.numpy()
    return np.asarray(v)


def _dtype_name(v, a: np.ndarray) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(a.dtype)


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    state: Any,
    extra: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    flat = _flatten(state)
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **{k.replace("/", "|"): v for k, v in arrays.items()})
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: _dtype_name(flat[k], v) for k, v in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)  # atomic commit

    # retention
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
    return path


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _to_leaf(a: np.ndarray, t) -> Any:
    """The saved array as a tensor of the template leaf's dtype on its device
    (``|V2`` read as bfloat16 bits); a template leaf that is no tensor takes
    the numpy array."""
    if not isinstance(t, torch.Tensor):
        return a
    if a.dtype.kind == "V":
        if a.dtype.itemsize != 2:
            raise TypeError(f"a {a.dtype} leaf has no torch dtype")
        out = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        out = torch.from_numpy(np.array(a))
    return out.to(device=t.device, dtype=t.dtype)


def restore_checkpoint(
    ckpt_dir: str,
    template: Any,
    step: Optional[int] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``template`` (the state a fresh run
    builds), each leaf on the template leaf's device and in its dtype.
    Returns (state, the manifest's ``extra``)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k.replace("|", "/"): z[k] for k in z.files}

    missing = set(_flatten(template)) - set(arrays)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    restored = _rebuild(template, lambda key, t: _to_leaf(arrays[key], t))
    return restored, manifest["extra"]
