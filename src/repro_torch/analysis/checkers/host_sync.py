"""RA101 — device->host syncs inside a device region.

The zero-host-hop contract of the read path is that everything between
embed and decide runs as one stream of device work. A stray ``.item()``,
``float()`` of a device tensor, or ``np.asarray`` of one blocks the host
until the stream drains and re-introduces the round-trip the fused read
was built to remove. So do the ops whose output shape depends on the data
(``nonzero``, one-argument ``torch.where``, ``masked_select``, ``unique``,
``bincount``, ``repeat_interleave`` without ``output_size``, a boolean
mask index): they read a count on the host before they can allocate.
Device regions are every function reachable (through the call graph)
from a marked region, an autograd ``Function``, an ``nn.Module.forward``
or a captured callable (``repro_torch.analysis.project``).
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis import register
from repro_torch.analysis.core import Finding
from repro_torch.analysis.project import (
    HOST,
    OBJ,
    SYNC_FUNCS,
    TENSOR,
    FuncInfo,
    ProjectIndex,
    _boolish_syntax,
    dotted,
    not_a_tensor_here,
    to_device_arg,
)

_HOST_BUILTINS = {"float", "int", "bool", "complex"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_NUMPY_FUNCS = {"asarray", "array", "copy", "ascontiguousarray"}
# ops whose output size is a count of the data: computed on the device,
# read on the host before the output can be allocated
_DATA_SHAPED = {"nonzero", "argwhere", "masked_select", "unique", "unique_consecutive",
                "bincount"}


def _is_cpu_target(node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    if isinstance(node, ast.Call) and (dotted(node.func) or "").endswith("device") and \
            node.args and isinstance(node.args[0], ast.Constant) and node.args[0].value == "cpu":
        return True
    return False


def sync_message(project: ProjectIndex, fi: FuncInfo, node: ast.AST) -> Optional[str]:
    """Why ``node`` (in device function ``fi``) makes the host wait for the
    device, or None."""
    mod = fi.module
    where = f"inside device region `{fi.qualname}`"
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        idx = node.slice.elts if isinstance(node.slice, ast.Tuple) else [node.slice]
        boolish = project.boolish.get(id(fi.node), set())
        for i in idx:
            if (_boolish_syntax(i) or (isinstance(i, ast.Name) and i.id in boolish)) and \
                    project.kind(fi, i) == TENSOR and project.kind(fi, node.value) >= OBJ:
                return (f"boolean mask index `{ast.unparse(node)}` reads its count on the "
                        f"host {where}")
        return None
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    text = mod.canonical(dotted(fn)) or ""
    last = text.rsplit(".", 1)[-1] if text else (fn.attr if isinstance(fn, ast.Attribute) else "")
    if isinstance(fn, ast.Attribute):
        recv = project.kind(fi, fn.value)
        if fn.attr in _HOST_METHODS and not node.args and recv >= OBJ:
            return f".{fn.attr}() forces a device->host sync {where}"
        if fn.attr == "to" and _is_cpu_target(to_device_arg(mod, node)) and recv >= OBJ:
            return f".to(cpu) forces a device->host sync {where}"
        if fn.attr == "synchronize":
            return f"{ast.unparse(fn)}() waits for the device {where}"
    if text == "torch.cuda.synchronize":
        return f"torch.cuda.synchronize() waits for the device {where}"
    if last in SYNC_FUNCS and (isinstance(fn, ast.Name) or text.startswith("repro_torch")):
        return f"{last}() copies device tensors to the host and waits {where}"
    if isinstance(fn, ast.Name) and fn.id in _HOST_BUILTINS and node.args and \
            fn.id not in mod.defs:
        if project.kind(fi, node.args[0]) == TENSOR:
            return (f"host {fn.id}() of a device value {where} blocks on a "
                    "device->host transfer")
        return None
    if text.startswith("numpy.") and last in _NUMPY_FUNCS and node.args:
        arg = node.args[0]
        if isinstance(arg, ast.Name) and not_a_tensor_here(mod.src, node, arg.id):
            return None
        if project.kind(fi, arg) >= OBJ:
            return f"np.{last}() materializes a device value on the host {where}"
        return None
    torch_op = text.startswith("torch.") or (
        isinstance(fn, ast.Attribute) and project.kind(fi, fn.value) > HOST)
    if not torch_op:
        return None
    if last in _DATA_SHAPED:
        return f"{last}() sizes its output from the data: a host read {where}"
    if last == "where" and text == "torch.where" and len(node.args) == 1 and not node.keywords:
        return f"one-argument torch.where() is nonzero(): a host read {where}"
    if last == "repeat_interleave" and not any(kw.arg == "output_size" for kw in node.keywords):
        return (f"repeat_interleave() without output_size reads the output length on the "
                f"host {where}")
    return None


@register("host-sync")
def check(project: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for fi in project.device_funcs.values():
        for node in project.body_nodes(fi):
            msg = sync_message(project, fi, node)
            if msg:
                findings.append(Finding(fi.module.src.rel, node.lineno, "RA101", msg))
    return findings
