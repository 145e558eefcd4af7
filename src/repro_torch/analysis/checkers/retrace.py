"""RA201/RA202/RA203 — compile-cache misses, implicit bool(tensor), and
host->device uploads that break CUDA-graph capture.

RA201 flags the port's compile caches, its ``functools.lru_cache``
factories (the counterpart of a jit: a plan, a ctypes table or a decide
program built once per key): a per-request size (``len(...)`` /
``.shape``, not routed through a bucketing helper) or an unhashable
literal passed to one, and one built inside a loop or built and called
at once — each such call misses the cache, or grows it per distinct size.

RA202 flags a Python ``if`` / ``while`` / conditional expression /
``assert`` / comprehension filter whose test is a device tensor inside
a device region: an implicit ``bool(tensor)``, which waits for the device
and burns one branch into whatever a graph captures. A region's static
parameters, ``is None`` / ``is not None`` and ``isinstance`` never count.

RA203 flags a host->device upload inside a device region:
``torch.tensor``/``torch.as_tensor`` with a ``device``, ``to_device``,
``.to(<device>)`` / ``.cuda()`` of a host value (``torch.from_numpy``,
numpy, a tensor built without a device), and a Python list or host
array used as an index into a device tensor. A copy from pageable memory
synchronizes the stream, and none can be captured in a CUDA graph: upload
before the region.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis import register
from repro_torch.analysis.core import Finding
from repro_torch.analysis.project import (
    _CACHE_DECORATORS,
    CPU,
    HOST,
    TENSOR,
    UPLOAD_FUNCS,
    FuncInfo,
    ProjectIndex,
    dotted,
    is_cache_factory,
    to_device_arg,
)

_CACHED_TARGET = (ast.Subscript, ast.Attribute)


def _unhashable(node: ast.AST) -> bool:
    return isinstance(
        node,
        (ast.List, ast.Set, ast.Dict, ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp),
    )


def _size_derived(node: ast.AST) -> bool:
    """True when the expression computes a per-request size (len/.shape)
    without routing through a bucketing helper."""
    text = ast.unparse(node)
    if "bucket" in text:
        return False
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) and sub.func.id == "len":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "shape":
            return True
    return False


def _is_cache_build(node: ast.Call) -> bool:
    """``functools.lru_cache(...)(f)`` or ``lru_cache(f)``."""
    fn = node.func
    if isinstance(fn, ast.Call):
        return dotted(fn.func) in _CACHE_DECORATORS
    return dotted(fn) in _CACHE_DECORATORS and bool(node.args)


def upload_message(project: ProjectIndex, fi: FuncInfo, node: ast.AST) -> Optional[str]:
    """Why ``node`` (in device function ``fi``) uploads host data, or None."""
    mod = fi.module
    where = f"inside device region `{fi.qualname}`"
    tail = "; a pageable copy synchronizes the stream and breaks CUDA-graph capture"
    if isinstance(node, ast.Subscript):
        if project.kind(fi, node.value) != TENSOR:
            return None
        idx = node.slice.elts if isinstance(node.slice, ast.Tuple) else [node.slice]
        listy = project.listy.get(id(fi.node), set())
        for i in idx:
            if isinstance(i, (ast.List, ast.ListComp)) or (
                    isinstance(i, ast.Name) and i.id in listy) or (
                    not isinstance(i, ast.Slice) and project.kind(fi, i) == CPU):
                return (f"host index `{ast.unparse(i)}` is uploaded to index a device tensor "
                        f"{where}{tail}")
        return None
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    text = mod.canonical(dotted(fn)) or ""
    last = text.rsplit(".", 1)[-1]
    if text in ("torch.tensor", "torch.as_tensor", "torch.asarray"):
        dev = next((kw.value for kw in node.keywords if kw.arg == "device"), None)
        if dev is not None and not (isinstance(dev, ast.Constant) and dev.value == "cpu") \
                and node.args and project.kind(fi, node.args[0]) != TENSOR:
            return f"{text}(..., device=...) uploads host data {where}{tail}"
        return None
    if last in UPLOAD_FUNCS and (isinstance(fn, ast.Name) or text.startswith("repro_torch")):
        return f"{last}() uploads host data {where}{tail}"
    if isinstance(fn, ast.Attribute):
        recv = project.kind(fi, fn.value)
        if fn.attr == "new_tensor" and node.args and project.kind(fi, node.args[0]) != TENSOR:
            return f".new_tensor() uploads host data {where}{tail}"
        if recv in (HOST, CPU):
            if fn.attr == "cuda":
                return f".cuda() of a host value uploads it {where}{tail}"
            if fn.attr == "to":
                dev = to_device_arg(mod, node)
                if dev is not None and not (isinstance(dev, ast.Constant) and dev.value == "cpu"):
                    return f".to(<device>) of a host value uploads it {where}{tail}"
    return None


@register("retrace")
def check(project: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    factories = {}
    for mod in project.modules:
        for infos in mod.defs.values():
            for fi in infos:
                if is_cache_factory(fi.node):
                    factories[id(fi.node)] = fi

    for mod in project.modules:
        src = mod.src
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and is_cache_factory(node):
                if any(src.enclosing(node, (ast.For, ast.While))):
                    findings.append(Finding(
                        src.rel, node.lineno, "RA201",
                        f"lru_cache factory `{node.name}` defined inside a loop — every "
                        "iteration builds a fresh, empty cache"))
                continue
            if not isinstance(node, ast.Call):
                continue
            if _is_cache_build(node):
                parent = src.parent.get(node)
                if isinstance(parent, ast.Call) and parent.func is node:
                    findings.append(Finding(
                        src.rel, node.lineno, "RA201",
                        "lru_cache(...) built and invoked at once — its cache is "
                        "rebuilt (and missed) on every call; build it once at module scope"))
                elif any(src.enclosing(node, (ast.For, ast.While))):
                    stmt = src.stmt_of(node)
                    cached = isinstance(stmt, ast.Assign) and all(
                        isinstance(t, _CACHED_TARGET) for t in stmt.targets)
                    if not cached:
                        findings.append(Finding(
                            src.rel, node.lineno, "RA201",
                            "lru_cache(...) built inside a loop without being kept — each "
                            "iteration starts from an empty cache"))
                continue
            callee = project.resolve_call(mod, node)
            if callee is None or id(callee.node) not in factories:
                continue
            params = callee.params
            bound = [(params[i] if i < len(params) else f"#{i}", a)
                     for i, a in enumerate(node.args)]
            bound += [(kw.arg, kw.value) for kw in node.keywords if kw.arg]
            for name, value in bound:
                if _unhashable(value):
                    findings.append(Finding(
                        src.rel, value.lineno, "RA201",
                        f"unhashable literal passed as `{name}` to cached factory "
                        f"`{callee.qualname}` — lru_cache raises TypeError on it; pass a "
                        "tuple or hashable scalar"))
                elif _size_derived(value):
                    findings.append(Finding(
                        src.rel, value.lineno, "RA201",
                        f"`{name}` of cached factory `{callee.qualname}` is derived from a "
                        "per-request size — bucket it (see store_bank.bucket_len) or the "
                        "cache grows, and misses, per distinct size"))

    for fi in project.device_funcs.values():
        rel = fi.module.src.rel
        for node in project.body_nodes(fi):
            tests = []
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                tests = [node.test]
            elif isinstance(node, ast.comprehension):
                tests = list(node.ifs)
            listy = project.listy.get(id(fi.node), set())
            for test in tests:
                if isinstance(test, ast.Name) and test.id in listy:
                    continue  # a Python list's emptiness
                if project.kind(fi, test) == TENSOR:
                    findings.append(Finding(
                        rel, test.lineno, "RA202",
                        f"Python branch on device value `{ast.unparse(test)[:60]}` inside "
                        f"device region `{fi.qualname}` — an implicit bool(tensor) waits "
                        "for the device; use torch.where or mark the parameter static"))
            msg = upload_message(project, fi, node)
            if msg:
                findings.append(Finding(rel, node.lineno, "RA203", msg))
    return findings
