"""RA401 — a stale alias of a buffer that a mutator updated in place.

The reference donates the StoreBank's buffers to jitted scatters and
rebinds every buffer from the results, so a name bound to the old buffer
keeps the OLD values. The port's mutators (``store_bank._bank_scatter`` /
``_bank_counter_set`` / ``_bank_free`` / ``_bank_touch`` and their twins
in ``distributed.sharded_store``) update their tensor arguments in place
instead, so a name bound to the buffer — or to a view of it — before the
call sees the NEW values after it: the same code reads different numbers
in the two packages.

The registry of mutators is built from the code: a function is a mutator
when its body stores through a subscript of a parameter (or of a
parameter's attribute), calls an in-place ``*_`` method on one, or passes
one to another mutator. A name bound before the call to a mutated buffer
or a view of it (the attribute itself, a basic slice, ``.view``,
``.reshape``, ``.expand``, ``.T`` ...) and read after the call is
flagged. ``.clone()`` and ``fetch`` break the alias.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import register
from repro_torch.analysis.core import Finding
from repro_torch.analysis.project import FuncInfo, FuncNode, ProjectIndex, dotted

_INPLACE = {"index_put_", "scatter_reduce_", "scatter_", "scatter_add_", "copy_", "fill_",
            "masked_fill_", "masked_scatter_", "zero_", "add_", "sub_", "mul_", "div_",
            "clamp_", "index_add_", "index_copy_", "index_fill_", "put_", "normal_",
            "uniform_", "addcmul_", "addcdiv_", "lerp_", "set_"}
_VIEWS = {"view", "reshape", "expand", "expand_as", "view_as", "flatten", "squeeze",
          "unsqueeze", "transpose", "permute", "narrow", "select", "detach", "unflatten",
          "t", "as_strided", "movedim", "split", "chunk", "unbind"}
_VIEW_ATTRS = {"T", "mT", "H", "data"}


def _base_path(node: ast.AST) -> Optional[str]:
    """The buffer an expression aliases: a Name/Attribute chain, through
    basic slices, view methods and view attributes; None for a copy."""
    if isinstance(node, (ast.Name, ast.Attribute)):
        if isinstance(node, ast.Attribute) and node.attr in _VIEW_ATTRS:
            return _base_path(node.value)
        return dotted(node)
    if isinstance(node, ast.Subscript):
        idx = node.slice.elts if isinstance(node.slice, ast.Tuple) else [node.slice]
        if all(isinstance(i, ast.Slice) or (isinstance(i, ast.Constant) and (
                isinstance(i.value, int) or i.value is None or i.value is Ellipsis))
               for i in idx):
            return _base_path(node.value)
        return None
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
            node.func.attr in _VIEWS:
        return _base_path(node.func.value)
    return None


def _mutated(fi: FuncInfo, project: ProjectIndex, registry) -> Set[Tuple[str, str]]:
    """(parameter, attribute path below it) pairs that ``fi`` updates in place."""
    params = set(fi.params)
    out: Set[Tuple[str, str]] = set()

    def note(expr: ast.AST) -> None:
        path = _base_path(expr)
        if path:
            head, _, rest = path.partition(".")
            if head in params:
                out.add((head, rest))

    for node in ast.walk(fi.node):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Subscript):
                        note(e.value)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                node.func.attr in _INPLACE:
            note(node.func.value)
        elif isinstance(node, ast.Call):
            callee = project.resolve_call(fi.module, node)
            if callee is None or id(callee.node) not in registry:
                continue
            for pos_or_name, sub in registry[id(callee.node)]:
                arg = _arg_for(callee, node, pos_or_name)
                if arg is None:
                    continue
                path = _base_path(arg)
                if path:
                    head, _, rest = path.partition(".")
                    if head in params:
                        out.add((head, ".".join(x for x in (rest, sub) if x)))
    return out


def _arg_for(callee: FuncInfo, call: ast.Call, param: str) -> Optional[ast.AST]:
    params = callee.params
    if callee.cls is not None and isinstance(call.func, ast.Attribute):
        params = params[1:]
    for kw in call.keywords:
        if kw.arg == param:
            return kw.value
    if param in params:
        i = params.index(param)
        if i < len(call.args) and not any(isinstance(a, ast.Starred) for a in call.args[:i + 1]):
            return call.args[i]
    return None


def mutator_registry(project: ProjectIndex) -> Dict[int, Set[Tuple[str, str]]]:
    """Every function's in-place parameter updates, to a fixed point over
    mutators that call mutators."""
    funcs = [fi for mod in project.modules for infos in mod.defs.values() for fi in infos]
    registry: Dict[int, Set[Tuple[str, str]]] = {}
    for _ in range(10):
        changed = False
        for fi in funcs:
            got = _mutated(fi, project, registry)
            if got and got != registry.get(id(fi.node)):
                registry[id(fi.node)] = got
                changed = True
        if not changed:
            break
    return registry


def _statements_after(src, stmt: ast.stmt) -> List[ast.stmt]:
    """Statements that can execute after ``stmt``: suffixes of every
    enclosing block, plus whole bodies of enclosing loops (a later
    iteration re-executes the top of the loop)."""
    after: List[ast.stmt] = []
    cur: ast.AST = stmt
    while True:
        parent = src.parent.get(cur)
        if parent is None:
            break
        for field in ("body", "orelse", "finalbody", "handlers"):
            block = getattr(parent, field, None)
            if isinstance(block, list) and cur in block:
                after.extend(block[block.index(cur) + 1:])
        if isinstance(parent, (ast.For, ast.While)):
            after.extend(parent.body)
        if isinstance(parent, FuncNode):
            break
        cur = parent
    return after


@register("donation")
def check(project: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    registry = mutator_registry(project)
    for mod in project.modules:
        src = mod.src
        for func in [n for n in ast.walk(src.tree) if isinstance(n, FuncNode)]:
            # names bound to a buffer or a view of it: name -> [(line, path)]
            aliases: Dict[str, List[Tuple[int, str]]] = {}
            for stmt in ast.walk(func):
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                        isinstance(stmt.targets[0], ast.Name):
                    path = _base_path(stmt.value)
                    if path and path != stmt.targets[0].id:
                        aliases.setdefault(stmt.targets[0].id, []).append((stmt.lineno, path))
            if not aliases:
                continue
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                callee = project.resolve_call(mod, node)
                if callee is None or id(callee.node) not in registry:
                    continue
                mutated = set()
                for param, sub in registry[id(callee.node)]:
                    arg = _arg_for(callee, node, param)
                    path = _base_path(arg) if arg is not None else None
                    if path:
                        mutated.add(".".join(x for x in (path, sub) if x))
                stmt = src.stmt_of(node)
                for name, binds in aliases.items():
                    hit = [p for ln, p in binds if ln < stmt.lineno and any(
                        p == m or p.startswith(m + ".") for m in mutated)]
                    if not hit:
                        continue
                    for later in _statements_after(src, stmt):
                        use = next((u for u in ast.walk(later) if isinstance(u, ast.Name)
                                    and u.id == name and isinstance(u.ctx, ast.Load)), None)
                        if use is not None:
                            findings.append(Finding(
                                src.rel, use.lineno, "RA401",
                                f"`{name}` aliases `{hit[0]}`, which `{callee.qualname}` "
                                f"(line {node.lineno}) updates in place — the read sees the "
                                "new values where the reference kept the old; .clone() it "
                                "before the call or read the buffer afresh"))
                            break
    return findings
