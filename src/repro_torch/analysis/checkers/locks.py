"""RA301 — `# guarded-by: <lock>` attributes accessed outside their lock.

The serving layer (CacheService, BatchCoalescer, ServingEngine,
EnhancedClient) keeps its threaded schedulers correct with hand-maintained
locks. Attributes declare their lock with a trailing comment on the
``__init__`` assignment::

    self._inflight = 0  # guarded-by: _lock

Every later ``self.<attr>`` read or write (outside ``__init__``) must then
sit lexically inside ``with self._lock:``. Condition variables constructed
over a lock (``self._capacity = threading.Condition(self._lock)``) count
as aliases of that lock. A method that is documented to be called with the
lock already held can declare ``# repro: holds[_lock]`` on its ``def``
line.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from repro_torch.analysis import register
from repro_torch.analysis.core import GUARDED_RE, HOLDS_RE, Finding
from repro_torch.analysis.project import FuncNode, ProjectIndex, dotted


def _class_lock_tables(src, cls: ast.ClassDef):
    guarded: Dict[str, str] = {}  # attr -> lock attr
    aliases: Dict[str, str] = {}  # condition attr -> underlying lock attr
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                comment = src.comments.get(node.lineno, "")
                m = GUARDED_RE.search(comment)
                if m:
                    guarded[tgt.attr] = m.group(1)
                val = node.value
                if (
                    isinstance(val, ast.Call)
                    and dotted(val.func) in ("threading.Condition", "Condition")
                    and val.args
                ):
                    lock = dotted(val.args[0])
                    if lock and lock.startswith("self."):
                        aliases[tgt.attr] = lock.split(".", 1)[1]
    return guarded, aliases


def _locks_held(src, node: ast.AST, aliases: Dict[str, str]) -> Set[str]:
    held: Set[str] = set()
    for w in src.enclosing(node, (ast.With, ast.AsyncWith)):
        for item in w.items:
            text = dotted(item.context_expr)
            if text and text.startswith("self."):
                attr = text.split(".", 1)[1]
                held.add(attr)
                if attr in aliases:
                    held.add(aliases[attr])
    return held


@register("locks")
def check(project: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        src = mod.src
        for cls in mod.classes.values():
            guarded, aliases = _class_lock_tables(src, cls)
            if not guarded:
                continue
            for method in cls.body:
                if not isinstance(method, FuncNode) or method.name == "__init__":
                    continue
                holds: Set[str] = set()
                m = HOLDS_RE.search(src.comments.get(method.lineno, ""))
                if m:
                    holds.add(m.group(1))
                for node in ast.walk(method):
                    if not (
                        isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"
                        and node.attr in guarded
                    ):
                        continue
                    lock = guarded[node.attr]
                    held = _locks_held(src, node, aliases) | holds
                    if lock not in held:
                        findings.append(
                            Finding(
                                src.rel,
                                node.lineno,
                                "RA301",
                                f"{cls.name}.{node.attr} is guarded-by self.{lock} "
                                f"but `{method.name}` accesses it without holding "
                                "the lock",
                            )
                        )
    return findings
