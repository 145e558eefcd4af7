"""RA501/RA502 — int32 clock saturation and timestamp-precision mixing.

RA501: StoreBank's recency ticks and insertion seqs live in int32 device
buffers, so the host-side monotonic counters that feed them must rebase
(compact) before ``iinfo(int32).max``. In any module that participates in
the compaction protocol (references ``_TICK_COMPACT_AT`` / ``compact_``),
a ``+=`` on a tick/seq-named attribute must sit in a function that also
references the compaction guard — an unguarded increment is exactly the
PR-6 overflow bug re-introduced.

RA502: lifecycle truth (created/expires wall-clock stamps) is float64 on
host; the device copies are float32 *relative* offsets. Casting an
absolute epoch timestamp (``time.time()`` or a ``*_at`` value) straight to
float32 silently loses whole seconds of precision (~128s granularity at
today's epoch) and corrupts TTL math. Besides numpy's ``np.float32(x)`` /
``x.astype(np.float32)``, torch's narrowing forms count:
``torch.tensor(x, dtype=torch.float32)`` (and ``as_tensor``),
``torch.full(size, x, dtype=torch.float32)``, ``x.to(torch.float32)`` and
``x.float()``.
"""
from __future__ import annotations

import ast
import re
from typing import List

from repro_torch.analysis import register
from repro_torch.analysis.core import Finding
from repro_torch.analysis.project import ProjectIndex, dotted

_COUNTER_RE = re.compile(r"(^|_)(tick|seq)s?$")
_COMPACT_RE = re.compile(r"compact", re.IGNORECASE)
_ABS_TIME_RE = re.compile(r"time\.time\(\)|monotonic\(\)|_at\b|\bnow_s\b")


def _is_f32(mod, node: ast.AST) -> bool:
    """``torch.float32`` / ``np.float32`` or a module alias of one (``F32``)."""
    text = dotted(node) or ""
    if text.endswith("float32"):
        return True
    return isinstance(node, ast.Name) and node.id in mod.globals and _is_f32(
        mod, mod.globals[node.id])


def _torch_narrowed(mod, node: ast.AST):
    """The operand torch narrows to float32 at ``node``, or None."""
    if not isinstance(node, ast.Call):
        return None
    fn_text = mod.canonical(dotted(node.func)) or ""
    dtype = next((kw.value for kw in node.keywords if kw.arg == "dtype"), None)
    if fn_text in ("torch.tensor", "torch.as_tensor", "torch.asarray") and node.args:
        return node.args[0] if dtype is not None and _is_f32(mod, dtype) else None
    if fn_text == "torch.full" and len(node.args) >= 2:
        return node.args[1] if dtype is not None and _is_f32(mod, dtype) else None
    if isinstance(node.func, ast.Attribute):
        if node.func.attr == "float" and not node.args:
            return node.func.value
        if node.func.attr == "to" and (any(_is_f32(mod, a) for a in node.args) or (
                dtype is not None and _is_f32(mod, dtype))):
            return node.func.value
    return None


def _module_in_compact_protocol(src) -> bool:
    return bool(_COMPACT_RE.search(src.source))


@register("overflow")
def check(project: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        src = mod.src
        if _module_in_compact_protocol(src):
            for node in ast.walk(src.tree):
                if not (
                    isinstance(node, ast.AugAssign)
                    and isinstance(node.op, ast.Add)
                    and isinstance(node.target, ast.Attribute)
                    and _COUNTER_RE.search(node.target.attr)
                ):
                    continue
                funcs = src.enclosing(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                )
                guarded = False
                for fn in funcs[:1]:  # the innermost enclosing function
                    text = ast.unparse(fn)
                    if _COMPACT_RE.search(text):
                        guarded = True
                if not guarded:
                    findings.append(
                        Finding(
                            src.rel,
                            node.lineno,
                            "RA501",
                            f"int32 monotonic counter `{node.target.attr}` is "
                            "incremented without a visible rebase guard — compare "
                            "against _TICK_COMPACT_AT and compact before the int32 "
                            "ceiling (see StoreBank.next_tick)",
                        )
                    )

        # RA502: float32 casts of absolute timestamps.
        for node in ast.walk(src.tree):
            operand = None
            if isinstance(node, ast.Call):
                fn_text = dotted(node.func) or ""
                if fn_text.endswith("float32") and node.args:
                    operand = node.args[0]
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "astype"
                    and node.args
                ):
                    arg_text = ast.unparse(node.args[0])
                    if "float32" in arg_text:
                        operand = node.func.value
            if operand is None:
                operand = _torch_narrowed(mod, node)
            if operand is None:
                continue
            text = ast.unparse(operand)
            if _ABS_TIME_RE.search(text):
                findings.append(
                    Finding(
                        src.rel,
                        node.lineno,
                        "RA502",
                        "absolute timestamp narrowed to float32 — epoch-scale "
                        "values lose ~2 minutes of precision in f32; keep host "
                        "lifecycle stamps f64 and ship f32 *relative* offsets "
                        "(see StoreBank.rel_now/to_rel)",
                    )
                )
    return findings
