"""Framework plumbing: findings, suppressions, baselines, file walking."""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

NOQA_RE = re.compile(r"#\s*repro:\s*noqa\[([A-Z0-9,\s\*]+)\]")
GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
HOLDS_RE = re.compile(r"#\s*repro:\s*holds\[([A-Za-z_]\w*)\]")
# a device region declared on its def line: ``# repro: device-region`` and,
# optionally, ``static[a, b]``: the parameters that hold Python values
DEVICE_RE = re.compile(r"repro:\s*device-region(?:\s+static\[([A-Za-z_0-9,\s]*)\])?")


@dataclass(frozen=True)
class Finding:
    path: str  # repo-relative posix path
    line: int
    code: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    @property
    def baseline_key(self) -> str:
        # Line numbers are deliberately excluded so baselined findings
        # survive unrelated edits above them.
        return f"{self.path}: {self.code} {self.message}"


class SourceModule:
    """One parsed source file plus its comment/suppression side tables."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.tree = ast.parse(source, filename=rel)
        self.lines = source.splitlines()
        self.comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass
        self.noqa: Dict[int, Set[str]] = {}
        for ln, comment in self.comments.items():
            m = NOQA_RE.search(comment)
            if m:
                self.noqa[ln] = {c.strip() for c in m.group(1).split(",") if c.strip()}
        # Parents let checkers walk outward (enclosing statement, with-blocks,
        # loops) without re-deriving scope every time.
        self.parent: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node

    @property
    def modname(self) -> Optional[str]:
        """Dotted module name for files under ``src/`` (``None`` otherwise)."""
        parts = self.rel.split("/")
        if "src" in parts:
            parts = parts[parts.index("src") + 1 :]
        if not parts or not parts[-1].endswith(".py"):
            return None
        parts[-1] = parts[-1][: -len(".py")]
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts) if parts else None

    def suppressed(self, line: int, code: str) -> bool:
        codes = self.noqa.get(line)
        if codes is None:
            # Multi-line statements: honor a noqa on the first line of the
            # enclosing statement too.
            return False
        return code in codes or "*" in codes

    def stmt_of(self, node: ast.AST) -> ast.stmt:
        cur = node
        while not isinstance(cur, ast.stmt):
            cur = self.parent[cur]
        return cur

    def enclosing(self, node: ast.AST, kinds) -> List[ast.AST]:
        """All ancestors of ``node`` (inner-first) matching ``kinds``."""
        out: List[ast.AST] = []
        cur = self.parent.get(node)
        while cur is not None:
            if isinstance(cur, kinds):
                out.append(cur)
            cur = self.parent.get(cur)
        return out


def collect_modules(paths: Sequence[str], root: str) -> List[SourceModule]:
    files: List[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
                files.extend(
                    os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py")
                )
        elif p.endswith(".py"):
            files.append(p)
    root = os.path.abspath(root)
    modules = []
    for f in dict.fromkeys(files):
        rel = os.path.relpath(f, root).replace(os.sep, "/")
        with open(f, "r", encoding="utf-8") as fh:
            modules.append(SourceModule(f, rel, fh.read()))
    return modules


class Baseline:
    """Grandfathered findings, keyed without line numbers."""

    def __init__(self, keys: Set[str]):
        self.keys = keys

    @classmethod
    def load(cls, path: str) -> "Baseline":
        keys: Set[str] = set()
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as fh:
                for raw in fh:
                    line = raw.strip()
                    if line and not line.startswith("#"):
                        keys.add(line)
        return cls(keys)

    def split(self, findings: Sequence[Finding]):
        """Partition into (new, grandfathered) and report stale keys."""
        new = [f for f in findings if f.baseline_key not in self.keys]
        old = [f for f in findings if f.baseline_key in self.keys]
        stale = self.keys - {f.baseline_key for f in findings}
        return new, old, sorted(stale)

    @staticmethod
    def write(path: str, findings: Sequence[Finding]) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("# repro_torch.analysis baseline — grandfathered findings.\n")
            fh.write("# Keys are line-number-free: `path: CODE message`.\n")
            for key in sorted({f.baseline_key for f in findings}):
                fh.write(key + "\n")
