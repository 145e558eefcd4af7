"""Interprocedural index: imports, device regions, call graph, value kinds.

The index is deliberately syntactic — it resolves names through ``import``
aliases, module-level defs, same-class methods, and nested defs, which is
enough to follow this package's dispatch structure without a type checker.

Torch has no ``jit``, so a *device region* (the counterpart of a jitted
function) is found in four ways:

  (a) a def marked ``# repro: device-region`` on its def line (another
      line of its signature, or a comment line just above it), optionally
      with ``static[a, b]``: the
      parameters that hold Python values (the counterpart of
      ``static_argnames`` and of arguments bound by ``functools.partial``);
  (b) ``forward`` / ``backward`` of a ``torch.autograd.Function`` subclass;
  (c) ``forward`` of an ``nn.Module`` subclass;
  (d) a callable called under ``with torch.cuda.graph(...)`` or passed to
      ``torch.cuda.make_graphed_callables``.

Every function reachable from a region through the call graph is device
code, except the bodies of ``functools.lru_cache`` factories (the port's
compile caches: they run once per key, on the host, to build what the
region then calls) and the upload/fetch primitives, whose call sites the
checkers flag instead.

Each expression in device code has a *kind*: a Python value (``HOST``), a
host-resident array or tensor (``CPU``: numpy, or torch built without a
device), an object of unknown content (``OBJ``), or a value that may live
on the device (``TENSOR``). Parameters take their kind from the marker's
static list, their annotation, or — off a region's own signature — the
join of what every device call site passes; a region's other parameters
are device values, as a jitted function's traced arguments are. Kinds are
a fixed point over the device call graph.
"""
from __future__ import annotations

import ast
import builtins
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import DEVICE_RE, SourceModule

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)

HOST, CPU, OBJ, TENSOR = 0, 1, 2, 3  # ordered: a join is the max

# calls whose sites the checkers flag; the index does not descend into them
SYNC_FUNCS = {"fetch"}
UPLOAD_FUNCS = {"to_device"}

_CACHE_DECORATORS = {"functools.lru_cache", "lru_cache", "functools.cache", "cache"}
_HOST_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_cpu", "layout",
               "requires_grad", "is_leaf", "is_meta", "itemsize", "nbytes", "type"}
_HOST_RESULT_METHODS = {
    "size", "dim", "numel", "nelement", "ndimension", "element_size", "stride",
    "is_contiguous", "data_ptr", "get_device", "is_floating_point", "is_complex",
    "storage_offset", "is_pinned", "item", "tolist",
}
_TENSOR_METHODS = {
    "abs", "add", "all", "amax", "amin", "any", "argmax", "argmin", "argsort", "bmm",
    "clamp", "clamp_min", "clamp_max", "clone", "contiguous", "cumsum", "detach", "div",
    "double", "exp", "expand", "expand_as", "flatten", "flip", "float", "gather", "half",
    "bfloat16", "index_select", "int", "long", "bool", "log", "masked_fill", "matmul",
    "max", "mean", "min", "mul", "neg", "new_zeros", "new_ones", "new_full", "new_empty",
    "new_tensor", "norm", "permute", "pow", "prod", "reshape", "reshape_as", "roll",
    "rsqrt", "scatter", "select", "sigmoid", "sign", "softmax", "sort", "split", "sqrt",
    "square", "squeeze", "std", "sub", "sum", "t", "tanh", "topk", "transpose", "tril",
    "triu", "type_as", "unbind", "unflatten", "unsqueeze", "var", "view", "view_as",
    "where", "narrow", "chunk", "repeat", "repeat_interleave", "nonzero", "masked_select",
    "unique", "bincount",
}
_TORCH_HOST_FUNCS = {
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.is_grad_enabled", "torch.is_inference_mode_enabled", "torch.device",
    "torch.finfo", "torch.iinfo", "torch.get_default_dtype", "torch.Size",
    "torch.no_grad", "torch.enable_grad", "torch.inference_mode", "torch.Generator",
    "torch.cuda.is_available", "torch.cuda.device_count", "torch.cuda.current_device",
    "torch.cuda.device", "torch.cuda.get_device_capability", "torch.cuda.get_device_name",
    "torch.cuda.current_stream", "torch.cuda.Stream", "torch.cuda.Event",
    "torch.cuda.stream", "torch.cuda.nvtx.range", "torch.autocast",
}
_TORCH_CREATE = {"tensor", "as_tensor", "from_numpy", "zeros", "ones", "empty", "full",
                 "arange", "linspace", "eye", "rand", "randn", "randint", "randperm",
                 "asarray"}
_BUILTIN_HOST = {"int", "float", "bool", "complex", "len", "str", "repr", "isinstance",
                 "issubclass", "hasattr", "callable", "id", "hash", "type", "range",
                 "print", "format", "ord", "chr", "divmod", "object", "super"}
_BUILTIN_JOIN = {"min", "max", "sum", "abs", "round", "sorted", "list", "tuple", "set",
                 "frozenset", "any", "all", "reversed", "iter", "next", "dict", "getattr",
                 "enumerate", "zip", "map", "filter"}
_HOST_MODULES = {"math", "time", "itertools", "functools", "operator", "os", "sys",
                 "contextlib", "dataclasses", "typing", "collections", "threading",
                 "ctypes", "statistics", "json", "re", "warnings"}
_HOST_TYPES = {
    "int", "float", "bool", "str", "bytes", "complex", "tuple", "Tuple", "list", "List",
    "Sequence", "dict", "Dict", "Mapping", "set", "Set", "FrozenSet", "frozenset",
    "Optional", "Union", "None", "dtype", "device", "DeviceLike", "Callable", "Any",
    "Iterable", "Literal",
}
_DTYPE_NAMES = {"float32", "float16", "bfloat16", "float64", "int64", "int32", "int16",
                "int8", "uint8", "bool", "long", "half", "double", "float", "int",
                "complex64", "float8_e4m3fn", "float8_e5m2", "dtype"}


def dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` text for Name/Attribute chains, None for anything else."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


@dataclass
class FuncInfo:
    module: "ModuleIndex"
    node: ast.AST  # FunctionDef / AsyncFunctionDef / Lambda
    qualname: str
    cls: Optional[str] = None

    @property
    def params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]

    def param_nodes(self) -> List[ast.arg]:
        a = self.node.args
        return a.posonlyargs + a.args + a.kwonlyargs

    def default_of(self, name: str) -> Optional[ast.AST]:
        a = self.node.args
        pos = a.posonlyargs + a.args
        for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
            if p.arg == name:
                return d
        for p, d in zip(a.kwonlyargs, a.kw_defaults):
            if p.arg == name:
                return d
        return None


@dataclass
class DeviceRoot:
    func: FuncInfo
    statics: Set[str] = field(default_factory=set)
    kind: str = "marked"  # marked | autograd | module | graph


class ModuleIndex:
    def __init__(self, src: SourceModule):
        self.src = src
        self.import_mods: Dict[str, str] = {}  # alias -> dotted module
        self.import_syms: Dict[str, Tuple[str, str]] = {}  # name -> (module, symbol)
        self.defs: Dict[str, List[FuncInfo]] = {}
        self.methods: Dict[Tuple[str, str], FuncInfo] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self.globals: Dict[str, ast.AST] = {}  # module-level name -> assigned value
        self._scan()

    def _scan(self) -> None:
        for node in ast.walk(self.src.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.import_mods[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for alias in node.names:
                    self.import_syms[alias.asname or alias.name] = (node.module, alias.name)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
        for stmt in self.src.tree.body:
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        self.globals[tgt.id] = stmt.value
            elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
                self.globals[stmt.target.id] = stmt.value
        for node in ast.walk(self.src.tree):
            if isinstance(node, FuncNode):
                cls = self._owning_class(node)
                qual = f"{cls}.{node.name}" if cls else node.name
                info = FuncInfo(self, node, qual, cls)
                self.defs.setdefault(node.name, []).append(info)
                if cls:
                    self.methods[(cls, node.name)] = info

    def _owning_class(self, node: ast.AST) -> Optional[str]:
        cur = self.src.parent.get(node)
        if isinstance(cur, ast.ClassDef):
            return cur.name
        return None

    def canonical(self, text: Optional[str]) -> Optional[str]:
        """``text`` with its first name replaced by the module or symbol it
        was imported as (``np.asarray`` -> ``numpy.asarray``)."""
        if not text:
            return text
        head, _, rest = text.partition(".")
        if head in self.import_mods:
            head = self.import_mods[head]
        elif head in self.import_syms:
            mod, sym = self.import_syms[head]
            head = f"{mod}.{sym}"
        return f"{head}.{rest}" if rest else head

    def resolve_local(self, name: str, at: ast.AST) -> Optional[FuncInfo]:
        """Resolve ``name`` to a def visible from ``at``: nested defs of the
        enclosing function chain first, then module level."""
        candidates = self.defs.get(name)
        if not candidates:
            return None
        enclosing = set(self.src.enclosing(at, FuncNode))
        for info in candidates:
            if self.src.parent.get(info.node) in enclosing:
                return info
        for info in candidates:
            if info.cls is None and isinstance(self.src.parent.get(info.node), ast.Module):
                return info
        return None


def is_cache_factory(node: ast.AST) -> bool:
    """A def decorated with ``functools.lru_cache`` (or ``cache``)."""
    for deco in getattr(node, "decorator_list", ()):
        target = deco.func if isinstance(deco, ast.Call) else deco
        if dotted(target) in _CACHE_DECORATORS:
            return True
    return False


def _base_names(cls: ast.ClassDef) -> List[str]:
    return [dotted(b) or "" for b in cls.bases]


class ProjectIndex:
    def __init__(self, modules: Sequence[SourceModule]):
        self.modules: List[ModuleIndex] = [ModuleIndex(m) for m in modules]
        self.by_name: Dict[str, ModuleIndex] = {
            m.src.modname: m for m in self.modules if m.src.modname
        }
        self.roots: List[DeviceRoot] = []
        for m in self.modules:
            self._find_roots(m)
        self.root_of: Dict[int, DeviceRoot] = {}
        for r in self.roots:
            prev = self.root_of.get(id(r.func.node))
            if prev is not None:
                prev.statics |= r.statics
            else:
                self.root_of[id(r.func.node)] = r
        self.device_funcs: Dict[int, FuncInfo] = {}
        self._propagate()
        self._infer_kinds()

    # -- name resolution ---------------------------------------------------
    def resolve_call(self, mod: ModuleIndex, call: ast.Call) -> Optional[FuncInfo]:
        return self.resolve_callee(mod, call.func, call)

    def resolve_callee(self, mod: ModuleIndex, fn: ast.AST, at: ast.AST) -> Optional[FuncInfo]:
        if isinstance(fn, ast.Name):
            info = mod.resolve_local(fn.id, at)
            if info is not None:
                return info
            imp = mod.import_syms.get(fn.id)
            if imp and imp[0] in self.by_name:
                other = self.by_name[imp[0]]
                for cand in other.defs.get(imp[1], []):
                    if cand.cls is None:
                        return cand
            return None
        if isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name):
                if fn.value.id == "self":
                    cls = self._enclosing_class(mod, at)
                    if cls:
                        return mod.methods.get((cls, fn.attr))
                    return None
                target = mod.import_mods.get(fn.value.id)
                if target is None and fn.value.id in mod.import_syms:
                    # `from repro_torch.models import transformer as T` — a
                    # module imported as a symbol.
                    pkg, sym = mod.import_syms[fn.value.id]
                    target = f"{pkg}.{sym}"
                if target in self.by_name:
                    other = self.by_name[target]
                    for cand in other.defs.get(fn.attr, []):
                        if cand.cls is None:
                            return cand
        return None

    def _enclosing_class(self, mod: ModuleIndex, node: ast.AST) -> Optional[str]:
        for anc in mod.src.enclosing(node, (ast.ClassDef,)):
            return anc.name
        return None

    # -- device-region discovery -------------------------------------------
    def _marker(self, mod: ModuleIndex, node: ast.AST) -> Optional[Set[str]]:
        """The static names of a ``# repro: device-region`` marker on the
        def's signature lines, or None without one."""
        last = node.body[0].lineno - 1 if node.body else node.lineno
        top = min([node.lineno] + [d.lineno for d in node.decorator_list])
        above = [top - 1] if mod.src.lines[top - 2:top - 1] and \
            mod.src.lines[top - 2].strip().startswith("#") else []
        for ln in above + list(range(node.lineno, max(last, node.lineno) + 1)):
            m = DEVICE_RE.search(mod.src.comments.get(ln, ""))
            if m:
                return {s.strip() for s in (m.group(1) or "").split(",") if s.strip()}
        return None

    def _info(self, mod: ModuleIndex, node: ast.AST) -> FuncInfo:
        cls = mod._owning_class(node)
        return FuncInfo(mod, node, f"{cls}.{node.name}" if cls else node.name, cls)

    def _find_roots(self, mod: ModuleIndex) -> None:
        for node in ast.walk(mod.src.tree):
            if isinstance(node, FuncNode):
                statics = self._marker(mod, node)
                if statics is not None:
                    self.roots.append(DeviceRoot(self._info(mod, node), statics, "marked"))
            elif isinstance(node, ast.ClassDef):
                bases = _base_names(node)
                names = ()
                kind = ""
                if any(b.endswith("autograd.Function") or b == "Function" for b in bases):
                    names, kind = ("forward", "backward"), "autograd"
                elif any(b.endswith("nn.Module") or b == "Module" for b in bases):
                    names, kind = ("forward",), "module"
                for stmt in node.body:
                    if isinstance(stmt, FuncNode) and stmt.name in names:
                        self.roots.append(DeviceRoot(self._info(mod, stmt), set(), kind))
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                if any(self._is_graph(mod, it.context_expr) for it in node.items):
                    for stmt in node.body:
                        for sub in ast.walk(stmt):
                            if isinstance(sub, ast.Call):
                                fi = self.resolve_call(mod, sub)
                                if fi is not None:
                                    self.roots.append(DeviceRoot(fi, set(), "graph"))
            elif isinstance(node, ast.Call):
                if (mod.canonical(dotted(node.func)) or "").endswith(
                        "cuda.make_graphed_callables") and node.args:
                    first = node.args[0]
                    elts = first.elts if isinstance(first, (ast.Tuple, ast.List)) else [first]
                    for e in elts:
                        fi = self.resolve_callee(mod, e, node)
                        if fi is not None:
                            self.roots.append(DeviceRoot(fi, set(), "graph"))

    @staticmethod
    def _is_graph(mod: ModuleIndex, expr: ast.AST) -> bool:
        if not isinstance(expr, ast.Call):
            return False
        return (mod.canonical(dotted(expr.func)) or "") in ("torch.cuda.graph", "cuda.graph")

    # -- reachability ------------------------------------------------------
    def body_nodes(self, fi: FuncInfo):
        """Every node of ``fi``'s body, skipping nested defs that are device
        regions of their own (they are checked under their own kinds)."""
        body = fi.node.body if isinstance(fi.node.body, list) else [fi.node.body]
        stack = list(reversed(body))
        while stack:
            node = stack.pop()
            yield node
            for child in reversed(list(ast.iter_child_nodes(node))):
                if isinstance(child, FuncNode) and id(child) in self.root_of:
                    continue
                stack.append(child)

    def _propagate(self) -> None:
        self.sites: List[Tuple[FuncInfo, ast.Call, FuncInfo]] = []
        queue: List[FuncInfo] = [r.func for r in self.roots]
        while queue:
            fi = queue.pop()
            if id(fi.node) in self.device_funcs:
                continue
            self.device_funcs[id(fi.node)] = fi
            for sub in self.body_nodes(fi):
                if isinstance(sub, ast.Call):
                    callee = self.resolve_call(fi.module, sub)
                    if callee is None or not self._descends(callee):
                        continue
                    self.sites.append((fi, sub, callee))
                    if id(callee.node) not in self.device_funcs:
                        queue.append(callee)

    @staticmethod
    def _descends(fi: FuncInfo) -> bool:
        name = getattr(fi.node, "name", "")
        return not (is_cache_factory(fi.node) or name in SYNC_FUNCS or name in UPLOAD_FUNCS)

    def is_device_func(self, node: ast.AST) -> bool:
        return id(node) in self.device_funcs

    # -- value kinds -------------------------------------------------------
    def _annotation_kind(self, ann: Optional[ast.AST]) -> Optional[int]:
        if ann is None:
            return None
        text = ast.unparse(ann)
        if "Tensor" in text:
            return TENSOR
        if "ndarray" in text:
            return CPU
        names = {n.split(".")[-1] for n in
                 (dotted(x) for x in ast.walk(ann) if isinstance(x, (ast.Name, ast.Attribute)))
                 if n}
        names |= {x.value for x in ast.walk(ann)
                  if isinstance(x, ast.Constant) and isinstance(x.value, str)}
        if names and names <= _HOST_TYPES | {"torch", "np", "numpy", "typing"}:
            return HOST
        return OBJ

    def _infer_kinds(self) -> None:
        """Parameter, local and return kinds of every device function, as
        a fixed point over the device call sites."""
        self.fixed: Dict[int, Dict[str, int]] = {}  # from markers / annotations / roles
        self.site_kinds: Dict[int, Dict[str, int]] = {}
        self.locals: Dict[int, Dict[str, int]] = {}
        self.listy: Dict[int, Set[str]] = {}
        self.boolish: Dict[int, Set[str]] = {}
        self.ret: Dict[int, int] = {}
        for key, fi in self.device_funcs.items():
            root = self.root_of.get(key)
            fixed: Dict[str, int] = {}
            for i, p in enumerate(fi.param_nodes()):
                if i == 0 and p.arg in ("self", "cls", "ctx") and fi.cls is not None:
                    fixed[p.arg] = OBJ
                    continue
                if root is not None and p.arg in root.statics:
                    fixed[p.arg] = HOST
                    continue
                ak = self._annotation_kind(p.annotation)
                if ak is not None:
                    fixed[p.arg] = ak
                elif root is not None:
                    fixed[p.arg] = TENSOR  # a region's argument: a device value
            a = fi.node.args
            for star in (a.vararg, a.kwarg):
                if star is not None:
                    fixed[star.arg] = TENSOR if root is not None else OBJ
            self.fixed[key] = fixed
            self.site_kinds[key] = {}
            self.locals[key] = {}
            self.ret[key] = HOST
            self.listy[key], self.boolish[key] = self._shapes_of_locals(fi)
        for _ in range(50):
            before = (repr(self.site_kinds), repr(self.locals), repr(self.ret))
            for key, fi in self.device_funcs.items():
                self._bind_locals(fi)
            for caller, call, callee in self.sites:
                self._bind_site(caller, call, callee)
            if (repr(self.site_kinds), repr(self.locals), repr(self.ret)) == before:
                break

    def _shapes_of_locals(self, fi: FuncInfo) -> Tuple[Set[str], Set[str]]:
        """Names every assignment of which is a Python list literal /
        comprehension (``listy``), or a boolean tensor expression."""
        assigned: Dict[str, List[ast.AST]] = {}
        for node in self.body_nodes(fi):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        assigned.setdefault(t.id, []).append(node.value)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and isinstance(
                    node.target, ast.Name):
                assigned.setdefault(node.target.id, []).append(node.value)
            elif isinstance(node, (ast.For, ast.comprehension)):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        assigned.setdefault(n.id, []).append(None)
        listy = {n for n, vs in assigned.items()
                 if all(isinstance(v, (ast.List, ast.ListComp)) for v in vs)}
        boolish = {n for n, vs in assigned.items() if all(_boolish_syntax(v) for v in vs)}
        return listy, boolish

    def param_kind(self, fi: FuncInfo, name: str) -> Optional[int]:
        key = id(fi.node)
        fixed = self.fixed.get(key, {})
        if name in fixed:
            return fixed[name]
        if name in fi.params:
            return self.site_kinds.get(key, {}).get(name, OBJ)
        return None

    def _raise(self, table: Dict[str, int], name: str, kind: int) -> None:
        if kind > table.get(name, -1):
            table[name] = kind

    def _bind_site(self, caller: FuncInfo, call: ast.Call, callee: FuncInfo) -> None:
        key = id(callee.node)
        table = self.site_kinds[key]
        fixed = self.fixed[key]
        a = callee.node.args
        pos = [p.arg for p in a.posonlyargs + a.args]
        if callee.cls is not None and isinstance(call.func, ast.Attribute) and pos:
            pos = pos[1:]  # self.method(...): the receiver binds `self`
        bound: Set[str] = set()
        starred = False
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                starred = True
                break
            if i < len(pos):
                bound.add(pos[i])
                self._raise(table, pos[i], self.kind(caller, arg))
        for kw in call.keywords:
            if kw.arg is None:
                starred = True
            elif kw.arg in callee.params:
                bound.add(kw.arg)
                self._raise(table, kw.arg, self.kind(caller, kw.value))
        for p in callee.params:
            if p in bound or p in fixed:
                continue
            d = callee.default_of(p)
            if starred or d is None:
                self._raise(table, p, OBJ)
            else:
                self._raise(table, p, self.kind(callee, d))

    def _bind_locals(self, fi: FuncInfo) -> None:
        key = id(fi.node)
        table = self.locals[key]
        params = set(fi.params)

        def bind(target: ast.AST, kind: int, value: Optional[ast.AST] = None) -> None:
            if isinstance(target, ast.Name):
                if target.id not in params:
                    self._raise(table, target.id, kind)
            elif isinstance(target, (ast.Tuple, ast.List)):
                if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(target.elts):
                    for t, v in zip(target.elts, value.elts):
                        bind(t, self.kind(fi, v), v)
                else:
                    for t in target.elts:
                        bind(t, kind)
            elif isinstance(target, ast.Starred):
                bind(target.value, kind)
            elif isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name):
                bind(target.value, kind)  # a container holds what is stored in it

        def bind_iter(target: ast.AST, it: ast.AST) -> None:
            if isinstance(it, ast.Call) and isinstance(it.func, ast.Name):
                name = it.func.id
                if name == "range":
                    bind(target, HOST)
                    return
                if name == "enumerate" and isinstance(target, ast.Tuple) and it.args:
                    bind(target.elts[0], HOST)
                    for t in target.elts[1:]:
                        bind_iter(t, it.args[0])
                    return
                if name == "zip" and isinstance(target, ast.Tuple) and len(
                        target.elts) == len(it.args):
                    for t, a in zip(target.elts, it.args):
                        bind_iter(t, a)
                    return
            if isinstance(it, (ast.Tuple, ast.List)) and isinstance(target, ast.Tuple) and all(
                    isinstance(e, ast.Tuple) and len(e.elts) == len(target.elts) for e in it.elts):
                # for name, t in (("q", q), ("k", k)): one kind per position
                for j, t in enumerate(target.elts):
                    bind(t, max((self.kind(fi, e.elts[j]) for e in it.elts), default=HOST))
                return
            bind(target, self.kind(fi, it))

        for node in self.body_nodes(fi):
            if isinstance(node, ast.Assign):
                k = self.kind(fi, node.value)
                for t in node.targets:
                    bind(t, k, node.value)
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("append", "extend", "insert", "add") and \
                    isinstance(node.func.value, ast.Name) and node.args:
                bind(node.func.value, self.kind(fi, node.args[-1]))
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                bind(node.target, self.kind(fi, node.value), node.value)
            elif isinstance(node, ast.AugAssign):
                bind(node.target, self.kind(fi, node.value))
            elif isinstance(node, ast.NamedExpr):
                bind(node.target, self.kind(fi, node.value))
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
                bind_iter(node.target, node.iter)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for it in node.items:
                    if it.optional_vars is not None:
                        bind(it.optional_vars, OBJ)
            elif isinstance(node, ast.ExceptHandler) and node.name:
                table.setdefault(node.name, HOST)
            elif isinstance(node, ast.Return) and node.value is not None:
                k = self.kind(fi, node.value)
                if k > self.ret[key]:
                    self.ret[key] = k

    def global_kind(self, mod: ModuleIndex, name: str, _seen=None) -> Optional[int]:
        if name in mod.import_mods or name in mod.import_syms or name in mod.defs \
                or name in mod.classes:
            return HOST
        if name in mod.globals:
            seen = _seen or set()
            if name in seen:
                return OBJ
            seen.add(name)
            return self._expr_kind(None, mod, mod.globals[name], seen)
        return None

    def kind(self, fi: FuncInfo, expr: ast.AST) -> int:
        """The kind of ``expr`` evaluated in device function ``fi``."""
        return self._expr_kind(fi, fi.module, expr, None)

    def _name_kind(self, fi: Optional[FuncInfo], mod: ModuleIndex, name: str, seen) -> int:
        if fi is not None:
            k = self.param_kind(fi, name)
            if k is not None:
                return k
            loc = self.locals.get(id(fi.node), {})
            if name in loc:
                return loc[name]
            # a name of an enclosing function (closure)
            for outer in fi.module.src.enclosing(fi.node, FuncNode):
                ofi = self.device_funcs.get(id(outer))
                if ofi is not None:
                    k = self.param_kind(ofi, name)
                    if k is None:
                        k = self.locals.get(id(outer), {}).get(name)
                    if k is not None:
                        return k
        g = self.global_kind(mod, name, seen)
        if g is not None:
            return g
        if hasattr(builtins, name):
            return HOST
        return OBJ

    def _expr_kind(self, fi, mod: ModuleIndex, e: ast.AST, seen) -> int:
        k = lambda x: self._expr_kind(fi, mod, x, seen)  # noqa: E731
        if isinstance(e, ast.Constant):
            return HOST
        if isinstance(e, ast.Name):
            return self._name_kind(fi, mod, e.id, seen)
        if isinstance(e, ast.Attribute):
            if e.attr in _HOST_ATTRS:
                return HOST
            return k(e.value)
        if isinstance(e, ast.Subscript):
            return k(e.value)
        if isinstance(e, ast.Call):
            return self._call_kind(fi, mod, e, seen)
        if isinstance(e, ast.BinOp):
            return max(k(e.left), k(e.right))
        if isinstance(e, ast.UnaryOp):
            return k(e.operand)
        if isinstance(e, ast.BoolOp):
            return max(k(v) for v in e.values)
        if isinstance(e, ast.Compare):
            # identity tests, and membership in a dict / pytree of tensors
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops):
                return HOST
            return max([k(e.left)] + [k(c) for c in e.comparators])
        if isinstance(e, ast.IfExp):
            return max(k(e.body), k(e.orelse))
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return max([k(x) for x in e.elts], default=HOST)
        if isinstance(e, ast.Dict):
            return max([k(x) for x in e.values], default=HOST)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return k(e.elt)
        if isinstance(e, ast.DictComp):
            return k(e.value)
        if isinstance(e, (ast.Starred, ast.NamedExpr)):
            return k(e.value)
        if isinstance(e, (ast.Lambda, ast.JoinedStr, ast.FormattedValue, ast.Slice)):
            return HOST
        return OBJ

    def _call_kind(self, fi, mod: ModuleIndex, call: ast.Call, seen) -> int:
        k = lambda x: self._expr_kind(fi, mod, x, seen)  # noqa: E731
        fn = call.func
        text = mod.canonical(dotted(fn)) or ""
        args = [a for a in call.args] + [kw.value for kw in call.keywords]
        if text.startswith("torch."):
            if text in _TORCH_HOST_FUNCS:
                return HOST
            last = text.rsplit(".", 1)[-1]
            if last.endswith("_like") and call.args:
                return k(call.args[0])
            if last in _TORCH_CREATE and text.count(".") == 1:
                dev = next((kw.value for kw in call.keywords if kw.arg == "device"), None)
                if dev is not None:
                    if isinstance(dev, ast.Constant) and dev.value == "cpu":
                        return CPU
                    return TENSOR
                if last in ("tensor", "as_tensor", "asarray") and call.args:
                    return max(CPU, k(call.args[0]))
                return CPU
            kinds = [k(a) for a in args]
            out = max(kinds, default=CPU)
            return TENSOR if out == OBJ else max(out, CPU)
        head = text.split(".", 1)[0]
        if head == "numpy":
            return CPU
        if head in _HOST_MODULES:
            return HOST
        if isinstance(fn, ast.Name) and fn.id not in mod.defs and fn.id not in mod.import_syms \
                and (fi is None or self.param_kind(fi, fn.id) is None) \
                and (fi is None or fn.id not in self.locals.get(id(fi.node), {})):
            if fn.id in _BUILTIN_HOST:
                return HOST
            if fn.id in _BUILTIN_JOIN:
                return max([k(a) for a in args], default=HOST)
            if fn.id in mod.classes:
                return OBJ
        if fi is not None:
            callee = self.resolve_call(mod, call)
            if callee is not None:
                if not self._descends(callee):
                    name = callee.node.name
                    return CPU if name in SYNC_FUNCS else TENSOR if name in UPLOAD_FUNCS else OBJ
                return self.ret.get(id(callee.node), OBJ)
        if isinstance(fn, ast.Attribute):
            recv = k(fn.value)
            m = fn.attr
            if m in _HOST_RESULT_METHODS:
                return HOST
            if recv == HOST:
                return HOST
            if m in ("cpu", "numpy"):
                return CPU
            if m == "to":
                dev = to_device_arg(mod, call)
                if dev is not None:
                    if isinstance(dev, ast.Constant) and dev.value == "cpu":
                        return CPU
                    return TENSOR
                return recv
            if m in ("cuda",):
                return TENSOR
            if m in _TENSOR_METHODS and recv >= OBJ:
                return TENSOR
            return recv
        callee_kind = k(fn)
        return TENSOR if callee_kind == TENSOR else OBJ


def is_dtype_expr(mod: ModuleIndex, node: ast.AST) -> bool:
    """``torch.float32``, ``x.dtype``, a ``dtype`` name, or a module alias
    assigned one of those (``F32 = torch.float32``)."""
    text = dotted(node)
    if text is None:
        return False
    last = text.rsplit(".", 1)[-1]
    if "." in text and (last in _DTYPE_NAMES or last == "dtype"):
        return True
    if "dtype" in last.lower():
        return True
    if isinstance(node, ast.Name) and node.id in mod.globals:
        return is_dtype_expr(mod, mod.globals[node.id])
    return False


def to_device_arg(mod: ModuleIndex, call: ast.Call) -> Optional[ast.AST]:
    """The device a ``.to(...)`` call moves to, or None for a dtype-only
    ``.to``."""
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    if call.args:
        first = call.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return first
        if not is_dtype_expr(mod, first):
            return first
    return None


def _boolish_syntax(v: Optional[ast.AST]) -> bool:
    """A boolean tensor expression by its syntax: a comparison, a negation
    ``~``, a bitwise combination of such, or an ``isfinite``-style test."""
    if v is None:
        return False
    if isinstance(v, ast.Compare):
        return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in v.ops)
    if isinstance(v, ast.UnaryOp) and isinstance(v.op, ast.Invert):
        return True
    if isinstance(v, ast.BinOp) and isinstance(v.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _boolish_syntax(v.left) or _boolish_syntax(v.right)
    if isinstance(v, ast.Call):
        name = (dotted(v.func) or "").rsplit(".", 1)[-1]
        return name in ("isfinite", "isnan", "isinf", "logical_and", "logical_or",
                        "logical_not", "isin", "eq", "ne", "gt", "lt", "ge", "le")
    return False


def _isinstance_tensor(test: ast.AST, name: str) -> Optional[bool]:
    """True for ``isinstance(name, ...Tensor...)``, False for its negation,
    None for any other test."""
    neg = isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
    call = test.operand if neg else test
    if isinstance(call, ast.Call) and dotted(call.func) == "isinstance" and len(call.args) == 2 \
            and isinstance(call.args[0], ast.Name) and call.args[0].id == name \
            and "Tensor" in ast.unparse(call.args[1]):
        return not neg
    return None


def not_a_tensor_here(src: SourceModule, node: ast.AST, name: str) -> bool:
    """``node`` lies in the branch of an ``isinstance(name, torch.Tensor)``
    test (``if`` or conditional expression) where ``name`` is no tensor."""
    cur = node
    parent = src.parent.get(cur)
    while parent is not None and not isinstance(parent, FuncNode):
        if isinstance(parent, (ast.IfExp, ast.If)) and cur is not parent.test:
            pos = _isinstance_tensor(parent.test, name)
            in_body = cur is parent.body or (isinstance(parent.body, list) and cur in parent.body)
            if pos is not None and in_body != pos:
                return True
        cur, parent = parent, src.parent.get(parent)
    return False

