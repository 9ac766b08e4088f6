"""Module parsing + the device-reachability call graph (counterpart of
``sagecal_tpu/analysis/callgraph.py``).

Everything downstream (the JL rules) keys off two questions this module
answers mechanically:

1. *What does this dotted name mean here?*  Per-module import tables
   map local aliases to fully qualified names (``dist`` ->
   ``torch.distributed``, ``instrumented`` ->
   ``sagecal_tpu_torch.obs.perf.instrumented``), so rules match on
   canonical names, never on spelling.
2. *Can this statement run on the solve path, where a host read waits
   on the card?*  The port has no ``jax.jit``; its roots are the
   device-reachable entries: every ``instrumented(f, name=...)`` wrap
   site (the port's ``instrumented_jit``, ``obs/perf.py``; call form,
   decorator and decorator factory) and the ``forward``/``backward`` of
   every ``torch.autograd.Function`` subclass.  Reachability closes
   over the reference graph: any Name/Attribute in a function body that
   resolves to a known function is an edge, a reference to a class
   reaches all its methods, ``self.x`` in a method reaches the class's
   ``x``, and lexically nested functions of a reachable function are
   reachable.  This over-approximates, which is the right bias for a
   lint gate: reachable code that is *actually* host-only gets a pragma
   or a baselined reason.

Kernel sources (``.cu``/``.cuh``) are read by :mod:`.cuda` and kept in
:attr:`CallGraph.cuda` beside the Python modules.

Stdlib ``ast`` only; no imports are executed.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from sagecal_tpu_torch.analysis import cuda as cuda_mod

# canonical names that make the function they wrap a device root
INSTRUMENTED = frozenset({"sagecal_tpu_torch.obs.perf.instrumented"})
AUTOGRAD_BASES = frozenset({
    "torch.autograd.Function", "torch.autograd.function.Function",
})
AUTOGRAD_METHODS = ("forward", "backward", "setup_context", "jvp", "vjp")

CUDA_SUFFIXES = (".cu", ".cuh")

_PRAGMA_RE = re.compile(
    r"torchlint:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
)


@dataclasses.dataclass
class FuncInfo:
    """One function/method definition (top-level, nested, or class)."""

    qualname: str  # "<module>.<class or outer>.<name>"
    module: str
    name: str
    node: ast.AST
    lineno: int
    parent: Optional[str] = None  # enclosing function qualname
    cls: Optional[str] = None  # qualname of the class it is a method of
    children: List[str] = dataclasses.field(default_factory=list)
    root_kind: str = ""  # "instrumented" / "autograd" for a device root
    returns_tensor: bool = False  # its return annotation names Tensor
    wrap_sites: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)  # (module, lineno) of each root-making site
    refs: Set[str] = dataclasses.field(default_factory=set)  # raw dotted


@dataclasses.dataclass
class ClassInfo:
    qualname: str
    node: ast.ClassDef
    bases: List[str]  # canonical base names
    methods: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ModuleInfo:
    path: str  # as discovered (relative to cwd when possible)
    name: str  # dotted module name
    tree: Optional[ast.Module]
    lines: List[str]
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    toplevel: Set[str] = dataclasses.field(default_factory=set)
    functions: Dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    func_by_node: Dict[int, FuncInfo] = dataclasses.field(
        default_factory=dict)  # id(node) -> FuncInfo
    pragmas: Dict[int, Set[str]] = dataclasses.field(default_factory=dict)
    file_pragmas: Set[str] = dataclasses.field(default_factory=set)
    parse_error: Optional[str] = None
    graph: Optional["CallGraph"] = None

    def enclosing_function(self, node: ast.AST) -> Optional[FuncInfo]:
        """Innermost function containing ``node`` (via parent links)."""
        cur = getattr(node, "_torchlint_parent", None)
        while cur is not None:
            fi = self.func_by_node.get(id(cur))
            if fi is not None:
                return fi
            cur = getattr(cur, "_torchlint_parent", None)
        return None


def qual_of(node: ast.AST, imports: Dict[str, str],
            toplevel: Optional[Set[str]] = None,
            module: str = "") -> Optional[str]:
    """Canonical dotted name of a Name/Attribute chain, alias-expanded.

    ``dist.all_reduce`` -> ``torch.distributed.all_reduce``; a
    module-local top-level name gets the module prefix so it matches the
    function table."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    head = node.id
    if head in imports:
        base = imports[head]
    elif toplevel is not None and head in toplevel and module:
        base = f"{module}.{head}"
    else:
        base = head
    parts.append(base)
    return ".".join(reversed(parts))


def _module_name_for(path: str) -> str:
    """Dotted module name by climbing the package (__init__.py) chain."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    stem = os.path.splitext(os.path.basename(path))[0]
    parts = [] if stem == "__init__" else [stem]
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.insert(0, os.path.basename(d))
        d = os.path.dirname(d)
    return ".".join(parts) if parts else stem


def scan_pragmas(lines: Sequence[str]) -> Tuple[Dict[int, Set[str]],
                                                Set[str]]:
    per_line: Dict[int, Set[str]] = {}
    per_file: Set[str] = set()
    for i, line in enumerate(lines, start=1):
        if "torchlint" not in line:
            continue
        for m in _PRAGMA_RE.finditer(line):
            rules = {r.strip().upper()
                     for r in m.group("rules").split(",") if r.strip()}
            if m.group("file"):
                per_file |= rules
            else:
                per_line.setdefault(i, set()).update(rules)
    return per_line, per_file


def _collect_imports(tree: ast.Module, modname: str,
                     is_pkg_init: bool) -> Dict[str, str]:
    imports: Dict[str, str] = {}
    # the package a relative import is relative to
    pkg_parts = modname.split(".") if is_pkg_init else modname.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    imports[a.asname] = a.name
                else:
                    # "import torch.distributed" binds "torch"
                    imports.setdefault(a.name.split(".")[0],
                                       a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            if node.level:
                base_parts = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                base = ".".join(base_parts + (
                    node.module.split(".") if node.module else []))
            else:
                base = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                imports[a.asname or a.name] = (
                    f"{base}.{a.name}" if base else a.name)
    return imports


def _names_tensor(annotation: Optional[ast.AST]) -> bool:
    """Whether a type annotation names ``Tensor``."""
    return annotation is not None and "Tensor" in ast.unparse(annotation)


def _link_parents(tree: ast.Module) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._torchlint_parent = node


class CallGraph:
    """All analyzed modules and kernel sources + the reachability
    closure."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}  # dotted name -> info
        self.modules_by_path: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.cuda: Dict[str, "cuda_mod.CudaSource"] = {}  # path -> source
        self.reachable: Set[str] = set()
        # pending instrumented wrap call sites: (modname, scope, expr, line)
        self._wrap_calls: List[tuple] = []

    # ------------------------------------------------------------ build
    def add_cuda(self, path: str) -> "cuda_mod.CudaSource":
        src = cuda_mod.parse_cuda(path)
        src.pragmas, src.file_pragmas = scan_pragmas(src.lines)
        self.cuda[path] = src
        return src

    def add_file(self, path: str) -> ModuleInfo:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        lines = source.splitlines()
        name = _module_name_for(path)
        per_line, per_file = scan_pragmas(lines)
        mi = ModuleInfo(path=path, name=name, tree=None, lines=lines,
                        pragmas=per_line, file_pragmas=per_file)
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            mi.parse_error = f"{type(e).__name__}: {e.msg} (line {e.lineno})"
            self._register(mi)
            return mi
        mi.tree = tree
        _link_parents(tree)
        is_pkg_init = os.path.basename(path) == "__init__.py"
        mi.imports = _collect_imports(tree, name, is_pkg_init)
        mi.toplevel = {
            n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
        } | {
            t.id for n in tree.body if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Name)
        }
        self._collect_functions(mi)
        self._collect_wraps_and_refs(mi)
        self._register(mi)
        return mi

    def _register(self, mi: ModuleInfo) -> None:
        mi.graph = self
        self.modules[mi.name] = mi
        self.modules_by_path[mi.path] = mi
        self.functions.update(mi.functions)
        self.classes.update(mi.classes)

    def _collect_functions(self, mi: ModuleInfo) -> None:
        def visit(node: ast.AST, prefix: str, parent_fn: Optional[str],
                  cls: Optional[ClassInfo]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = f"{prefix}.{child.name}"
                    fi = FuncInfo(qualname=q, module=mi.name,
                                  name=child.name, node=child,
                                  lineno=child.lineno, parent=parent_fn,
                                  cls=cls.qualname if cls else None,
                                  returns_tensor=_names_tensor(
                                      child.returns))
                    mi.functions[q] = fi
                    mi.func_by_node[id(child)] = fi
                    if parent_fn is not None:
                        mi.functions[parent_fn].children.append(q)
                    if cls is not None:
                        cls.methods.append(q)
                        if (child.name in AUTOGRAD_METHODS
                                and AUTOGRAD_BASES & set(cls.bases)):
                            fi.root_kind = "autograd"
                            fi.wrap_sites.append((mi.name, cls.node.lineno))
                    self._check_decorators(mi, fi, child)
                    visit(child, q, q, None)
                elif isinstance(child, ast.ClassDef):
                    q = f"{prefix}.{child.name}"
                    bases = [qual_of(b, mi.imports, mi.toplevel, mi.name)
                             or "" for b in child.bases]
                    ci = ClassInfo(q, child, bases)
                    mi.classes[q] = ci
                    visit(child, q, parent_fn, ci)
                else:
                    visit(child, prefix, parent_fn, cls)

        visit(mi.tree, mi.name, None, None)

    def _check_decorators(self, mi: ModuleInfo, fi: FuncInfo, node) -> None:
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if qual_of(target, mi.imports, mi.toplevel,
                       mi.name) in INSTRUMENTED:
                fi.root_kind = fi.root_kind or "instrumented"
                fi.wrap_sites.append((mi.name, dec.lineno))

    def _collect_wraps_and_refs(self, mi: ModuleInfo) -> None:
        for node in ast.walk(mi.tree):
            scope_fi = mi.enclosing_function(node)
            scope = scope_fi.qualname if scope_fi is not None else ""
            if isinstance(node, ast.Call) and node.args and qual_of(
                    node.func, mi.imports, mi.toplevel,
                    mi.name) in INSTRUMENTED:
                self._wrap_calls.append(
                    (mi.name, scope, node.args[0], node.lineno))
            if scope_fi is None or not isinstance(
                    getattr(node, "ctx", None), ast.Load):
                continue
            if isinstance(node, ast.Attribute) and isinstance(
                    node.value, ast.Name) and node.value.id == "self" \
                    and scope_fi.cls is not None:
                scope_fi.refs.add(f"{scope_fi.cls}.{node.attr}")
            elif isinstance(node, (ast.Name, ast.Attribute)):
                q = qual_of(node, mi.imports, mi.toplevel, mi.name)
                if q:
                    scope_fi.refs.add(q)

    # ---------------------------------------------------------- resolve
    def _lookup_qual(self, q: str, modname: str, scope: str,
                     table: dict):
        if q in table:
            return table[q]
        # scope-local nested name, walking the enclosing chain out
        s = scope
        while s:
            cand = f"{s}.{q}"
            if cand in table:
                return table[cand]
            parent = self.functions.get(s)
            s = parent.parent if parent is not None and parent.parent else ""
        return table.get(f"{modname}.{q}")

    def _lookup(self, q: str, modname: str, scope: str) -> Optional[FuncInfo]:
        return self._lookup_qual(q, modname, scope, self.functions)

    def finalize(self) -> None:
        """Resolve wrap call-sites, then close reachability."""
        for modname, scope, expr, lineno in self._wrap_calls:
            mi = self.modules[modname]
            q = qual_of(expr, mi.imports, mi.toplevel, mi.name)
            fi = self._lookup(q, modname, scope) if q else None
            if fi is None:
                continue
            fi.root_kind = fi.root_kind or "instrumented"
            fi.wrap_sites.append((modname, lineno))
        # BFS over reference edges + lexical nesting + class methods
        queue = [q for q, fi in self.functions.items() if fi.root_kind]
        seen: Set[str] = set()
        while queue:
            q = queue.pop()
            if q in seen:
                continue
            seen.add(q)
            fi = self.functions[q]
            queue.extend(c for c in fi.children if c not in seen)
            for ref in fi.refs:
                target = self._lookup(ref, fi.module, fi.qualname)
                if target is not None:
                    if target.qualname not in seen:
                        queue.append(target.qualname)
                    continue
                ci = self._lookup_qual(ref, fi.module, fi.qualname,
                                       self.classes)
                if ci is not None:
                    queue.extend(m for m in ci.methods if m not in seen)
        self.reachable = seen

    # ------------------------------------------------------------ query
    def callee(self, mi: ModuleInfo, call: ast.Call) -> Optional[FuncInfo]:
        """The package function a call resolves to, if any."""
        q = qual_of(call.func, mi.imports, mi.toplevel, mi.name)
        if q is None:
            return None
        fi = mi.enclosing_function(call)
        return self._lookup(q, mi.name, fi.qualname if fi else "")

    def roots(self, kind: Optional[str] = None) -> List[FuncInfo]:
        """The device roots (of one ``kind`` when given)."""
        return [fi for fi in self.functions.values() if fi.root_kind
                and (kind is None or fi.root_kind == kind)]

    def stmt_reachable(self, mi: ModuleInfo, node: ast.AST) -> \
            Optional[FuncInfo]:
        """The innermost *device-reachable* function containing ``node``
        (itself or any lexical ancestor), or None."""
        fi = mi.enclosing_function(node)
        while fi is not None:
            if fi.qualname in self.reachable:
                return fi
            fi = self.functions.get(fi.parent) if fi.parent else None
        return None


def collect_files(paths: Sequence[str]) -> List[str]:
    """Expand files/directories into a sorted list of ``.py`` files and
    ``.cu``/``.cuh`` kernel sources."""
    out: List[str] = []
    suffixes = (".py",) + CUDA_SUFFIXES
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if not d.startswith(".") and d not in (
                        "__pycache__", "_build"))
                for f in sorted(files):
                    if f.endswith(suffixes):
                        out.append(os.path.join(root, f))
        elif p.endswith(suffixes):
            out.append(p)
    return out


def build_callgraph(files: Sequence[str]) -> CallGraph:
    g = CallGraph()
    for f in files:
        if f.endswith(CUDA_SUFFIXES):
            g.add_cuda(f)
        else:
            g.add_file(f)
    g.finalize()
    return g
