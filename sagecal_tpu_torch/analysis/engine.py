"""Rule engine: run rules over the call graph, apply pragmas, report
(counterpart of ``sagecal_tpu/analysis/engine.py``).

A :class:`Finding` is identified for baseline purposes by ``(rule,
path, symbol, message)``, deliberately *without* the line number, so
unrelated edits above a grandfathered finding don't churn the baseline.
The path in that key is the file's path from the directory holding its
top-level package (``sagecal_tpu_torch/solvers/lm.py``), whatever the
working directory, so the in-package baseline matches from anywhere.

Suppression is per line: a ``# torchlint: disable=RULE`` comment on the
flagged line (``// torchlint: ...`` in a ``.cu`` file; a reason after
an em-dash is expected and ignored by the parser), or ``torchlint:
disable-file=RULE`` anywhere for the whole file.  ``# noqa`` on the
flagged line also suppresses the report-only findings (flake8's
convention for re-export imports).
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import json
import os
import time
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Set, Tuple)

from sagecal_tpu_torch.analysis.callgraph import (
    CallGraph,
    ModuleInfo,
    build_callgraph,
    collect_files,
    qual_of,
)

# attribute reads that are metadata, never a wait on the card
STATIC_ATTRS = frozenset({
    "shape", "dtype", "ndim", "device", "is_cuda", "requires_grad",
    "layout", "names", "grad_fn", "is_leaf",
})
STATIC_METHODS = frozenset({
    "size", "dim", "numel", "element_size", "is_complex",
    "is_floating_point", "is_contiguous", "stride", "data_ptr",
    "get_device", "nelement",
})
# builtins that read a value's type or length, not its data
METADATA_BUILTINS = frozenset({"isinstance", "type", "len", "hasattr",
                               "getattr", "id", "callable"})
# torch.* calls whose result is a Python value known without the card
TORCH_STATIC_CALLS = frozenset({
    "torch.is_tensor", "torch.is_complex", "torch.is_floating_point",
    "torch.is_grad_enabled", "torch.is_inference_mode_enabled",
    "torch.device", "torch.get_default_dtype", "torch.finfo", "torch.iinfo",
    "torch.promote_types", "torch.result_type", "torch.can_cast",
    "torch.Size", "torch.numel", "torch.no_grad", "torch.enable_grad",
    "torch.inference_mode", "torch.set_grad_enabled", "torch.Generator",
    "torch.manual_seed", "torch.get_num_threads", "torch.set_num_threads",
})
# methods only a torch.Tensor has (numpy arrays and Python values lack
# them): their result is a tensor
TENSOR_METHODS = frozenset({
    "long", "int", "short", "bool", "half", "bfloat16", "double", "float",
    "cfloat", "cdouble", "cuda", "contiguous", "detach", "clone", "to",
    "type_as", "masked_fill", "masked_fill_", "index_select",
    "requires_grad_", "new_zeros", "new_full", "new_ones", "new_empty",
    "new_tensor", "unsqueeze", "permute", "expand", "expand_as", "narrow",
    "view_as", "index_put", "index_put_", "masked_scatter",
})
# explicit host reads: their result lives on the host, a Python value or
# a CPU tensor/array (JL002's to report)
HOST_READ_ATTRS = frozenset({"item", "tolist", "cpu", "numpy"})
HOST_READ_QUALS = frozenset({"torch.equal", "torch.allclose",
                             "torch.is_nonzero"})
CAST_BUILTINS = ("float", "int", "bool", "complex")
SCALAR_ANNOTATIONS = ("bool", "int", "float")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str
    symbol: str = ""
    report_only: bool = False

    def key(self):
        """Baseline identity (line-independent, see module doc)."""
        return (self.rule, package_relpath(self.path), self.symbol,
                self.message)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "path": _posix(self.path), "line": self.line,
            "col": self.col, "message": self.message, "symbol": self.symbol,
            "report_only": self.report_only,
        }


def _posix(path: str) -> str:
    return path.replace(os.sep, "/")


@functools.lru_cache(maxsize=4096)
def package_relpath(path: str) -> str:
    """``path`` from the directory above its top-level package; a file
    outside any package keeps its path.  A non-package directory inside
    a package (``csrc/``) counts as part of it."""
    full = os.path.abspath(path)
    d = os.path.dirname(full)
    if not os.path.isfile(os.path.join(d, "__init__.py")) and os.path.isfile(
            os.path.join(os.path.dirname(d), "__init__.py")):
        d = os.path.dirname(d)
    top = None
    while os.path.isfile(os.path.join(d, "__init__.py")):
        top = d
        d = os.path.dirname(d)
    if top is None:
        return _posix(path)
    return _posix(os.path.relpath(full, os.path.dirname(top)))


class Rule:
    """Base class: one diagnostic, one module, fixture-tested."""

    id = "JL000"
    title = ""
    report_only = False

    def check(self, graph: CallGraph) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, mi, node, message: str, symbol: str = "") -> Finding:
        return Finding(
            path=mi.path, line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0), rule=self.id,
            message=message, symbol=symbol, report_only=self.report_only,
        )


# --------------------------------------------------- shared AST helpers


def parent_of(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_torchlint_parent", None)


def yields_tensor(call: ast.Call, mi: ModuleInfo) -> bool:
    """A call that yields a tensor: into the ``torch`` namespace, a
    tensor-only method (``x.long()``, ``x.detach()``), or a package
    function whose return annotation names ``Tensor``."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in TENSOR_METHODS:
        head = f.value
        while isinstance(head, (ast.Attribute, ast.Call, ast.Subscript)):
            head = head.func if isinstance(head, ast.Call) else head.value
        if not (isinstance(head, ast.Name) and head.id in mi.imports
                and mi.imports[head.id] != "torch"):
            return True
    q = qual_of(f, mi.imports, mi.toplevel, mi.name)
    if q is None:
        return False
    if not (q == "torch" or q.startswith("torch.")):
        fi = mi.graph.callee(mi, call) if mi.graph is not None else None
        return fi is not None and fi.returns_tensor
    if q in TORCH_STATIC_CALLS or q in HOST_READ_QUALS or q.startswith(
            ("torch.cuda.", "torch.backends.")):
        return False
    return True


def returns_scalar(fn: ast.AST) -> bool:
    """Whether a function is annotated to return a Python scalar."""
    ret = getattr(fn, "returns", None)
    return isinstance(ret, ast.Name) and ret.id in SCALAR_ANNOTATIONS


def _metadata_read(node: ast.AST) -> bool:
    """``x.shape``, ``x[0].dtype``, ``x.size()``, ``isinstance(x, ...)``,
    ``len(x)``-style reads of a tensor: metadata, no card."""
    cur = node
    while True:
        parent = parent_of(cur)
        if isinstance(parent, ast.Call) and cur in parent.args:
            return (isinstance(parent.func, ast.Name)
                    and parent.func.id in METADATA_BUILTINS)
        if isinstance(parent, ast.Subscript) and parent.value is cur:
            cur = parent
            continue
        if not (isinstance(parent, ast.Attribute) and parent.value is cur):
            return False
        if parent.attr in STATIC_ATTRS:
            return True
        grand = parent_of(parent)
        if parent.attr in STATIC_METHODS and isinstance(grand, ast.Call) \
                and grand.func is parent:
            return True
        cur = parent


def _under_host_read(node: ast.AST, root: ast.AST, mi: ModuleInfo) -> bool:
    """Whether ``node`` sits inside an explicit host read (``.item()``,
    ``float(...)``) within ``root``: the read's result is a Python
    value."""
    cur = node
    while cur is not root:
        cur = parent_of(cur)
        if cur is None:
            return False
        if _is_host_value(cur, mi):
            return True
    return False


def contains_tensor(node: ast.AST, mi: ModuleInfo,
                    tainted: Optional[Set[str]] = None) -> bool:
    """True when a sub-expression yields a tensor (:func:`yields_tensor`)
    or reads a local known to hold one, other than through metadata reads
    or inside an explicit host read (which JL002 reports)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and yields_tensor(n, mi):
            if _metadata_read(n) or _under_host_read(n, node, mi):
                continue
            return True
        if (tainted and isinstance(n, ast.Name)
                and isinstance(n.ctx, ast.Load) and n.id in tainted):
            if _metadata_read(n) or _under_host_read(n, node, mi):
                continue
            return True
    return False


def _is_host_value(expr: ast.AST, mi: ModuleInfo) -> bool:
    """An expression whose value lives on the host (read off the card):
    ``.item()``, ``.cpu()``, a cast, ``torch.equal``, or a call to a
    package function annotated to return ``bool``/``int``/``float``."""
    if not isinstance(expr, ast.Call):
        return False
    f = expr.func
    if isinstance(f, ast.Attribute) and f.attr in HOST_READ_ATTRS:
        return True
    if isinstance(f, ast.Name) and f.id in CAST_BUILTINS:
        return True
    if qual_of(f, mi.imports, mi.toplevel, mi.name) in HOST_READ_QUALS:
        return True
    fi = mi.graph.callee(mi, expr) if mi.graph is not None else None
    return fi is not None and returns_scalar(fi.node)


def tainted_locals(fn_node: ast.AST,
                   mi: ModuleInfo) -> Dict[str, List[Tuple[int, bool]]]:
    """Each local's assignments as ``(line, holds a tensor)``: parameters
    annotated ``Tensor`` (line 0), and names assigned (directly) from
    tensor-producing expressions.  A one-level, no-fixpoint taint that
    keeps precision high, so static config locals never enter and ``if
    collect_trace:`` stays legal; a local assigned from an explicit host
    read holds a Python value."""
    out: Dict[str, List[Tuple[int, bool]]] = {}
    args = getattr(fn_node, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.annotation is not None and "Tensor" in ast.unparse(
                    a.annotation):
                out.setdefault(a.arg, []).append((0, True))
    for n in ast.walk(fn_node):
        if isinstance(n, ast.Assign):
            tensor = (not _is_host_value(n.value, mi)
                      and contains_tensor(n.value, mi))
            for t in n.targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                for el in elts:
                    if isinstance(el, ast.Name):
                        out.setdefault(el.id, []).append((n.lineno, tensor))
        elif isinstance(n, ast.AugAssign) and isinstance(
                n.target, ast.Name) and contains_tensor(n.value, mi):
            out.setdefault(n.target.id, []).append((n.lineno, True))
    for v in out.values():
        v.sort()
    return out


class TaintCache:
    """Per-function :func:`tainted_locals`, computed once per rule run.
    ``taint(fi, node)`` is the set of locals that hold a tensor where
    ``node`` reads them: by the last assignment above it, or, for a name
    assigned only below (a loop-carried value), by any."""

    def __init__(self, mi: ModuleInfo):
        self.mi = mi
        self._cache = {}

    def __call__(self, fi, node: ast.AST) -> Set[str]:
        if fi.qualname not in self._cache:
            self._cache[fi.qualname] = tainted_locals(fi.node, self.mi)
        line = getattr(node, "lineno", 0)
        out = set()
        for name, assigns in self._cache[fi.qualname].items():
            before = [t for ln, t in assigns if ln < line]
            if before[-1] if before else any(t for _, t in assigns):
                out.add(name)
        return out


def path_segments(path: str) -> Set[str]:
    return set(_posix(path).split("/"))


# --------------------------------------------------------------- engine


def default_rules() -> List[Rule]:
    from sagecal_tpu_torch.analysis.rules import all_rules

    return [cls() for cls in all_rules()]


def _suppressed(f: Finding, graph: CallGraph) -> bool:
    src = graph.modules_by_path.get(f.path) or graph.cuda.get(f.path)
    if src is None:
        return False
    if f.rule in src.file_pragmas or "ALL" in src.file_pragmas:
        return True
    tags = src.pragmas.get(f.line, ())
    if f.rule in tags or "ALL" in tags:
        return True
    return (f.report_only and f.line <= len(src.lines)
            and "# noqa" in src.lines[f.line - 1])


def analyze_paths(paths: Sequence[str],
                  rules: Optional[Sequence[Rule]] = None):
    """Run the rules over ``paths`` (``.py`` files, ``.cu``/``.cuh``
    kernel sources, directories of both).  Returns ``(findings, stats,
    graph)``: pragma-suppressed findings are already removed; baseline
    handling is the caller's (cli.py)."""
    t0 = time.perf_counter()
    files = collect_files(paths)
    graph = build_callgraph(files)
    rules = list(rules) if rules is not None else default_rules()
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.check(graph))
    kept = sorted(f for f in findings if not _suppressed(f, graph))
    parse_errors = [
        Finding(path=mi.path, line=1, col=0, rule="JL000",
                message=f"could not parse: {mi.parse_error}")
        for mi in graph.modules.values() if mi.parse_error
    ]
    stats = {
        "files": len(files),
        "cuda_sources": len(graph.cuda),
        "device_roots": sum(1 for fi in graph.functions.values()
                            if fi.root_kind),
        "device_reachable": len(graph.reachable),
        "elapsed_seconds": round(time.perf_counter() - t0, 3),
        "rules": [r.id for r in rules],
    }
    return sorted(parse_errors) + kept, stats, graph


# -------------------------------------------------------------- reports


def format_text(findings: Iterable[Finding], stats: dict,
                new_keys: Optional[Set] = None,
                baselined: int = 0) -> str:
    fs = list(findings)
    lines = []
    for f in fs:
        mark = ""
        if f.report_only:
            mark = " [report-only]"
        elif new_keys is not None and f.key() not in new_keys:
            mark = " [baselined]"
        sym = f" in `{f.symbol.split('.')[-1]}`" if f.symbol else ""
        lines.append(
            f"{_posix(f.path)}:{f.line}:{f.col}: {f.rule} {f.message}"
            f"{sym}{mark}"
        )
    n_report = sum(1 for f in fs if f.report_only)
    n_gate = len(fs) - n_report
    n_new = len(new_keys) if new_keys is not None else n_gate
    lines.append(
        f"torchlint: {n_gate} finding(s) ({n_new} new, {baselined} "
        f"baselined) + {n_report} report-only over {stats['files']} "
        f"file(s), {stats['device_reachable']} device-reachable "
        f"function(s), {stats['elapsed_seconds']}s"
    )
    if n_new:
        lines.append(
            "fix each finding, or suppress a deliberate one with "
            "`# torchlint: disable=RULE — reason`"
        )
    return "\n".join(lines)


def format_json(findings: Iterable[Finding], stats: dict,
                new_keys: Optional[Set] = None,
                baselined: int = 0) -> str:
    fs = list(findings)
    recs = []
    for f in fs:
        d = f.to_dict()
        if new_keys is not None and not f.report_only:
            d["new"] = f.key() in new_keys
        recs.append(d)
    n_report = sum(1 for f in fs if f.report_only)
    n_gate = len(fs) - n_report
    payload = {
        "version": 1,
        "findings": recs,
        "summary": {
            "total": n_gate,
            "new": len(new_keys) if new_keys is not None else n_gate,
            "baselined": baselined,
            "report_only": n_report,
        },
        "stats": stats,
    }
    return json.dumps(payload, indent=2, sort_keys=True)
