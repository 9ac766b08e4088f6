"""JL004: unconditional 64-bit torch dtypes in the precision-policy
layers.

The port's policy follows the data: ``ops/``, ``solvers/`` and
``parallel/`` take their dtype from their inputs (complex64 at f32,
complex128 when the caller hands f64), and the kernels compute in f32.
An *unconditional* ``torch.float64``/``torch.complex128`` there doubles
the bytes every kernel and transfer moves, and on an H100 runs f64
arithmetic at a fraction of the f32 rate.

Precision: only unconditional 64-bit dtypes fire.  The port's idiom of
taking the dtype from the data,

    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64

selects it *conditionally* (inside an ``IfExp`` or an ``if``) and stays
silent, as do host-side ``np.float64`` precomputations.
"""

from __future__ import annotations

import ast
from typing import Iterator

from sagecal_tpu_torch.analysis.callgraph import qual_of
from sagecal_tpu_torch.analysis.engine import (
    Finding,
    Rule,
    parent_of,
    path_segments,
)

_POLICY_SEGMENTS = {"ops", "solvers", "parallel"}
_WIDE = {"torch.float64", "torch.complex128", "torch.double",
         "torch.cdouble"}


def _under_conditional(node: ast.AST) -> bool:
    cur = parent_of(node)
    while cur is not None:
        if isinstance(cur, (ast.IfExp, ast.If)):
            return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Module)):
            return False
        cur = parent_of(cur)
    return False


class DtypePolicy(Rule):
    id = "JL004"
    title = ("unconditional 64-bit torch dtype inside the policy layers "
             "(ops/solvers/parallel)")

    def check(self, graph) -> Iterator[Finding]:
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            if not (_POLICY_SEGMENTS & path_segments(mi.path)):
                continue
            for node in ast.walk(mi.tree):
                if not isinstance(node, ast.Attribute):
                    continue
                q = qual_of(node, mi.imports, mi.toplevel, mi.name)
                if q not in _WIDE or _under_conditional(node):
                    continue
                fi = mi.enclosing_function(node)
                yield self.finding(
                    mi, node,
                    f"unconditional `{q}` breaks the take-the-dtype-from-"
                    f"the-data policy (select the wide dtype conditionally "
                    f"on the input dtype, or keep it out of the compute "
                    f"layers)",
                    symbol=fi.qualname if fi else "",
                )
