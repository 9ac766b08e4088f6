"""JL001: Python control flow on a tensor in device-reachable code.

``if``/``while``/``assert`` whose test calls into ``torch`` (or reads a
local assigned from such a call) asks ``bool()`` of a tensor: on CUDA
that is an implicit ``.item()``, a device-to-host read that waits for
every queued launch.  The fix is ``torch.where``, a masked update, or
reading the value once where the host needs it (and recording that read
under JL002).

Precision: only tensor-tainted tests fire.  ``if collect_trace:`` on a
static bool, ``if x is None``, metadata (``x.shape``, ``x.is_cuda``,
``x.numel()``) and tests on an explicit host read (``if r.item() <
tol:``, which JL002 reports) stay silent.

Report-only: the EM's stopping tests are host decisions by design; every
finding is recorded in the baseline with its reason.
"""

from __future__ import annotations

import ast
from typing import Iterator

from sagecal_tpu_torch.analysis.engine import (
    Finding,
    Rule,
    TaintCache,
    contains_tensor,
)


def _identity_test(test: ast.AST) -> bool:
    """``x is None`` / ``x is not None``: object identity reads no
    tensor value."""
    if isinstance(test, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)
    if isinstance(test, ast.BoolOp):
        return all(_identity_test(v) for v in test.values)
    return False


class TensorControlFlow(Rule):
    id = "JL001"
    title = ("Python if/while/assert on a tensor inside device-reachable "
             "code (an implicit .item())")
    report_only = True

    def check(self, graph) -> Iterator[Finding]:
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            taint = TaintCache(mi)
            for node in ast.walk(mi.tree):
                if not isinstance(node, (ast.If, ast.While, ast.Assert)):
                    continue
                fi = graph.stmt_reachable(mi, node)
                if fi is None or _identity_test(node.test):
                    continue
                if not contains_tensor(node.test, mi, taint(fi, node)):
                    continue
                kind = {ast.If: "if", ast.While: "while",
                        ast.Assert: "assert"}[type(node)]
                yield self.finding(
                    mi, node,
                    f"Python `{kind}` on a tensor waits on the card "
                    f"(an implicit .item(); use torch.where or read the "
                    f"value once)",
                    symbol=fi.qualname,
                )
