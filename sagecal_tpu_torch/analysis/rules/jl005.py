"""JL005: data-dependent output shapes in device-reachable code.

``torch.nonzero``, ``torch.unique``, ``masked_select``, ``argwhere``,
one-argument ``torch.where`` and boolean-mask indexing give a tensor
whose shape depends on the values: PyTorch must read the count back
from the card before it can allocate the result, so each one waits on
every queued launch, as a ``.item()`` does.  The fix is the
three-argument ``torch.where`` or a fixed-size mask-and-weight form,
or building the index once per tile, outside the iterations.

Report-only: a plan built once per tile is deliberate; the baseline
records each site with its reason.
"""

from __future__ import annotations

import ast
from typing import Iterator

from sagecal_tpu_torch.analysis.callgraph import qual_of
from sagecal_tpu_torch.analysis.engine import Finding, Rule

_DDS = {"nonzero", "unique", "unique_consecutive", "masked_select",
        "argwhere"}


class DataDependentShape(Rule):
    id = "JL005"
    title = "data-dependent output shape in device-reachable code"
    report_only = True

    def check(self, graph) -> Iterator[Finding]:
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            for node in ast.walk(mi.tree):
                msg = self._classify(node, mi)
                if msg is None:
                    continue
                fi = graph.stmt_reachable(mi, node)
                if fi is None:
                    continue
                yield self.finding(mi, node, msg, symbol=fi.qualname)

    def _classify(self, node, mi):
        if isinstance(node, ast.Call):
            q = qual_of(node.func, mi.imports, mi.toplevel, mi.name) or ""
            leaf = q.rsplit(".", 1)[-1]
            is_torch = q.startswith("torch.")
            head = node.func
            while isinstance(head, ast.Attribute):
                head = head.value
            # x.unique(): a method of a value, not of an imported module
            is_method = (isinstance(node.func, ast.Attribute)
                         and not (isinstance(head, ast.Name)
                                  and head.id in mi.imports))
            if leaf in _DDS and (is_torch or is_method):
                return (f"`{leaf}` has a data-dependent output shape: it "
                        f"waits on the card (use a fixed-size mask "
                        f"formulation, or build it once per tile)")
            if q == "torch.where" and len(node.args) == 1 \
                    and not node.keywords:
                return ("one-argument `torch.where` has a data-dependent "
                        "output shape: it waits on the card (use the "
                        "three-argument form)")
        elif isinstance(node, ast.Subscript) and isinstance(
                node.slice, ast.Compare):
            return ("boolean-mask indexing has a data-dependent output "
                    "shape: it waits on the card (use torch.where with a "
                    "fill value)")
        return None
