"""JL006: ``torch.distributed`` collectives outside the parallel layer.

The consensus loop is communication-only: ``all_reduce``,
``all_gather`` and friends belong in ``parallel/`` (and the row-sharded
fit in ``solvers/sharded.py``).  A collective anywhere else couples a
compute module to a process group: unrunnable in one process,
untestable in isolation, and a hang when one rank takes another branch.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from sagecal_tpu_torch.analysis.callgraph import qual_of
from sagecal_tpu_torch.analysis.engine import Finding, Rule, path_segments

_COLLECTIVES = {
    "torch.distributed." + n for n in (
        "all_gather", "all_gather_into_tensor", "all_gather_object",
        "all_reduce", "all_to_all", "all_to_all_single", "broadcast",
        "broadcast_object_list", "barrier", "monitored_barrier", "reduce",
        "reduce_scatter", "reduce_scatter_tensor", "gather",
        "gather_object", "scatter", "scatter_object_list", "send", "recv",
        "isend", "irecv", "batch_isend_irecv")
}
_ALLOWED_SEGMENT = "parallel"
_ALLOWED_BASENAMES = {"sharded.py"}


class StrayCollective(Rule):
    id = "JL006"
    title = ("torch.distributed collective outside parallel/ and "
             "solvers/sharded.py")

    def check(self, graph) -> Iterator[Finding]:
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            if _ALLOWED_SEGMENT in path_segments(mi.path):
                continue
            if os.path.basename(mi.path) in _ALLOWED_BASENAMES:
                continue
            for node in ast.walk(mi.tree):
                if not isinstance(node, ast.Call):
                    continue
                q = qual_of(node.func, mi.imports, mi.toplevel, mi.name)
                if q not in _COLLECTIVES:
                    continue
                fi = mi.enclosing_function(node)
                yield self.finding(
                    mi, node,
                    f"collective `dist.{q.rsplit('.', 1)[-1]}` outside "
                    f"the parallel layer (move it to parallel/ or "
                    f"solvers/sharded.py; compute modules must stay "
                    f"process-group-free)",
                    symbol=fi.qualname if fi else "",
                )
