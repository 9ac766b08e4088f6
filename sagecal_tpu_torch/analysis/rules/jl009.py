"""JL009: unguarded ``pickle.load``/``torch.load`` of a shared artifact.

Artifacts shared across fleet workers (the kernel store) outlive any
single process, so a loader will eventually meet bytes produced by a
different torch/CUDA/python/artifact-format vintage.  Unpickling those
blind (``torch.load`` unpickles too) either deserializes garbage or
throws deep inside torch, both far from the real cause.

The port's mandatory pattern is ``serve/aot_store.py``: a JSON sidecar
carrying a magic tag and the full version fields, validated *before*
the artifact is loaded, with any mismatch treated as a cache miss.
This rule flags ``pickle.load``/``pickle.loads``/``torch.load`` calls
whose enclosing function shows no sign of that gate (no magic, version
or sidecar check anywhere in the function).  The detection is textual
over the function body, as the reference's: the point is to force new
loading sites through a reviewed header check rather than to prove the
check correct (the protocol checker and the kernel-store tests do
that).
"""

from __future__ import annotations

import ast
from typing import Iterator

from sagecal_tpu_torch.analysis.callgraph import qual_of
from sagecal_tpu_torch.analysis.engine import Finding, Rule

_LOADS = {"pickle.load", "pickle.loads", "cPickle.load", "cPickle.loads",
          "torch.load"}
_GATE_TOKENS = ("magic", "version", "sidecar")


class UnguardedLoad(Rule):
    id = "JL009"
    title = "pickle.load/torch.load without a version-header gate"

    def check(self, graph) -> Iterator[Finding]:
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            for node in ast.walk(mi.tree):
                if not isinstance(node, ast.Call):
                    continue
                q = qual_of(node.func, mi.imports, mi.toplevel, mi.name)
                if q not in _LOADS:
                    continue
                fi = mi.enclosing_function(node)
                scope = fi.node if fi is not None else mi.tree
                src = ast.unparse(scope).lower()
                if any(tok in src for tok in _GATE_TOKENS):
                    continue
                yield self.finding(
                    mi, node,
                    f"`{q}` without a magic/version header gate — "
                    f"validate a header or sidecar (see "
                    f"serve/aot_store.py, the mandatory pattern) "
                    f"before loading, and treat any mismatch as a "
                    f"cache miss",
                    symbol=fi.qualname if fi else "",
                )
