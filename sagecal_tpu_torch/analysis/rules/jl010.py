"""JL010: raw wall clock inside lease/deadline logic (the reference's
rule, unchanged, over the port's ``fleet/``, ``serve/``, ``elastic/``
and ``obs/``).

Lease expiry, steal-after-TTL, EDF deadlines and SLO burn are all
*time-threshold* predicates.  The protocol model checker can only
drive the real implementations through adversarial schedules because
every such predicate reads an injectable clock (``clock=time.time`` as
a constructor default, ``now=None`` parameters defaulting to the real
clock at the call site).  A raw ``time.time()`` buried inside the
logic re-anchors it to the wall clock, making TTL-boundary behavior
untestable — exactly where the checker found the renew-past-TTL bug.

This rule flags ``time.time()`` calls in the fleet-era layers
(``fleet/``, ``serve/``, ``elastic/``, ``obs/``) whose enclosing function deals
in leases/deadlines (its source mentions lease, expire, ttl or
deadline).  The accepted injectable-default idiom
``now = time.time() if now is None else float(now)`` is exempt: the
call only fires when the caller declined to inject.  Latency
measurement (``tic = time.time()`` in solve paths) is out of scope —
it feeds reporting, not protocol predicates.
"""

from __future__ import annotations

import ast
from typing import Iterator

from sagecal_tpu_torch.analysis.engine import Finding, Rule, path_segments
from sagecal_tpu_torch.analysis.callgraph import qual_of

_SCOPE_SEGMENTS = {"fleet", "serve", "elastic", "obs"}
_LEASE_TOKENS = ("lease", "expire", "ttl", "deadline")


def _is_injectable_default(node: ast.AST) -> bool:
    """True for the ``X if <param> is None else ...`` default idiom."""
    parent = getattr(node, "_torchlint_parent", None)
    if not isinstance(parent, ast.IfExp) or parent.body is not node:
        return False
    test = parent.test
    return (isinstance(test, ast.Compare)
            and len(test.ops) == 1 and isinstance(test.ops[0], ast.Is)
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None)


class RawClockInLeaseLogic(Rule):
    id = "JL010"
    title = "raw time.time() in lease/deadline logic"

    def check(self, graph) -> Iterator[Finding]:
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            if not (_SCOPE_SEGMENTS & path_segments(mi.path)):
                continue
            for node in ast.walk(mi.tree):
                if not isinstance(node, ast.Call):
                    continue
                q = qual_of(node.func, mi.imports, mi.toplevel, mi.name)
                if q != "time.time":
                    continue
                if _is_injectable_default(node):
                    continue
                fi = mi.enclosing_function(node)
                scope = fi.node if fi is not None else mi.tree
                src = ast.unparse(scope).lower()
                if not any(tok in src for tok in _LEASE_TOKENS):
                    continue
                yield self.finding(
                    mi, node,
                    "raw time.time() inside lease/deadline logic — "
                    "read an injectable clock (constructor "
                    "`clock=time.time`, or a `now=None` parameter "
                    "defaulting at the boundary) so the protocol "
                    "checker can drive TTL boundaries",
                    symbol=fi.qualname if fi else "",
                )
