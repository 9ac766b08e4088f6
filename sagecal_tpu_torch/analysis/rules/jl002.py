"""JL002: host reads in device-reachable code.

``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
``torch.cuda.synchronize()`` (and an event's or stream's
``.synchronize()``), ``torch.equal``/``torch.allclose``, the linalg
calls that check their result on the host (``torch.linalg.cholesky``,
``solve``, ``inv``..., not their ``_ex`` variants), and ``float()``/``int()``/``bool()``/``complex()``
or ``np.asarray``/``np.array`` of a value derived from a tensor: each
copies from the card to the host and waits for every launch queued
before it.  On the port's solve path these reads, not the kernels, are
where the time goes (``PERF.md`` §5: the transfer audit counts them at
run time).

Builtin casts are only flagged when the argument is tensor-tainted:
``float(fdelta)`` on a Python config scalar is free.  A package function
annotated to return ``bool``/``int``/``float`` whose body reads the card
(``solvers/rtr.py::host_read``) is a host-read helper: each call to it
in device-reachable code is reported too, as the place the read happens.

Report-only: the baseline records every site with its reason and is the
static list of the EM's host reads, the list a PR that cuts host syncs
works from.
"""

from __future__ import annotations

import ast
from typing import Iterator

from sagecal_tpu_torch.analysis.callgraph import qual_of
from sagecal_tpu_torch.analysis.engine import (
    CAST_BUILTINS,
    HOST_READ_QUALS,
    Finding,
    Rule,
    TaintCache,
    contains_tensor,
    returns_scalar,
)

_READ_ATTRS = ("item", "tolist", "cpu", "numpy")
_SYNC_QUALS = ("torch.cuda.synchronize",)
# linalg calls that check their result's info on the host (their _ex
# variants do not)
_CHECKED_LINALG = {"torch.linalg." + n for n in (
    "cholesky", "inv", "solve", "eigh", "eigvalsh", "lu_factor", "svd",
    "ldl_factor")} | {"torch.inverse", "torch.cholesky"}
# flagged only when the argument is tensor-tainted
_TAINTED_ONLY_QUALS = ("numpy.asarray", "numpy.array")


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    vals = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu"
               for v in vals)


class HostRead(Rule):
    id = "JL002"
    title = "host read (device-to-host copy and wait) in device-reachable code"
    report_only = True

    def check(self, graph) -> Iterator[Finding]:
        direct = []
        calls = []
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            taint = TaintCache(mi)
            for node in ast.walk(mi.tree):
                if not isinstance(node, ast.Call):
                    continue
                fi = graph.stmt_reachable(mi, node)
                if fi is None:
                    continue
                msg = self._classify(node, mi, fi, taint)
                if msg:
                    direct.append(self.finding(mi, node, msg,
                                               symbol=fi.qualname))
                else:
                    calls.append((mi, node, fi))
        yield from direct
        readers = {f.symbol for f in direct}
        helpers = {q for q in readers if q in graph.functions
                   and returns_scalar(graph.functions[q].node)}
        for mi, node, fi in calls:
            callee = graph.callee(mi, node)
            if callee is not None and callee.qualname in helpers:
                yield self.finding(
                    mi, node,
                    f"`{callee.name}()` reads a value off the card (a "
                    f"host-read helper) and waits on it",
                    symbol=fi.qualname)

    def _classify(self, call, mi, fi, taint):
        func = call.func
        if isinstance(func, ast.Attribute):
            if func.attr in _READ_ATTRS and not call.args:
                return (f"`.{func.attr}()` copies to the host and waits "
                        f"on the card")
            if func.attr == "to" and _to_cpu(call):
                return "`.to(\"cpu\")` copies to the host and waits on the card"
            if func.attr == "synchronize":
                return "`.synchronize()` waits on the card"
        q = qual_of(func, mi.imports, mi.toplevel, mi.name)
        if q in _SYNC_QUALS:
            return f"`{q}()` waits on the card"
        if q in HOST_READ_QUALS:
            return (f"`{q}` returns a Python bool: it copies to the host "
                    f"and waits on the card")
        if q in _CHECKED_LINALG:
            return (f"`{q}` checks its result on the host and waits on "
                    f"the card (its `_ex` variant does not)")
        if q in _TAINTED_ONLY_QUALS and call.args:
            if contains_tensor(call.args[0], mi, taint(fi, call)):
                return (f"`{q}` of a tensor copies to the host and waits "
                        f"on the card")
            return None
        if (isinstance(func, ast.Name) and func.id in CAST_BUILTINS
                and func.id not in mi.imports and call.args
                and contains_tensor(call.args[0], mi, taint(fi, call))):
            return (f"`{func.id}()` of a tensor copies to the host and "
                    f"waits on the card")
        return None
