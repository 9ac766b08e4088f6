"""JL016: JSONL appended via buffered file.write instead of the
registered O_APPEND single-write emitter (the reference's rule,
unchanged, over the port's ``fleet/``, ``serve/``, ``elastic/`` and
``obs/``).

Every JSONL record family the fleet emits is registered in the schema
ledger (``sagecal_tpu_torch/obs/ledger.py``) with a writer identity, and the
audit trail's torn-record guarantee (``diag audit`` treats a torn line
as a *violation*, not noise) rests on each line reaching the file in
exactly one ``os.write`` on an ``O_APPEND`` descriptor — POSIX makes
that single write atomic with respect to concurrent appenders, so a
crash or a second writer can never interleave half-lines.

A buffered ``fh.write(json.dumps(rec) + "\\n")`` on an ordinary file
object silently breaks that argument twice: the userspace buffer may
flush mid-line (torn records under crash), and two processes appending
through separate buffered handles can interleave chunks (torn records
under concurrency).  Such lines would surface as ``torn`` in the audit
and — worse — implicate the emitters that *are* correct.

This rule flags single-argument ``<obj>.write(expr)`` calls in the
telemetry-bearing layers (``fleet/``, ``serve/``, ``elastic/``,
``obs/``) whose
argument both serializes JSON (a ``dumps`` call in the subtree) and
carries a newline constant — the JSONL-append signature.  Exempt:

- the registered emitter idiom itself (``os.write(fd, line)`` — two
  positional arguments, receiver ``os``);
- tmp-staged whole-document writes, where the enclosing function
  publishes via ``os.replace``/``os.link`` (atomic-rename idiom — the
  write target is never the live file);
- paths whose source text mentions ``tmp`` (the staging half).

Fix by routing through the family's registered emitter (EventLog /
Tracer / TimelineSampler / ShadowAuditor) or by opening with
``os.open(path, O_APPEND | ...)`` and emitting the line in one
``os.write``.  A deliberate buffered append (single-process, post-hoc
consumer) belongs in the baseline with a ``why`` or a
``# torchlint: disable=JL016 — reason`` pragma.
"""

from __future__ import annotations

import ast
from typing import Iterator

from sagecal_tpu_torch.analysis.engine import Finding, Rule, path_segments

_SCOPE_SEGMENTS = {"fleet", "serve", "elastic", "obs"}

_PUBLISH_ATTRS = {"replace", "link", "rename"}


def _has_dumps_call(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr == "dumps":
                return True
            if isinstance(f, ast.Name) and f.id == "dumps":
                return True
    return False


def _has_newline_const(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant):
            v = n.value
            if isinstance(v, str) and "\n" in v:
                return True
            if isinstance(v, bytes) and b"\n" in v:
                return True
    return False


def _publishes_atomically(scope: ast.AST) -> bool:
    """True when the scope links/renames a staged file into place —
    the buffered write then targets a tmp file, not the live record."""
    for n in ast.walk(scope):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _PUBLISH_ATTRS \
                and isinstance(n.func.value, ast.Name) \
                and n.func.value.id == "os":
            return True
    return False


class BufferedJsonlAppend(Rule):
    id = "JL016"
    title = ("JSONL appended via buffered file.write instead of the "
             "registered O_APPEND single-write emitter")

    def check(self, graph) -> Iterator[Finding]:
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            if not (_SCOPE_SEGMENTS & path_segments(mi.path)):
                continue
            for node in ast.walk(mi.tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if not (isinstance(f, ast.Attribute)
                        and f.attr == "write"):
                    continue
                # os.write(fd, line) IS the registered emitter idiom
                if isinstance(f.value, ast.Name) and f.value.id == "os":
                    continue
                if len(node.args) != 1 or node.keywords:
                    continue
                arg = node.args[0]
                if not (_has_dumps_call(arg) and _has_newline_const(arg)):
                    continue
                recv_src = ast.unparse(f.value).lower()
                if "tmp" in recv_src:
                    continue  # staging half of the atomic idiom
                fi = mi.enclosing_function(node)
                scope = fi.node if fi is not None else mi.tree
                if fi is not None and _publishes_atomically(scope):
                    continue
                yield self.finding(
                    mi, node,
                    "JSONL line appended through a buffered file "
                    "handle — userspace buffering can flush mid-line "
                    "and concurrent appenders interleave, producing "
                    "torn records the fleet audit treats as "
                    "violations; emit via the family's registered "
                    "writer or one os.write on an O_APPEND fd",
                    symbol=fi.qualname if fi else "",
                )
