"""JL008: non-atomic write to fleet protocol state (the reference's
rule, unchanged, over the port's ``fleet/``, ``serve/``, ``elastic/``
and ``obs/``).

The fleet correctness argument (verified exhaustively by
``sagecal_tpu_torch/analysis/protocol_check.py``) rests on every piece of
shared protocol state — result manifests, queue/lease files,
checkpoints, published solutions — appearing *whole* in one atomic
step: either the hard-link exclusive publish (``RealFS.publish_excl``)
or the tmp + fsync + ``os.replace`` idiom (``RealFS.write_atomic``).
A plain ``open(path, "w")`` on such a path creates a visible-empty /
half-written window that a peer can misread — the exact bug family the
checker's ``torn-publish`` and ``torn-manifest`` mutations re-introduce
and catch.

This rule flags write-mode ``open`` calls in the fleet-era layers
(``fleet/``, ``serve/``, ``elastic/``, ``obs/``) whose target path looks like
protocol state.  The path is judged by its *source text* (the call
argument, plus the one assignment that defined it when it is a local
name), so ``open(out_path, "w")`` after ``out_path = ...".solutions"``
is caught.  Staged tmp files (the atomic idiom's first half) are
exempt.  A deliberate non-atomic write — e.g. the stream solutions
append-chain, which must append across resumed runs and is consumed
only post-hoc — carries a ``# torchlint: disable=JL008 — reason``
pragma.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from sagecal_tpu_torch.analysis.engine import Finding, Rule, path_segments

_SCOPE_SEGMENTS = {"fleet", "serve", "elastic", "obs"}

# substrings that mark a path expression as fleet protocol state
_STATE_TOKENS = (
    "manifest", "lease", "queue", "checkpoint", "ckpt",
    "solutions", "result", "done", "requests.json",
)


def _open_mode(call: ast.Call) -> Optional[str]:
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        return call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


def _name_definitions(scope: ast.AST, name: str) -> Iterator[ast.AST]:
    for n in ast.walk(scope):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    yield n.value
        elif isinstance(n, ast.AugAssign) and isinstance(
                n.target, ast.Name) and n.target.id == name:
            yield n.value


class NonAtomicProtocolWrite(Rule):
    id = "JL008"
    title = ("non-atomic write to fleet protocol state "
             "(manifest/queue/lease/checkpoint/solutions)")

    def check(self, graph) -> Iterator[Finding]:
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            if not (_SCOPE_SEGMENTS & path_segments(mi.path)):
                continue
            for node in ast.walk(mi.tree):
                if not isinstance(node, ast.Call):
                    continue
                if not (isinstance(node.func, ast.Name)
                        and node.func.id == "open"
                        and "open" not in mi.imports):
                    continue
                mode = _open_mode(node)
                if mode is None or not ({"w", "a", "x"} & set(mode)):
                    continue
                if not node.args:
                    continue
                path_src = ast.unparse(node.args[0]).lower()
                if "tmp" in path_src:
                    continue  # staging half of the atomic idiom
                srcs = [path_src]
                fi = mi.enclosing_function(node)
                scope = fi.node if fi is not None else mi.tree
                if isinstance(node.args[0], ast.Name):
                    srcs += [ast.unparse(d).lower() for d in
                             _name_definitions(scope, node.args[0].id)]
                hit = next((tok for tok in _STATE_TOKENS
                            if any(tok in s for s in srcs)), None)
                if hit is None:
                    continue
                yield self.finding(
                    mi, node,
                    f"non-atomic open(..., {mode!r}) of protocol state "
                    f"(path mentions `{hit}`) — stage a tmp file and "
                    f"os.replace it (RealFS.write_atomic), or "
                    f"publish_excl for exclusive claims; torn "
                    f"intermediate states are what the protocol "
                    f"checker's torn-manifest mutation exploits",
                    symbol=fi.qualname if fi else "",
                )
