"""JL900 (report-only): unused imports.

An auxiliary hygiene sweep, never gated: imports bound in a module but
never referenced.  ``# noqa`` on the import line (the repo's existing
convention for ``__init__`` re-exports), membership in ``__all__``, and
``__future__``/side-effect-only imports are all honored.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from sagecal_tpu_torch.analysis.engine import Finding, Rule


def _exported_names(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    if isinstance(node.value, (ast.List, ast.Tuple)):
                        out |= {e.value for e in node.value.elts
                                if isinstance(e, ast.Constant)
                                and isinstance(e.value, str)}
    return out


class DeadImport(Rule):
    id = "JL900"
    title = "unused import"
    report_only = True

    def check(self, graph) -> Iterator[Finding]:
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            exported = _exported_names(mi.tree)
            used: Set[str] = set()
            for node in ast.walk(mi.tree):
                if isinstance(node, ast.Name) and not isinstance(
                        node.ctx, ast.Store):
                    used.add(node.id)
                elif isinstance(node, ast.Attribute):
                    # head of a dotted chain counts as a use of the
                    # binding; string annotations stay conservative
                    head = node
                    while isinstance(head, ast.Attribute):
                        head = head.value
                    if isinstance(head, ast.Name):
                        used.add(head.id)
                elif isinstance(node, ast.Constant) and isinstance(
                        node.value, str):
                    # forward-ref annotations / doctests: any word match
                    # keeps the import (conservative by design)
                    used |= set(_words(node.value))
            for node in ast.walk(mi.tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        bound = a.asname or a.name.split(".")[0]
                        yield from self._flag(mi, node, a, bound,
                                              used, exported)
                elif isinstance(node, ast.ImportFrom):
                    if node.module == "__future__":
                        continue
                    for a in node.names:
                        if a.name == "*":
                            continue
                        bound = a.asname or a.name
                        yield from self._flag(mi, node, a, bound,
                                              used, exported)

    def _flag(self, mi, node, alias, bound, used, exported):
        if bound in used or bound in exported or bound.startswith("_"):
            return
        # multi-line from-import lists carry noqa per alias line
        spot = alias if getattr(alias, "lineno", None) else node
        for lineno in {node.lineno, spot.lineno}:
            if lineno <= len(mi.lines) and "noqa" in mi.lines[lineno - 1]:
                return
        yield self.finding(mi, spot, f"unused import `{bound}`",
                           symbol=bound)


_WORD_CACHE = {}


def _words(s: str) -> Set[str]:
    if len(s) > 4096:
        s = s[:4096]
    if s not in _WORD_CACHE:
        import re

        if len(_WORD_CACHE) >= 2048:
            _WORD_CACHE.clear()
        _WORD_CACHE[s] = set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", s))
    return _WORD_CACHE[s]
