"""JL012: mixed-dtype numeric comparison / tolerance-less closeness
(the reference's rule; its dtype tokens read ``torch.bfloat16`` as they
read ``jnp.bfloat16``).

The bf16 coherency path (``coh_dtype="bf16"``) deliberately stores the
dominant HBM stream at half precision while accumulating in f32, and
the shadow auditor (``obs/shadow.py``) quantifies the resulting numerical
drift against a central tolerance policy.  Two code patterns silently
undermine that discipline inside the numerics layers:

- **mixed-dtype comparisons** — a predicate whose two sides reference
  different float families (bf16 vs f32/f64).  The comparison is legal
  (PyTorch upcasts), but the result encodes an implicit tolerance of one
  half-precision ULP that nobody chose.  Convergence checks and branch
  guards built this way change behavior when a caller flips
  ``coh_dtype``;
- **tolerance-less closeness checks** — ``allclose``/``isclose`` with
  no ``rtol``/``atol`` leans on library defaults (``rtol=1e-5``) that
  were tuned for f64 and are *dtype-blind*: at bf16 resolution (~3
  decimal digits) the default rtol is below one ULP, so the check is
  effectively exact equality; at f64 it is far looser than the solver
  tolerances.  Every closeness check in the numerics layers should
  state the tolerance it means, ideally sourced from the same policy
  table the shadow auditor gates on (``shadow.DRIFT_TOLERANCES``).

Report-only: both patterns have legitimate instances (e.g. a guard
that *intends* "equal at storage precision").  Deliberate cases are
recorded in ``analysis/lint_baseline.json`` with a ``why``, or carry
a ``# torchlint: disable=JL012 — reason`` pragma at the line.

Scope: ``ops/`` and ``solvers/`` — the layers where a silent implicit
tolerance corrupts science, not plumbing/reporting code.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Set

from sagecal_tpu_torch.analysis.engine import Finding, Rule, path_segments
from sagecal_tpu_torch.analysis.callgraph import qual_of

_SCOPE_SEGMENTS = {"ops", "solvers"}

# dtype tokens -> float family; underscores count as token boundaries
# so `coh_bf16` and `x_f32` carry dtype intent while `crc32` does not
_FAMILY_RE = re.compile(
    r"(?<![A-Za-z0-9])(bfloat16|bf16|float32|float64|f32|f64)"
    r"(?![A-Za-z0-9])")
_FAMILY = {"bfloat16": "bf16", "bf16": "bf16",
           "float32": "f32", "f32": "f32",
           "float64": "f64", "f64": "f64"}

_CLOSE_NAMES = ("allclose", "isclose")
_TOL_KWARGS = {"rtol", "atol", "rel_tol", "abs_tol", "tol", "tolerance"}


def _families(node: ast.AST) -> Set[str]:
    """Float families referenced anywhere in an expression subtree."""
    try:
        text = ast.unparse(node).lower()
    except Exception:  # pragma: no cover - malformed subtree
        return set()
    return {_FAMILY[m] for m in _FAMILY_RE.findall(text)}


class MixedDtypeComparison(Rule):
    id = "JL012"
    title = "mixed-dtype comparison / tolerance-less closeness check"
    report_only = True

    def check(self, graph) -> Iterator[Finding]:
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            if not (_SCOPE_SEGMENTS & path_segments(mi.path)):
                continue
            for node in ast.walk(mi.tree):
                if isinstance(node, ast.Call):
                    f = self._check_closeness(mi, node)
                    if f is not None:
                        yield f
                elif isinstance(node, ast.Compare):
                    f = self._check_mixed(mi, node)
                    if f is not None:
                        yield f

    def _check_closeness(self, mi, node: ast.Call):
        q = qual_of(node.func, mi.imports, mi.toplevel, mi.name) or ""
        leaf = q.rsplit(".", 1)[-1]
        if leaf not in _CLOSE_NAMES:
            return None
        if any(kw.arg in _TOL_KWARGS for kw in node.keywords
               if kw.arg is not None):
            return None
        if len(node.args) >= 3:  # positional rtol
            return None
        fi = mi.enclosing_function(node)
        return self.finding(
            mi, node,
            f"`{leaf}` without explicit rtol/atol in the numerics "
            "layers — library defaults are dtype-blind (below one ULP "
            "at bf16, looser than solver tolerances at f64); state "
            "the tolerance this check means",
            symbol=fi.qualname if fi else "",
        )

    def _check_mixed(self, mi, node: ast.Compare):
        left_fams = _families(node.left)
        if not left_fams:
            return None
        for comparator in node.comparators:
            right_fams = _families(comparator)
            if not right_fams or right_fams == left_fams:
                continue
            # string-literal dtype dispatch (`cfg.coh_dtype == "bf16"`)
            # is configuration, not numerics: exempt compares whose
            # every comparator is a bare string constant
            if all(isinstance(c, ast.Constant) and isinstance(c.value, str)
                   for c in node.comparators):
                return None
            fi = mi.enclosing_function(node)
            return self.finding(
                mi, node,
                "comparison mixes float families "
                f"({'/'.join(sorted(left_fams))} vs "
                f"{'/'.join(sorted(right_fams))}) — the upcast encodes "
                "an implicit half-precision tolerance nobody chose; "
                "cast both sides or compare at a stated tolerance",
                symbol=fi.qualname if fi else "",
            )
        return None
