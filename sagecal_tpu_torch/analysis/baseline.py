"""Baseline file: record the report-only findings, each with its reason
(counterpart of ``sagecal_tpu/analysis/baseline.py``).

The baseline is a committed JSON file mapping finding keys (rule, path,
symbol, message) to an occurrence count and a ``why``.  The gate only
fails on *new* gate findings: keys absent from the baseline, or present
more often than the baseline allows.  Counts (rather than a set) make
two identical findings in one file distinguishable from one.

The port ships ``sagecal_tpu_torch/analysis/lint_baseline.json`` with
**zero gate findings** (every gate finding is fixed or carries a
reasoned pragma).  The report-only findings are recorded there too,
each with its ``why``: they never gate, but a committed record of each
one (a host read of the LM's stopping test, a data-dependent shape in a
plan built once per tile) tells "known and decided" from "new and
undecided", and the JL001/JL002/JL005 records are the static list of
the places where the EM waits on the card.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Counter, Iterable, List, Tuple

from sagecal_tpu_torch.analysis.engine import Finding

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "lint_baseline.json")


def _key(rec: dict) -> Tuple[str, str, str, str]:
    return (rec["rule"], rec["path"], rec.get("symbol", ""), rec["message"])


def _records(path: str) -> List[dict]:
    if not path or not os.path.isfile(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f).get("findings", [])


def load_baseline(path: str) -> Counter:
    """Counter of finding keys; an absent file is an empty baseline."""
    out: Counter = collections.Counter()
    for rec in _records(path):
        out[_key(rec)] += int(rec.get("count", 1))
    return out


def load_whys(path: str) -> dict:
    """key -> "why" from the committed baseline, so a rewrite never
    drops the reason attached to a finding."""
    try:
        return {_key(r): r["why"] for r in _records(path) if r.get("why")}
    except (OSError, ValueError):
        return {}


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    whys = load_whys(path)
    counts: Counter = collections.Counter(f.key() for f in findings)
    recs = []
    for k, n in sorted(counts.items()):
        rec = {"rule": k[0], "path": k[1], "symbol": k[2],
               "message": k[3], "count": n}
        if k in whys:
            rec["why"] = whys[k]
        recs.append(rec)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "findings": recs}, f, indent=2,
                  sort_keys=True)
        f.write("\n")


def partition(findings: Iterable[Finding], baseline: Counter):
    """Split gate-relevant findings into (new, grandfathered) lists.

    Report-only findings are never gated and appear in neither list."""
    remaining = collections.Counter(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        if f.report_only:
            continue
        if remaining[f.key()] > 0:
            remaining[f.key()] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
