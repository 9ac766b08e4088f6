"""Cross-path numerical-drift ledger analysis: distributions, watchdog
(counterpart of ``sagecal_tpu/obs/drift.py``).

:mod:`sagecal_tpu_torch.obs.shadow` produces the raw material — one JSONL
record per shadow-audited request.  This module is everything that
happens with those records:

- :func:`check_drift` — the in-process hook the auditor calls per
  record: refresh the ``sagecal_drift_*`` gauges, count watchdog
  escalations, and emit ``shadow_drift_check`` / ``drift_exceeded``
  events into the quality stream.  Drift is degraded-not-diverged and
  report-only by default; ``--abort-on-drift`` escalation is the
  app's decision (serve/service.py), exactly like
  ``abort_on_divergence``.
- :func:`aggregate_drift` — fold records into per-(path-pair, bucket,
  dtype) :class:`~sagecal_tpu_torch.obs.registry._Histogram` distributions,
  reusing the registry's merge/quantile-bounds machinery so reports
  state PROVABLE quantile intervals, not point estimates (the load
  bench discipline).
- :func:`analyze_drift` + :func:`format_drift_report` — the drift
  report (the reference's ``diag drift`` backend; the port's ``diag``
  waits for ROADMAP.md's A11): per-group distribution table with p50/p99 bounds,
  tolerance-policy echo, breach list, sampling honesty (budget skips).

Import-light (stdlib + numpy).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sagecal_tpu_torch.obs.registry import _Histogram, get_registry
from sagecal_tpu_torch.obs.shadow import lookup_tolerances

#: log-spaced relative-error buckets shared by every drift histogram —
#: one fixed layout so shards from different workers merge (the
#: _Histogram contract), spanning f64 dust (1e-12) through order-unity
#: disagreement
DRIFT_HIST_BUCKETS = (
    1e-12, 1e-10, 1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0,
)

#: the ledger metrics that get a distribution per group
DRIFT_METRICS = ("cost_rel_delta", "gain_rel_err_max", "chi2_rel_delta")


def check_drift(elog, record: dict, log=None) -> Tuple[str, List[str]]:
    """The per-record watchdog hook (mirrors ``check_hier_predict``):
    gauges, escalation counter, and the event-stream record.

    ``record`` is the ledger row the auditor just appended (verdict
    already decided by the tolerance policy).  Emits a
    ``shadow_drift_check`` event always and a ``drift_exceeded`` event
    on breach; a drifted path never DIVERGES a run on its own (the
    production solve watchdog owns that verdict — drift escalation to
    an abort is the app's ``--abort-on-drift`` opt-in)."""
    verdict = str(record.get("verdict", "ok"))
    reasons = list(record.get("reasons") or [])
    pair = str(record.get("path_pair", ""))

    reg = get_registry()
    labels = {"path_pair": pair}
    cost = record.get("cost_rel_delta")
    if cost is not None:
        reg.gauge_set("sagecal_drift_cost_rel_delta", float(cost),
                      help="final-cost relative delta of the latest "
                           "shadow audit, production vs reference path",
                      **labels)
    gain = record.get("gain_rel_err_max")
    if gain is not None:
        reg.gauge_set("sagecal_drift_gain_rel_err", float(gain),
                      help="max per-station gain relative error of the "
                           "latest shadow audit", **labels)
    chi2 = record.get("chi2_rel_delta")
    if chi2 is not None:
        reg.gauge_set("sagecal_drift_chi2_rel_delta", float(chi2),
                      help="total chi^2 relative delta of the latest "
                           "shadow audit", **labels)
    reg.counter_inc("sagecal_drift_audits_total", verdict=verdict,
                    path_pair=pair,
                    help="shadow audits completed, by verdict")
    if verdict != "ok":
        reg.counter_inc("sagecal_quality_watchdog_total",
                        help="watchdog escalations", verdict="degraded")

    if elog is not None:
        elog.emit("shadow_drift_check", verdict=verdict, reasons=reasons,
                  request_id=record.get("request_id"),
                  path_pair=pair, bucket=record.get("bucket"),
                  kernel_path=record.get("kernel_path"),
                  cost_rel_delta=cost, gain_rel_err_max=gain,
                  chi2_rel_delta=chi2)
        if verdict != "ok":
            elog.emit("drift_exceeded", reasons=reasons,
                      request_id=record.get("request_id"),
                      path_pair=pair, bucket=record.get("bucket"))
    if log is not None and verdict != "ok":
        log(f"drift watchdog: {verdict} [{pair}] "
            f"({', '.join(reasons)})")
    return verdict, reasons


# ---------------------------------------------------------- aggregation


def _group_key(row: dict) -> Tuple[str, str, str]:
    return (str(row.get("path_pair", "?")),
            str(row.get("bucket", "?")),
            str(row.get("solver_dtype", "?")))


def aggregate_drift(rows: Sequence[dict]) -> Dict[tuple, dict]:
    """Fold ledger records into per-(path_pair, bucket, solver dtype)
    groups, each carrying one :class:`_Histogram` per drift metric plus
    verdict counts and the exact observed maxima (the quantile bounds
    tighten against the observed extremes, so the sampled max always
    lies inside the reported p99 interval — pinned in tests)."""
    groups: Dict[tuple, dict] = {}
    for row in rows:
        g = groups.setdefault(_group_key(row), {
            "n": 0, "exceeded": 0,
            "hist": {m: _Histogram(DRIFT_HIST_BUCKETS)
                     for m in DRIFT_METRICS},
            "max": {m: None for m in DRIFT_METRICS},
            "shadow_s": 0.0,
        })
        g["n"] += 1
        if row.get("verdict") == "drift_exceeded":
            g["exceeded"] += 1
        g["shadow_s"] += float(row.get("shadow_s", 0.0) or 0.0)
        for m in DRIFT_METRICS:
            v = row.get(m)
            if v is None or not np.isfinite(float(v)):
                continue
            v = float(v)
            g["hist"][m].observe(v)
            g["max"][m] = v if g["max"][m] is None else max(g["max"][m], v)
    return groups


def drift_quantiles(groups: Dict[tuple, dict],
                    qs=(0.5, 0.99)) -> Dict[tuple, dict]:
    """Provable quantile-bound intervals per group/metric:
    ``{group: {metric: {"p50": (lo, hi), "p99": (lo, hi), ...}}}``."""
    out: Dict[tuple, dict] = {}
    for key, g in groups.items():
        out[key] = {}
        for m, h in g["hist"].items():
            if h.count == 0:
                continue
            out[key][m] = {
                f"p{int(q * 100)}": h.quantile_bounds(q) for q in qs}
    return out


# -------------------------------------------------------------- reports


def analyze_drift(rows: Sequence[dict],
                  validate_problems: Optional[List[str]] = None) -> dict:
    """Build the ``diag drift`` report from a ledger's records."""
    groups = aggregate_drift(rows)
    quant = drift_quantiles(groups)
    breaches = [
        {"request_id": r.get("request_id"),
         "path_pair": r.get("path_pair"), "bucket": r.get("bucket"),
         "reasons": r.get("reasons") or []}
        for r in rows if r.get("verdict") == "drift_exceeded"
    ]
    report = {
        "n_records": len(rows),
        "n_exceeded": len(breaches),
        "breaches": breaches,
        "groups": [
            {
                "path_pair": key[0], "bucket": key[1], "dtype": key[2],
                "n": g["n"], "exceeded": g["exceeded"],
                "shadow_s": g["shadow_s"],
                "max": dict(g["max"]),
                "quantiles": {
                    m: {p: list(b) for p, b in qb.items()
                        if b is not None}
                    for m, qb in quant.get(key, {}).items()},
                "tolerances": lookup_tolerances(key[0]),
            }
            for key, g in sorted(groups.items())
        ],
        "problems": list(validate_problems or []),
    }
    return report


def format_drift_report(report: dict) -> List[str]:
    """Human-readable ``diag drift`` lines."""
    lines: List[str] = []
    if report["n_records"] == 0:
        lines.append("drift: no samples (shadow auditing off or "
                     "nothing sampled yet) — nothing to gate")
        return lines
    lines.append(f"drift: {report['n_records']} shadow audit(s), "
                 f"{report['n_exceeded']} over tolerance")
    for g in report["groups"]:
        lines.append(f"  {g['path_pair']}  bucket={g['bucket']}  "
                     f"dtype={g['dtype']}  n={g['n']}  "
                     f"exceeded={g['exceeded']}  "
                     f"shadow={g['shadow_s']:.2f}s")
        for m in DRIFT_METRICS:
            qb = g["quantiles"].get(m)
            if not qb:
                continue
            tol = g["tolerances"].get(m)
            parts = [f"    {m:<18s} max={g['max'][m]:.3e}"]
            for p, (lo, hi) in sorted(qb.items()):
                parts.append(f"{p}∈[{lo:.1e},{hi:.1e}]")
            parts.append(f"tol={tol:.1e}" if tol is not None else "")
            lines.append("  ".join(x for x in parts if x))
    for b in report["breaches"]:
        lines.append(f"  BREACH {b['request_id']} [{b['path_pair']}]: "
                     + "; ".join(map(str, b["reasons"])))
    for p in report["problems"]:
        lines.append(f"  problem: {p}")
    return lines
