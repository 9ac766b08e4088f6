"""Per-tenant SLOs: error budgets, multi-window burn rates, overload signal
(a copy of ``sagecal_tpu/obs/slo.py``, which is stdlib-only but cannot
be imported without JAX).

A serve deployment promises each tenant an SLO: a latency deadline and
an availability objective ("99% of requests succeed within 2 s").  This
module turns the aggregated latency/verdict stream into the standard
SRE control signals, **report-only** — nothing here sheds or reorders
work; it emits the numbers a scheduler can act on later:

- **error budget** — ``1 - availability``: the fraction of requests
  allowed to miss (diverge, or blow the deadline) per window.
- **burn rate** — ``error_rate / error_budget`` over a trailing window:
  1.0 spends the budget exactly at the sustainable pace, >1 exhausts it
  early.  Evaluated over SHORT and LONG windows simultaneously
  (multi-window alerting): an alert fires only when *every* window
  burns above ``alert_burn``, so a brief blip (short window spikes,
  long window calm) and an old incident (long window elevated, short
  window recovered) both stay quiet.
- **``slo_burn_alert`` events** with firing/cleared edge semantics and
  ``serve_slo_*`` gauges for the scrape side.
- **``shed_recommended``** — true while the short-window burn exceeds
  ``shed_burn`` (default 10x: the "page now" fast-burn threshold);
  the fleet's admission control (ROADMAP.md, A9) consumes this bit.

Specs come from a ``slo.json`` (``--slo``) or ride inside the request
manifest under a top-level ``"slos"`` key.  Import-light: stdlib only,
usable post-hoc on manifests (``evaluate_results``).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any, Deque, Dict, Iterable, List, Optional, Sequence, Tuple

SLO_SCHEMA_VERSION = 1

#: trailing evaluation windows, seconds (short, long)
DEFAULT_WINDOWS_S = (300.0, 3600.0)
DEFAULT_ALERT_BURN = 2.0
DEFAULT_SHED_BURN = 10.0


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One tenant's objective.  ``availability`` is the success target
    (0.99 = 1% error budget); a request errs when it diverges OR its
    latency exceeds ``deadline_s``."""

    tenant: str
    deadline_s: float
    availability: float = 0.99
    windows_s: Tuple[float, float] = DEFAULT_WINDOWS_S
    alert_burn: float = DEFAULT_ALERT_BURN
    shed_burn: float = DEFAULT_SHED_BURN

    def __post_init__(self):
        if not (0.0 < self.availability < 1.0):
            raise ValueError(
                f"slo[{self.tenant}]: availability must be in (0, 1), "
                f"got {self.availability}")
        if self.deadline_s <= 0.0:
            raise ValueError(
                f"slo[{self.tenant}]: deadline_s must be > 0, "
                f"got {self.deadline_s}")
        object.__setattr__(
            self, "windows_s",
            tuple(sorted(float(w) for w in self.windows_s)))

    @property
    def error_budget(self) -> float:
        return 1.0 - self.availability


def load_slo_specs(path: str) -> Dict[str, SLOSpec]:
    """Parse SLO specs from a JSON file: either a dedicated ``slo.json``
    (``{"slos": [...]}`` or a bare list) or a request manifest carrying
    a top-level ``"slos"`` key.  A request manifest without one returns
    ``{}`` (SLOs are opt-in).  Raises ``ValueError`` on a malformed
    spec or a duplicate tenant."""
    if not path:
        return {}
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        doc = doc.get("slos", [])
    if not isinstance(doc, list):
        raise ValueError(f"{path}: 'slos' must be a list")
    known = {f.name for f in dataclasses.fields(SLOSpec)}
    out: Dict[str, SLOSpec] = {}
    for i, item in enumerate(doc):
        if not isinstance(item, dict):
            raise ValueError(f"{path}: slo #{i} is not an object")
        unknown = set(item) - known
        if unknown:
            raise ValueError(
                f"{path}: slo #{i} has unknown fields {sorted(unknown)}")
        missing = {"tenant", "deadline_s"} - set(item)
        if missing:
            raise ValueError(
                f"{path}: slo #{i} missing fields {sorted(missing)}")
        kwargs = dict(item)
        if "windows_s" in kwargs:
            kwargs["windows_s"] = tuple(kwargs["windows_s"])
        spec = SLOSpec(**kwargs)
        if spec.tenant in out:
            raise ValueError(f"{path}: duplicate slo for tenant "
                             f"{spec.tenant!r}")
        out[spec.tenant] = spec
    return out


def sample_is_error(spec: SLOSpec, latency_s: float, verdict: str) -> bool:
    return verdict != "ok" or float(latency_s) > spec.deadline_s


def burn_rate(errors: int, total: int, error_budget: float) -> float:
    """``error_rate / budget``; 0 with no traffic (an idle tenant burns
    nothing)."""
    if total <= 0:
        return 0.0
    return (errors / float(total)) / max(error_budget, 1e-12)


class SLOMonitor:
    """Stateful burn-rate evaluator with alert edge semantics.

    ``observe()`` one (ts, latency, verdict) sample per completed
    request; ``evaluate()`` computes per-window burn rates and fires /
    clears ``slo_burn_alert`` events (and ``serve_slo_*`` gauges) on
    state *transitions* only, so the event stream carries edges rather
    than a line per request."""

    def __init__(self, specs: Dict[str, SLOSpec]):
        self.specs = dict(specs)
        self._samples: Dict[str, Deque[Tuple[float, bool]]] = {
            t: collections.deque() for t in self.specs}
        self._firing: Dict[str, bool] = {t: False for t in self.specs}

    @property
    def enabled(self) -> bool:
        return bool(self.specs)

    def observe(self, tenant: str, ts: float, latency_s: float,
                verdict: str) -> None:
        spec = self.specs.get(tenant)
        if spec is None:
            return
        self._samples[tenant].append(
            (float(ts), sample_is_error(spec, latency_s, verdict)))

    def _trim(self, tenant: str, now: float) -> None:
        horizon = now - self.specs[tenant].windows_s[-1]
        dq = self._samples[tenant]
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def evaluate(self, now: Optional[float] = None,
                 elog=None, registry=None) -> List[Dict[str, Any]]:
        """Burn status for every tenant with a spec; emits alert edges
        and gauges when ``elog``/``registry`` are given."""
        now = time.time() if now is None else float(now)
        out: List[Dict[str, Any]] = []
        for tenant, spec in self.specs.items():
            self._trim(tenant, now)
            status = evaluate_window_burns(
                spec, self._samples[tenant], now)
            was = self._firing[tenant]
            self._firing[tenant] = status["burning"]
            status["transition"] = (
                "firing" if status["burning"] and not was
                else "cleared" if was and not status["burning"]
                else None)
            if registry is not None:
                for w, b in zip(spec.windows_s, status["burn_rates"]):
                    registry.gauge_set(
                        "serve_slo_burn_rate", b, tenant=tenant,
                        window=f"{int(w)}s",
                        help="error-budget burn rate per trailing window")
                registry.gauge_set(
                    "serve_slo_error_budget_remaining",
                    status["budget_remaining"], tenant=tenant,
                    help="fraction of the long-window error budget left")
                registry.gauge_set(
                    "serve_slo_shed_recommended",
                    1.0 if status["shed_recommended"] else 0.0,
                    tenant=tenant,
                    help="1 while short-window burn exceeds shed_burn")
            if elog is not None and status["transition"] is not None:
                elog.emit("slo_burn_alert", tenant=tenant,
                          state=status["transition"],
                          burn_rates=status["burn_rates"],
                          windows_s=list(spec.windows_s),
                          alert_burn=spec.alert_burn,
                          deadline_s=spec.deadline_s,
                          availability=spec.availability,
                          shed_recommended=status["shed_recommended"])
            out.append(status)
        return out

    def shed_recommended(self, tenant: str,
                         now: Optional[float] = None) -> bool:
        """True while the tenant's short-window burn exceeds its
        ``shed_burn`` threshold.  ``now`` pins the evaluation instant
        (admission-control tests replay recorded sample streams)."""
        spec = self.specs.get(tenant)
        if spec is None:
            return False
        status = evaluate_window_burns(
            spec, self._samples[tenant],
            time.time() if now is None else float(now))
        return status["shed_recommended"]


def evaluate_window_burns(spec: SLOSpec,
                          samples: Iterable[Tuple[float, bool]],
                          now: float) -> Dict[str, Any]:
    """Pure multi-window burn evaluation over ``(ts, is_error)``
    samples (the post-hoc path ``diag serve`` uses on manifests)."""
    samples = list(samples)
    burns: List[float] = []
    counts: List[Tuple[int, int]] = []
    for w in spec.windows_s:
        sel = [e for ts, e in samples if ts >= now - w]
        errors = sum(1 for e in sel if e)
        counts.append((errors, len(sel)))
        burns.append(burn_rate(errors, len(sel), spec.error_budget))
    burning = bool(burns) and all(b >= spec.alert_burn for b in burns)
    long_errors, long_total = counts[-1] if counts else (0, 0)
    if long_total:
        budget_remaining = 1.0 - burn_rate(
            long_errors, long_total, spec.error_budget)
    else:
        budget_remaining = 1.0
    return {
        "tenant": spec.tenant,
        "windows_s": list(spec.windows_s),
        "burn_rates": burns,
        "window_counts": counts,
        "burning": burning,
        "budget_remaining": budget_remaining,
        "shed_recommended": bool(burns) and burns[0] >= spec.shed_burn,
        "deadline_s": spec.deadline_s,
        "availability": spec.availability,
    }


def evaluate_results(specs: Dict[str, SLOSpec],
                     results: Sequence[dict],
                     now: Optional[float] = None) -> List[Dict[str, Any]]:
    """Post-hoc SLO evaluation straight from result manifests (the
    ``diag serve`` path): samples are ``(completed_at, is_error)``
    per manifest; ``now`` defaults to the latest completion so archived
    runs evaluate the same way forever."""
    by_tenant: Dict[str, List[Tuple[float, bool]]] = {}
    tmax = 0.0
    for r in results:
        spec = specs.get(str(r.get("tenant")))
        if spec is None:
            continue
        ts = float(r.get("completed_at") or r.get("enqueued_at") or 0.0)
        tmax = max(tmax, ts)
        by_tenant.setdefault(spec.tenant, []).append(
            (ts, sample_is_error(spec, float(r.get("latency_s", 0.0)),
                                 str(r.get("verdict", "")))))
    now = tmax if now is None else float(now)
    out = []
    for tenant, spec in specs.items():
        out.append(evaluate_window_burns(
            spec, by_tenant.get(tenant, []), now))
    return out


def format_slo_report(evals: Sequence[Dict[str, Any]]) -> str:
    """Per-tenant SLO budget table for ``diag serve``."""
    if not evals:
        return "(no SLO specs)"
    lines = [f"{'tenant':<16s} {'deadline':>9s} {'avail':>7s} "
             f"{'burn(short)':>12s} {'burn(long)':>11s} "
             f"{'budget left':>12s}  status"]
    for ev in evals:
        burns = ev["burn_rates"]
        short = burns[0] if burns else 0.0
        long_ = burns[-1] if burns else 0.0
        status = "BURNING" if ev["burning"] else "ok"
        if ev["shed_recommended"]:
            status += " +SHED"
        lines.append(
            f"{ev['tenant']:<16s} {ev['deadline_s']:>8.3f}s "
            f"{ev['availability']:>6.2%} {short:>11.2f}x {long_:>10.2f}x "
            f"{max(ev['budget_remaining'], 0.0):>11.1%}  {status}")
    return "\n".join(lines)
