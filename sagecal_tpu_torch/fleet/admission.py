"""Admission control: act on the SLO burn rates the service reports (a
copy of ``sagecal_tpu/fleet/admission.py``, stdlib only).

The :class:`~sagecal_tpu_torch.obs.slo.SLOMonitor` computes multi-window
error-budget burn per tenant and raises ``shed_recommended`` while the
short-window burn exceeds the tenant's ``shed_burn`` threshold.  This
module is the actuator: each worker asks :meth:`AdmissionController.
decide` before solving a claimed request, and on overload the answer
is one of

- ``"shed"`` — refuse the request: no solve, a result manifest with
  ``verdict: "shed"`` so the tenant gets a definitive (cheap, fast)
  answer instead of a deadline miss that burns MORE budget;
- ``"degrade"`` — solve with reduced iteration budgets
  (``degrade_emiter``/``degrade_lbfgs``); the quality watchdog still
  verdicts the degraded solution, so a tenant can see exactly which
  results were produced under pressure (their manifests carry
  ``degraded: true``);
- ``"accept"`` — the normal path, bit-identical to the plain serve
  app (no knob is touched when no SLO is burning, and the policy
  ``"off"`` restores report-only behavior entirely).

Burn state is fed from the shared result-manifest directory: every
worker's completions are visible to every other worker's controller,
so the fleet converges on the same overload view without a central
scheduler (manifests are the ground truth, exactly as ``diag serve``
reads them post-hoc).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Set, Tuple

from sagecal_tpu_torch.obs.slo import SLOMonitor, SLOSpec

#: manifest verdict for requests refused by admission control
SHED_VERDICT = "shed"

POLICIES = ("shed", "degrade", "off")


class AdmissionController:
    """Per-worker admission decisions from fleet-wide SLO burn.

    ``ingest_results`` feeds completed-request manifests (local or
    scanned from the shared out_dir) into the monitor; ``decide``
    answers accept/degrade/shed for the next claimed request of a
    tenant.  Shed manifests are NOT fed back as burn samples: burn
    must reflect how the tenant's *solved* requests are doing, or
    shedding would hold its own trigger high and latch the tenant out
    forever.  With sheds excluded the loop is stable — overload blows
    deadlines, burn trips, sheds relieve the queue, solved-request
    latencies recover, the short window drains, admission resumes."""

    def __init__(self, specs: Dict[str, SLOSpec],
                 policy: str = "degrade",
                 degrade_emiter: int = 1, degrade_lbfgs: int = 4,
                 clock=time.time):
        if policy not in POLICIES:
            raise ValueError(
                f"overload policy {policy!r} not in {POLICIES}")
        self.policy = policy
        self.clock = clock  # injectable so burn windows are checkable
        self.degrade_emiter = int(degrade_emiter)
        self.degrade_lbfgs = int(degrade_lbfgs)
        self.monitor = SLOMonitor(specs)
        self._seen: Set[str] = set()
        self.decisions: Dict[str, int] = {
            "accept": 0, "degrade": 0, "shed": 0}

    @property
    def enabled(self) -> bool:
        return self.policy != "off" and self.monitor.enabled

    # -- burn-state feed ----------------------------------------------

    def ingest_results(self, results) -> int:
        """Feed result manifests (dicts) not seen before; returns how
        many were new.  Idempotent per request_id, so workers can
        rescan the whole shared out_dir every claim cycle."""
        new = 0
        for r in results:
            rid = str(r.get("request_id", ""))
            if not rid or rid in self._seen:
                continue
            self._seen.add(rid)
            if str(r.get("verdict", "")) == SHED_VERDICT:
                continue  # sheds don't burn (see class docstring)
            self.monitor.observe(
                str(r.get("tenant", "")),
                float(r.get("completed_at") or 0.0) or self.clock(),
                float(r.get("latency_s", 0.0)),
                str(r.get("verdict", "")))
            new += 1
        return new

    def ingest_dir(self, out_dir: str) -> int:
        from sagecal_tpu_torch.obs.aggregate import read_result_manifests

        return self.ingest_results(read_result_manifests(out_dir))

    # -- the decision --------------------------------------------------

    def decide(self, tenant: str, now: Optional[float] = None
               ) -> Tuple[str, Dict[str, Any]]:
        """(decision, detail) for one about-to-solve request.
        ``decision`` is ``"accept"`` | ``"degrade"`` | ``"shed"``;
        ``detail`` carries the burn status for the event log."""
        if not self.enabled:
            self.decisions["accept"] += 1
            return "accept", {}
        spec = self.monitor.specs.get(tenant)
        if spec is None:
            self.decisions["accept"] += 1
            return "accept", {}
        if self.monitor.shed_recommended(tenant, now=now):
            decision = "shed" if self.policy == "shed" else "degrade"
            self.decisions[decision] += 1
            return decision, {
                "policy": self.policy,
                "shed_burn": spec.shed_burn,
                "deadline_s": spec.deadline_s,
            }
        self.decisions["accept"] += 1
        return "accept", {}

    # -- actuation helpers --------------------------------------------

    def degrade_request(self, req_doc: Dict[str, Any]) -> Dict[str, Any]:
        """A copy of the request dict with iteration budgets clamped
        down to the degrade levels (never raised above what the
        request/service would have used)."""
        out = dict(req_doc)
        cur_em = out.get("max_emiter")
        out["max_emiter"] = self.degrade_emiter if cur_em is None \
            else min(int(cur_em), self.degrade_emiter)
        cur_lb = out.get("max_lbfgs")
        out["max_lbfgs"] = self.degrade_lbfgs if cur_lb is None \
            else min(int(cur_lb), self.degrade_lbfgs)
        return out

    def shed_result(self, item, out_dir: str,
                    detail: Dict[str, Any]) -> Dict[str, Any]:
        """Write the definitive refusal manifest for a shed request
        (marked seen locally so a later rescan doesn't re-ingest it)."""
        from sagecal_tpu_torch.serve.request import write_result_manifest

        now = self.clock()
        req = item.request
        result = {
            "request_id": item.request_id,
            "tenant": item.tenant,
            "dataset": req.get("dataset", ""),
            "t0": req.get("t0", 0), "tilesz": req.get("tilesz", 0),
            "verdict": SHED_VERDICT,
            "reasons": [f"slo_overload:shed_burn={detail.get('shed_burn')}"],
            "enqueued_at": item.enqueued_at,
            "started_at": now, "completed_at": now,
            "queue_wait_s": max(now - item.enqueued_at, 0.0),
            "latency_s": max(now - item.enqueued_at, 0.0),
            "trace_id": req.get("trace_id", "") or
            f"req-{item.request_id}",
        }
        write_result_manifest(out_dir, result)
        self.ingest_results([result])
        try:
            from sagecal_tpu_torch.obs.registry import get_registry

            get_registry().counter_inc(
                "serve_requests_shed_total", tenant=item.tenant,
                help="requests refused by admission control")
        except Exception:
            pass
        return result


def build_controller(cfg, requests_path: str = "") -> AdmissionController:
    """Controller from a FleetConfig: specs from ``cfg.slo`` or the
    request manifest's ``"slos"`` key, policy/budgets from the config."""
    import os

    from sagecal_tpu_torch.obs.slo import load_slo_specs

    specs: Dict[str, SLOSpec] = {}
    if getattr(cfg, "slo", ""):
        specs = load_slo_specs(cfg.slo)
    elif requests_path and os.path.exists(requests_path):
        specs = load_slo_specs(requests_path)
    return AdmissionController(
        specs, policy=getattr(cfg, "overload_policy", "degrade"),
        degrade_emiter=getattr(cfg, "degrade_emiter", 1),
        degrade_lbfgs=getattr(cfg, "degrade_lbfgs", 4))
