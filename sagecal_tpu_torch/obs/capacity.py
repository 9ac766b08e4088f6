"""Saturation analysis + autoscale recommendations for fleet load runs.

The load harness (fleet/loadgen.py) records offered-load ground truth
per step (``load_steps.json``), the coordinator samples the live
timeline (obs/timeline.py), and the workers write per-request result
manifests.  This module joins the three into the capacity picture ROADMAP
item 3 asks for:

- **throughput / goodput vs offered load** — per load step: served
  completions per second (shed and error manifests are dispositions,
  *not* served work) and the deadline-met subset (goodput);
- **knee detection** — the first offered-load step whose served
  throughput falls more than ``tol`` below the offered rate: below the
  knee the fleet keeps up, above it work queues or sheds;
- **shed rate under overload** — the fraction of the highest offered
  step's arrivals that ended shed, attributed by *arrival* step
  (under overload most sheds complete during the drain, after the
  last window — window attribution would read 0);
- **queue growth rate** — least-squares slope of the waiting depth;
- **Little's law cross-check** — for the waiting room, ``L = λW``
  must hold between three independently-measured views: L from the
  live timeline, L from the post-hoc manifest reconstruction
  (obs/aggregate.queue_depth_series), and λ·W from manifest counts
  and recorded queue waits.  Disagreement beyond tolerance means one
  of the observability paths is lying — that is the cross-check's
  whole point;
- **:class:`AutoscaleRecommender`** — a report-only controller fed
  one timeline row per poll.  It votes scale-up on sustained queue
  growth or SLO fast-burn, scale-down on sustained idleness, requires
  ``fire_samples`` consecutive votes before changing its
  recommendation (hysteresis), emits a ``scale_recommendation`` event
  on each change and mirrors the latest recommendation into an atomic
  ``recommended_workers.json``.  The file is advisory output with a
  single writer (the coordinator) — never read for coordination, so
  the PR-13 lease-protocol model is untouched; the optional
  ``--elastic-workers`` honor path acts on the in-memory value only.

Import-light (stdlib only; a copy of ``sagecal_tpu/obs/capacity.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

CAPACITY_SCHEMA_VERSION = 1

#: advisory recommendation mirror (single writer, atomic replace)
RECOMMENDED_WORKERS_FILE = "recommended_workers.json"

#: default knee tolerance: served throughput this far below offered is
#: "not keeping up"
KNEE_TOL = 0.10

#: knee absolute guard (requests): the shortfall must also be worth
#: this many whole requests over the step window, so one completion
#: spilling into the next window at a low offered rate (tiny counts)
#: cannot fire a false knee
KNEE_ABS_TOL = 2.0

#: verdicts that count as a disposition but NOT as served work
UNSERVED_VERDICTS = ("shed", "error")


def served_results(results: Sequence[dict]) -> List[dict]:
    """Manifests that represent actually-served work: sheds are the
    controller refusing work and errors are failed work — neither may
    count as served in any throughput/goodput view."""
    return [r for r in results
            if str(r.get("verdict", "")) not in UNSERVED_VERDICTS]


# ---------------------------------------------------------------------------
# offered-load steps + throughput/goodput curve


def load_steps(path_or_dir: str) -> Dict[str, Any]:
    """Read a ``load_steps.json`` (or the out-dir containing one)."""
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, "load_steps.json")
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "steps" not in doc:
        raise ValueError(f"{path}: not a load_steps document")
    return doc


def throughput_curve(steps: Sequence[dict], results: Sequence[dict],
                     specs=None) -> List[Dict[str, Any]]:
    """One row per offered-load step.  Completions are attributed to
    steps by ``completed_at`` (dispositions happen when they happen —
    a backlogged step can complete more than it offered); ``served``
    excludes sheds and errors; ``goodput`` is the served-ok subset
    whose latency met the tenant's deadline (requests of tenants
    without a spec count as good when the verdict is ok)."""
    specs = specs or {}
    rows: List[Dict[str, Any]] = []
    for step in steps:
        t0, t1 = float(step["t0"]), float(step["t1"])
        dur = max(t1 - t0, 1e-9)
        inwin = [r for r in results
                 if t0 <= float(r.get("completed_at") or 0.0) < t1]
        served = served_results(inwin)
        shed = sum(1 for r in inwin if r.get("verdict") == "shed")
        errors = sum(1 for r in inwin if r.get("verdict") == "error")
        good = 0
        for r in served:
            if str(r.get("verdict")) != "ok":
                continue
            spec = specs.get(str(r.get("tenant")))
            if spec is None or (float(r.get("latency_s", 0.0))
                                <= spec.deadline_s):
                good += 1
        dispositions = len(inwin)
        rows.append({
            "index": int(step.get("index", len(rows))),
            "t0": t0, "t1": t1, "duration_s": dur,
            "offered_rate": float(step.get("offered_rate", 0.0)),
            "arrivals": int(step.get("arrivals", 0)),
            "dispositions": dispositions,
            "served": len(served),
            "throughput": len(served) / dur,
            "goodput": good,
            "goodput_rate": good / dur,
            "goodput_fraction": good / max(len(served), 1),
            "shed": shed,
            "shed_rate": shed / max(dispositions, 1),
            "errors": errors,
        })
    rows.sort(key=lambda r: r["offered_rate"])
    return rows


def arrival_dispositions(doc: Dict[str, Any], results: Sequence[dict]
                         ) -> Dict[int, Dict[str, Any]]:
    """Per-step disposition mix attributed by ARRIVAL step: what
    happened to the load offered in step k, wherever it completed.
    The completion-window view (:func:`throughput_curve`) measures the
    fleet's service rate; this view measures each step's fate — under
    overload most of a step's sheds complete during the drain, after
    the last window, and a window-attributed shed rate would read 0.
    Keyed by ``submitted`` request_ids against the planned windows
    (scheduled offset ``t``, immune to submit jitter)."""
    steps = doc.get("steps") or []
    t_start = float(doc.get("t_start") or 0.0)
    step_of: Dict[str, int] = {}
    for a in doc.get("submitted") or []:
        t = t_start + float(a.get("t", 0.0))
        for s in steps:
            if float(s["t0"]) <= t < float(s["t1"]):
                step_of[str(a["request_id"])] = int(s["index"])
                break
    if not step_of:
        # no realized arrival record (synthetic fixture / killed run):
        # leave the curve's window attribution unmasked
        return {}
    mix: Dict[int, Dict[str, Any]] = {
        int(s["index"]): {"arrival_dispositions": 0,
                          "arrival_served": 0, "arrival_shed": 0,
                          "arrival_errors": 0, "arrival_shed_rate": 0.0}
        for s in steps}
    for r in results:
        idx = step_of.get(str(r.get("request_id")))
        if idx is None or idx not in mix:
            continue
        row = mix[idx]
        row["arrival_dispositions"] += 1
        verdict = str(r.get("verdict", ""))
        if verdict == "shed":
            row["arrival_shed"] += 1
        elif verdict == "error":
            row["arrival_errors"] += 1
        else:
            row["arrival_served"] += 1
    for row in mix.values():
        row["arrival_shed_rate"] = (
            row["arrival_shed"] / max(row["arrival_dispositions"], 1))
    return mix


def find_knee(curve: Sequence[dict], tol: float = KNEE_TOL,
              abs_tol: float = KNEE_ABS_TOL) -> Dict[str, Any]:
    """Locate the saturation knee on an offered-rate-sorted curve: the
    first step whose served throughput is more than ``tol`` below its
    offered rate AND whose shortfall is worth more than ``abs_tol``
    whole requests over the window (the absolute guard: at 0.5/s a
    single completion landing just past the window edge is 10% of the
    step — batching latency, not saturation).
    ``saturation_throughput`` is the best served rate observed
    anywhere on the curve (the capacity estimate)."""
    sat = max((r["throughput"] for r in curve), default=0.0)
    sat_row = None
    for r in curve:
        if r["throughput"] >= sat:
            sat_row = r
            break
    knee = None
    for r in curve:
        if r["offered_rate"] <= 0.0:
            continue
        planned = float(r.get("arrivals", 0)
                        or r["offered_rate"] * r["duration_s"])
        shortfall = planned - r["served"]
        if (r["throughput"] < (1.0 - tol) * r["offered_rate"]
                and shortfall > abs_tol):
            knee = r
            break
    return {
        "saturated": knee is not None,
        "knee_offered_rate": knee["offered_rate"] if knee else None,
        "knee_index": knee["index"] if knee else None,
        "saturation_throughput": sat,
        "saturation_index": sat_row["index"] if sat_row else None,
        "tol": tol,
    }


# ---------------------------------------------------------------------------
# waiting-depth series algebra (shared by Little + reconcile + growth)


def timeline_waiting_series(rows: Sequence[dict]) -> List[Tuple[float, float]]:
    """Live waiting-room depth over time: ``waiting + expired_leases``
    (an expired lease is an item back in the waiting room until it is
    stolen), absolute timestamps."""
    return [(float(r["ts"]),
             float(r.get("waiting", 0)) + float(r.get("expired_leases", 0)))
            for r in rows if "ts" in r]


def time_weighted_mean(series: Sequence[Tuple[float, float]],
                       t0: Optional[float] = None,
                       t1: Optional[float] = None) -> float:
    """Mean of a piecewise-constant series over [t0, t1] (defaults to
    the series' own span).  Each sample holds until the next one."""
    pts = sorted((float(t), float(v)) for t, v in series)
    if not pts:
        return 0.0
    t0 = pts[0][0] if t0 is None else float(t0)
    t1 = pts[-1][0] if t1 is None else float(t1)
    if t1 <= t0:
        return pts[-1][1]
    area = 0.0
    for i, (t, v) in enumerate(pts):
        nxt = pts[i + 1][0] if i + 1 < len(pts) else t1
        lo, hi = max(t, t0), min(nxt, t1)
        if hi > lo:
            area += v * (hi - lo)
    # before the first sample the depth is unknown: treat as 0 (queue
    # starts empty), which the [t0 >= first-sample] default avoids
    return area / (t1 - t0)


def slope(series: Sequence[Tuple[float, float]],
          t0: Optional[float] = None,
          t1: Optional[float] = None) -> float:
    """Least-squares slope (units/s) of a (t, value) series over the
    window; 0 with fewer than two points."""
    pts = [(float(t), float(v)) for t, v in series
           if (t0 is None or t >= t0) and (t1 is None or t <= t1)]
    if len(pts) < 2:
        return 0.0
    n = float(len(pts))
    mt = sum(t for t, _ in pts) / n
    mv = sum(v for _, v in pts) / n
    num = sum((t - mt) * (v - mv) for t, v in pts)
    den = sum((t - mt) ** 2 for t, _ in pts)
    return num / den if den > 0 else 0.0


def littles_law_check(timeline_rows: Sequence[dict],
                      results: Sequence[dict],
                      t0: Optional[float] = None,
                      t1: Optional[float] = None,
                      rtol: float = 0.35,
                      atol: float = 1.0) -> Dict[str, Any]:
    """Cross-check L = λW for the waiting room over [t0, t1].

    Three independent measurements must agree:

    - ``L_live``     — time-weighted mean waiting depth from the live
      timeline (sampled by the coordinator while the run happened);
    - ``L_posthoc``  — the same mean from the manifest reconstruction
      (+1 at ``enqueued_at``, -1 at ``started_at``);
    - ``lambda_w``   — λ·W from manifests alone: departures from the
      waiting room per second times the mean recorded queue wait.

    A view disagrees when it differs from λ·W by more than
    ``max(atol, rtol * max(L, λW))``."""
    from sagecal_tpu_torch.obs.aggregate import queue_depth_series

    starts = sorted(float(r["started_at"]) for r in results
                    if r.get("started_at") is not None)
    if t0 is None:
        t0 = starts[0] if starts else None
    if t1 is None:
        t1 = starts[-1] if starts else None
    inwin = [r for r in results
             if r.get("started_at") is not None
             and (t0 is None or float(r["started_at"]) >= t0)
             and (t1 is None or float(r["started_at"]) <= t1)]
    dur = (t1 - t0) if (t0 is not None and t1 is not None
                        and t1 > t0) else 0.0
    lam = len(inwin) / dur if dur > 0 else 0.0
    waits = [float(r.get("queue_wait_s", 0.0)) for r in inwin]
    w = sum(waits) / len(waits) if waits else 0.0
    lam_w = lam * w
    live = time_weighted_mean(
        timeline_waiting_series(timeline_rows), t0, t1)
    posthoc = time_weighted_mean(queue_depth_series(results), t0, t1)

    def _agrees(val: float) -> bool:
        return abs(val - lam_w) <= max(atol, rtol * max(val, lam_w))

    return {
        "t0": t0, "t1": t1, "duration_s": dur,
        "lambda_per_s": lam, "mean_wait_s": w, "lambda_w": lam_w,
        "L_live": live, "L_posthoc": posthoc,
        "live_ok": _agrees(live),
        "posthoc_ok": _agrees(posthoc),
        "ok": _agrees(live) and _agrees(posthoc),
        "rtol": rtol, "atol": atol,
    }


def reconcile_queue_views(timeline_rows: Sequence[dict],
                          results: Sequence[dict],
                          rtol: float = 0.25,
                          atol: float = 1.5) -> Dict[str, Any]:
    """Compare the live waiting-depth view against the post-hoc
    manifest reconstruction over their common window: time-weighted
    means and peaks must agree within tolerance.  This is the
    cross-check that caught the shed/served counting rules drifting
    between the two views."""
    from sagecal_tpu_torch.obs.aggregate import queue_depth_series

    live_series = timeline_waiting_series(timeline_rows)
    post_series = queue_depth_series(results)
    if not live_series or not post_series:
        return {"comparable": False,
                "reason": "missing live timeline or manifests",
                "ok": False}
    t0 = max(live_series[0][0], post_series[0][0])
    t1 = min(live_series[-1][0], post_series[-1][0])
    live_mean = time_weighted_mean(live_series, t0, t1)
    post_mean = time_weighted_mean(post_series, t0, t1)
    live_peak = max((v for t, v in live_series if t0 <= t <= t1),
                    default=0.0)
    post_peak = max((v for t, v in post_series if t0 <= t <= t1),
                    default=0.0)

    def _close(a: float, b: float) -> bool:
        return abs(a - b) <= max(atol, rtol * max(a, b))

    return {
        "comparable": True, "t0": t0, "t1": t1,
        "live_mean_depth": live_mean, "posthoc_mean_depth": post_mean,
        "live_peak_depth": live_peak, "posthoc_peak_depth": post_peak,
        "mean_ok": _close(live_mean, post_mean),
        "peak_ok": _close(live_peak, post_peak),
        "ok": _close(live_mean, post_mean) and _close(live_peak,
                                                      post_peak),
        "rtol": rtol, "atol": atol,
    }


# ---------------------------------------------------------------------------
# autoscale recommender (report-only controller)


@dataclasses.dataclass(frozen=True)
class RecommenderConfig:
    """Thresholds + hysteresis of the autoscale recommender."""

    min_workers: int = 1
    max_workers: int = 8
    #: sustained waiting-depth growth (items/s) that votes scale-up
    up_queue_growth: float = 0.05
    #: short-window SLO burn that votes scale-up (budget burning 2x)
    up_burn: float = 2.0
    #: waiting depth at or below this (with no growth and an idle
    #: worker) votes scale-down
    down_idle_waiting: int = 0
    #: consecutive same-direction votes before the recommendation moves
    fire_samples: int = 3
    #: trailing window the growth slope is fit over
    growth_window_s: float = 30.0


class AutoscaleRecommender:
    """Feed one timeline row per poll; emits a recommendation dict on
    each CHANGE of ``recommended_workers`` (None otherwise).

    Votes, not actions: scale-up when the waiting room grows faster
    than ``up_queue_growth`` with more waiters than live workers, or
    when any tenant's short-window burn reaches ``up_burn`` with a
    backlog; scale-down when the queue is idle (nothing waiting, no
    growth, at least one worker without an active lease).  A change
    requires ``fire_samples`` consecutive votes in the same direction
    and moves one worker at a time — the fire/clear hysteresis that
    keeps a noisy signal from flapping the fleet."""

    def __init__(self, cfg: RecommenderConfig, workers: int):
        self.cfg = cfg
        self.recommended = max(cfg.min_workers,
                               min(int(workers), cfg.max_workers))
        self._hist: List[Tuple[float, float]] = []
        self._up = 0
        self._down = 0
        self.last: Optional[Dict[str, Any]] = None

    def update(self, row: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        cfg = self.cfg
        ts = float(row.get("ts", 0.0))
        waiting = float(row.get("waiting", 0)) + float(
            row.get("expired_leases", 0))
        leased = float(row.get("leased", 0))
        alive = int(row.get("alive_workers", 0))
        burn = float(row.get("slo_burn_max_short", 0.0))
        self._hist.append((ts, waiting))
        horizon = ts - cfg.growth_window_s
        while self._hist and self._hist[0][0] < horizon:
            self._hist.pop(0)
        growth = slope(self._hist)
        utilization = leased / max(alive, 1)
        up_vote = ((growth > cfg.up_queue_growth and waiting > alive)
                   or (burn >= cfg.up_burn and waiting > 0))
        down_vote = (not up_vote
                     and waiting <= cfg.down_idle_waiting
                     and growth <= 0.0
                     and leased < max(alive, 1)
                     and burn < cfg.up_burn)
        if up_vote:
            self._up += 1
            self._down = 0
        elif down_vote:
            self._down += 1
            self._up = 0
        else:
            self._up = self._down = 0
        prev = self.recommended
        reason = None
        if self._up >= cfg.fire_samples and prev < cfg.max_workers:
            self.recommended = prev + 1
            reason = ("slo_burn" if burn >= cfg.up_burn
                      else "queue_growth")
            self._up = 0
        elif self._down >= cfg.fire_samples and prev > cfg.min_workers:
            self.recommended = prev - 1
            reason = "idle"
            self._down = 0
        if self.recommended == prev:
            return None
        rec = {
            "schema_version": CAPACITY_SCHEMA_VERSION,
            "ts": ts,
            "recommended_workers": self.recommended,
            "previous_workers": prev,
            "reason": reason,
            "signals": {
                "queue_growth_per_s": growth,
                "waiting": waiting,
                "leased": leased,
                "alive_workers": alive,
                "utilization": utilization,
                "slo_burn_max_short": burn,
            },
        }
        self.last = rec
        return rec


def write_recommendation(out_dir: str, rec: Dict[str, Any]) -> str:
    """Atomically mirror the latest recommendation (tmp + replace, so
    a reader never sees a torn file).  Advisory output only — nothing
    in the fleet protocol reads it back."""
    path = os.path.join(out_dir, RECOMMENDED_WORKERS_FILE)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def read_recommendation(out_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(out_dir, RECOMMENDED_WORKERS_FILE)
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


# ---------------------------------------------------------------------------
# the full report (diag load / loadgen / bench entry point)


def analyze_load_run(out_dir: str, specs=None,
                     knee_tol: float = KNEE_TOL,
                     littles_rtol: float = 0.35,
                     littles_atol: float = 1.0) -> Dict[str, Any]:
    """Join load_steps.json + timeline.jsonl + result manifests under
    ``out_dir`` into the capacity report: the curve, the knee, the
    banked headline metrics, the Little's-law cross-check, the
    live-vs-posthoc reconciliation, and the latest recommendation."""
    from sagecal_tpu_torch.obs.aggregate import read_result_manifests
    from sagecal_tpu_torch.obs.timeline import read_timeline, timeline_path

    doc = load_steps(out_dir)
    results = read_result_manifests(out_dir)
    rows = read_timeline(timeline_path(out_dir))
    curve = throughput_curve(doc["steps"], results, specs)
    mix = arrival_dispositions(doc, results)
    for r in curve:
        r.update(mix.get(r["index"], {}))
    knee = find_knee(curve, tol=knee_tol)
    overload = curve[-1] if curve else None
    sat_idx = knee.get("saturation_index")
    sat_row = next((r for r in curve if r["index"] == sat_idx), None)
    for r in curve:
        r["queue_growth_per_s"] = slope(
            timeline_waiting_series(rows), r["t0"], r["t1"])
    littles = littles_law_check(rows, results,
                                rtol=littles_rtol, atol=littles_atol)
    return {
        "schema_version": CAPACITY_SCHEMA_VERSION,
        "out_dir": os.path.abspath(out_dir),
        "seed": doc.get("seed"),
        "arrival": doc.get("arrival"),
        "steps": curve,
        "knee": knee,
        "saturation_throughput_solves_per_sec":
            knee["saturation_throughput"],
        # arrival-attributed: the fate of the load offered in the
        # highest step, wherever its dispositions completed (window
        # attribution would miss sheds landing during the drain)
        "shed_rate_under_overload":
            (overload.get("arrival_shed_rate", overload["shed_rate"])
             if overload else 0.0),
        "goodput_fraction_at_saturation":
            sat_row["goodput_fraction"] if sat_row else 0.0,
        "littles_law": littles,
        "reconcile": reconcile_queue_views(rows, results),
        "timeline_rows": len(rows),
        "manifests": len(results),
        "served": len(served_results(results)),
        "shed": sum(1 for r in results if r.get("verdict") == "shed"),
        "errors": sum(1 for r in results
                      if r.get("verdict") == "error"),
        "recommendation": read_recommendation(out_dir),
    }


def format_load_report(report: Dict[str, Any]) -> str:
    """Human-readable rendering for ``diag load``."""
    lines: List[str] = []
    lines.append(
        f"load run: {report['manifests']} manifests "
        f"({report['served']} served, {report['shed']} shed, "
        f"{report['errors']} errors), "
        f"{report['timeline_rows']} timeline samples")
    lines.append(
        f"{'step':>4s} {'offered/s':>10s} {'served':>7s} "
        f"{'thru/s':>8s} {'goodput':>8s} {'shed%':>6s} "
        f"{'growth/s':>9s}")
    for r in report["steps"]:
        lines.append(
            f"{r['index']:>4d} {r['offered_rate']:>10.3f} "
            f"{r['served']:>7d} {r['throughput']:>8.3f} "
            f"{r['goodput_fraction']:>7.1%} {r['shed_rate']:>5.1%} "
            f"{r['queue_growth_per_s']:>9.3f}")
    knee = report["knee"]
    if knee["saturated"]:
        lines.append(
            f"knee: saturates at offered {knee['knee_offered_rate']:.3f}"
            f"/s (step {knee['knee_index']}); capacity ≈ "
            f"{knee['saturation_throughput']:.3f} served/s")
    else:
        lines.append(
            f"knee: not reached (peak served "
            f"{knee['saturation_throughput']:.3f}/s kept up with "
            f"every offered step)")
    lines.append(
        f"shed under overload: "
        f"{report['shed_rate_under_overload']:.1%}; goodput at "
        f"saturation: {report['goodput_fraction_at_saturation']:.1%}")
    ll = report["littles_law"]
    lines.append(
        f"Little's law: λ={ll['lambda_per_s']:.3f}/s "
        f"W={ll['mean_wait_s']:.2f}s -> λW={ll['lambda_w']:.2f}; "
        f"L_live={ll['L_live']:.2f} "
        f"({'ok' if ll['live_ok'] else 'DISAGREES'}), "
        f"L_posthoc={ll['L_posthoc']:.2f} "
        f"({'ok' if ll['posthoc_ok'] else 'DISAGREES'})")
    rc = report["reconcile"]
    if rc.get("comparable"):
        lines.append(
            f"live vs post-hoc depth: mean {rc['live_mean_depth']:.2f}"
            f"/{rc['posthoc_mean_depth']:.2f}, peak "
            f"{rc['live_peak_depth']:.0f}/{rc['posthoc_peak_depth']:.0f}"
            f" -> {'reconciled' if rc['ok'] else 'MISMATCH'}")
    rec = report.get("recommendation")
    if rec:
        sig = rec.get("signals", {})
        lines.append(
            f"recommendation: {rec['recommended_workers']} workers "
            f"(was {rec.get('previous_workers')}, reason "
            f"{rec.get('reason')}, growth "
            f"{sig.get('queue_growth_per_s', 0.0):.3f}/s, burn "
            f"{sig.get('slo_burn_max_short', 0.0):.1f}x)")
    else:
        lines.append("recommendation: none recorded (report-only "
                     "recommender never fired)")
    return "\n".join(lines)
