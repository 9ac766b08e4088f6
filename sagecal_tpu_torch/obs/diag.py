"""``diag``: the port's observability command line (counterpart of
``sagecal_tpu/obs/diag.py``).

Every subcommand of the reference, with its output and exit codes on the
same input files, except where stated:

- ``manifest [--out FILE] [--kernel-path torch|fused]`` — this host's
  :class:`~sagecal_tpu_torch.obs.events.RunManifest` (the card when one
  is present, else the CPU); the port's manifest names torch and CUDA
  versions, and its kernel paths are ``torch`` and ``fused``.
- ``validate FILE``, ``events FILE``, ``prom [--events FILE]``,
  ``perf FILE_OR_DIR`` (the reference's tables, plus the port's kernel
  builds and per-row launch work), ``gate NEW --baseline BASE``
  (exit 2 on an evidence-class mismatch: a ``gpu-wallclock`` record
  never gates against ``tpu-wallclock`` pins), ``evidence [RECORD]``,
  ``quality FILE``, ``serve OUT_DIR...`` (``--bench-history`` or
  ``SAGECAL_BENCH_HISTORY`` names the history; the port reads none from
  the working directory by default), ``load``, ``drift``, ``trace``,
  ``flight``, ``protocol``, ``audit``, ``replay`` — as the reference.
- ``roofline TRACE [--events LOG] [--device-kind K] [--spans FILE]`` —
  a device profile (``obs/devprof.py``, Kineto's format) attributed to
  the kernel table's rows #1-#10, ``torch-op``, ``memcpy/memset`` and
  ``other``, joined with the per-launch work ledger of the event log's
  ``kernel_work`` events: per row its device ms, launches, ms a launch,
  bound a launch, bound over ms and share of device time, then the
  ``torch-op`` share and the device's idle share
  (``obs/roofline.py``).  The peak column is f32 (the port's kernels
  compute in exact f32).  ``--spans``: the run's span file, and the
  dispatch gaps' seconds by the innermost program span open over them.
  Exit 1 when the trace holds no device event.
- ``kernelcheck [--json] [--crosscheck]`` — the Hopper budget checker
  (``analysis/kernel_check.py``).
- ``lint [paths...] [--format json|text] [--baseline FILE] [--rules
  IDS]`` — the static-analysis gate (:mod:`sagecal_tpu_torch.analysis`):
  the JL rules re-aimed at the port's hazards, over the given paths
  (default: the installed ``sagecal_tpu_torch`` and its ``csrc/``,
  against ``analysis/lint_baseline.json``).  Exit 1 on new gate
  findings, 2 on a usage error (``--rules JL003`` names a rule with no
  counterpart).

Runs standalone (``python -m sagecal_tpu_torch.obs.diag ...``) or as the
``diag`` subcommand of the port's CLI (``apps/cli.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

from sagecal_tpu_torch.obs.events import (
    RunManifest,
    read_events,
    read_events_merged,
    validate_manifest,
)
from sagecal_tpu_torch.obs.perf import (
    GATE_DEFAULT_TOLERANCE,
    aggregate_perf_events,
    format_gate_report,
    format_perf_report,
    gate_compare,
)
from sagecal_tpu_torch.obs.registry import get_registry, telemetry


def _cmd_manifest(args) -> int:
    import torch

    m = RunManifest.collect(
        kernel_path=args.kernel_path,
        device="cuda" if torch.cuda.is_available() else "cpu")
    text = json.dumps(m.to_dict(), indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
        print(f"wrote manifest to {args.out}")
    else:
        print(text)
    return 0


def _load_manifest_dict(path: str) -> Optional[dict]:
    with open(path, "r", encoding="utf-8") as f:
        head = f.read()
    try:
        d = json.loads(head)
        if isinstance(d, dict):
            return d
    except json.JSONDecodeError:
        pass
    # fall back: a JSONL event log — take its run_manifest event
    for ev in read_events(path):
        if ev.get("type") == "run_manifest":
            return ev
    return None


def _cmd_validate(args) -> int:
    d = _load_manifest_dict(args.file)
    if d is None:
        print(f"{args.file}: no manifest found", file=sys.stderr)
        return 1
    problems = validate_manifest(d)
    if problems:
        for p in problems:
            print(f"{args.file}: {p}", file=sys.stderr)
        return 1
    print(
        f"{args.file}: valid manifest (run {d.get('run_id')}, "
        f"{d.get('platform')}/{d.get('device_kind')} x{d.get('num_devices')}, "
        f"kernel={d.get('kernel_path')})"
    )
    return 0


def _finite(xs) -> List[float]:
    out = []
    for x in xs:
        if isinstance(x, (int, float)) and x == x:
            out.append(float(x))
    return out


def _cmd_events(args) -> int:
    # merged read: picks up per-process suffixed companions
    # (SAGECAL_EVENT_LOG_PER_PROCESS=1 runs) alongside the base log
    evs = read_events_merged(args.file)
    if not evs:
        print(f"{args.file}: no events", file=sys.stderr)
        return 1
    by_type: dict = {}
    for e in evs:
        by_type[e.get("type", "?")] = by_type.get(e.get("type", "?"), 0) + 1
    runs = sorted({e.get("run_id", "?") for e in evs})
    ts = [e["ts"] for e in evs if isinstance(e.get("ts"), (int, float))]
    span = (max(ts) - min(ts)) if ts else 0.0
    print(f"{args.file}: {len(evs)} events, {len(runs)} run(s), "
          f"{span:.1f}s span")
    for t in sorted(by_type):
        print(f"  {t}: {by_type[t]}")
    # convergence digest: final cost per cluster record
    conv = [e for e in evs if e.get("type") == "cluster_convergence"]
    if conv:
        finals = []
        for e in conv:
            costs = _finite(e.get("cost", []))
            if costs:
                finals.append(costs[-1])
        if finals:
            print(f"  convergence: {len(conv)} cluster records, "
                  f"final cost min={min(finals):.4g} max={max(finals):.4g}")
    admm = [e for e in evs if e.get("type") == "admm_round"]
    if admm:
        last = admm[-1]
        pr = _finite(last.get("primal_res", []))
        dr = _finite(last.get("dual_res", []))
        if pr and dr:
            print(f"  admm: {len(admm)} rounds, last primal_res "
                  f"max={max(pr):.4g}, dual_res max={max(dr):.4g}")
    tiles = [e for e in evs if e.get("type") == "tile_done"]
    if tiles:
        secs = _finite(sum(_finite((e.get("phase_seconds") or {}).values()))
                       for e in tiles)
        tot = sum(secs) if secs else 0.0
        print(f"  tiles: {len(tiles)} done, {tot:.2f}s in phases")
    # elastic digest: checkpoint/resume lifecycle (elastic/)
    ckpts = [e for e in evs if e.get("type") == "checkpoint_written"]
    if ckpts:
        last = ckpts[-1]
        print(f"  checkpoints: {len(ckpts)} written, last "
              f"{last.get('path', '?')} (tile {last.get('tile_index', '?')})")
    for e in evs:
        if e.get("type") == "resume_started":
            print(f"  resume: started from {e.get('path', '?')} "
                  f"(tile {e.get('tile_index', '?')})")
        elif e.get("type") == "resume_refused":
            print(f"  resume: REFUSED - {e.get('mismatch', '?')} mismatch "
                  f"vs {e.get('path', '?')}")
    return 0


def _cmd_prom(args) -> int:
    with telemetry(True):
        reg = get_registry()
        if args.events:
            for e in read_events(args.events):
                if e.get("type") == "tile_done":
                    for phase, dt in (e.get("phase_seconds") or {}).items():
                        if isinstance(dt, (int, float)):
                            reg.observe("phase_seconds", float(dt),
                                        phase=str(phase))
                elif e.get("type") == "bench_result":
                    thr = e.get("value")
                    if isinstance(thr, (int, float)):
                        reg.gauge_set(
                            "bench_lbfgs_iters_per_second", float(thr),
                            kernel="fused" if e.get("fused_kernel")
                            else "xla",
                        )
        sys.stdout.write(reg.to_prometheus() or "# no metrics recorded\n")
    return 0


def _cmd_perf(args) -> int:
    import glob
    import os

    paths = [args.path]
    if os.path.isdir(args.path):
        paths = sorted(glob.glob(os.path.join(args.path, "*.jsonl")))
        if not paths:
            print(f"{args.path}: no *.jsonl event logs", file=sys.stderr)
            return 1
    evs: List[dict] = []
    for p in paths:
        evs.extend(read_events(p))
    agg = aggregate_perf_events(evs)
    print(format_perf_report(agg))
    if not agg["functions"]:
        # an empty attribution table means the run was not perf-observable
        # — fail so CI catches a silently un-instrumented pipeline
        return 1
    return 0


def _load_record(path: str) -> Optional[dict]:
    """A bench record: a JSON dict, or the last ``bench_result``-shaped
    line of a JSONL stream (bench.py prints one record per line)."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        d = json.loads(text)
        if isinstance(d, dict):
            return d
    except json.JSONDecodeError:
        pass
    rec = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(d, dict) and isinstance(d.get("value"), (int, float)):
            rec = d
    return rec


def _cmd_gate(args) -> int:
    new = _load_record(args.new)
    base = _load_record(args.baseline)
    if new is None or base is None:
        which = args.new if new is None else args.baseline
        print(f"{which}: no bench record found", file=sys.stderr)
        return 1
    from sagecal_tpu_torch.obs.evidence import metric_evidence, record_evidence
    from sagecal_tpu_torch.obs.perf import GATE_DEFAULT_METRICS

    # evidence refusal: a record proven one way must never gate
    # against pins proven another — the old platform-mismatch SKIP
    # (exit 0) let a CPU-fallback run silently "pass" the TPU gate.
    # REFUSE loudly instead; --strict still forces the comparison.
    ev_new, ev_base = record_evidence(new), record_evidence(base)
    if ev_new and ev_base and ev_new != ev_base and not args.strict:
        print(f"gate: REFUSED — evidence-class mismatch (new {ev_new} "
              f"vs baseline {ev_base}): a {ev_new} measurement cannot "
              f"prove or regress a {ev_base} claim; re-bench on matching "
              f"hardware, or rerun with --strict to force the comparison",
              file=sys.stderr)
        return 2
    tolerances = {}
    for spec in args.metric or []:
        name, _, tol = spec.partition("=")
        try:
            tolerances[name] = float(tol) if tol else args.tol
        except ValueError:
            print(f"bad --metric spec: {spec!r} (want name=tol)",
                  file=sys.stderr)
            return 2
    # per-metric refusal: satellite metrics carry their own class in
    # the `evidence_classes` override map (an aot-hlo bytes row rides a
    # tpu-wallclock headline); drop — with a printed note — any metric
    # whose classes resolve on both sides and differ
    names = list(GATE_DEFAULT_METRICS)
    for extra in tolerances:
        if extra not in names:
            names.append(extra)
    kept = []
    for m in names:
        a, b = metric_evidence(new, m), metric_evidence(base, m)
        if a and b and a != b and not args.strict:
            if m in new and m in base:
                print(f"gate: metric {m} excluded — evidence-class "
                      f"mismatch ({a} vs baseline {b})")
            tolerances.pop(m, None)
            continue
        kept.append(m)
    failures, rows = gate_compare(new, base, tolerances=tolerances,
                                  default_tol=args.tol,
                                  metrics=tuple(kept))
    print(format_gate_report(rows, failures))
    for fail in failures:
        print(f"REGRESSION: {fail}", file=sys.stderr)
    if not rows:
        # nothing comparable is itself a failure: the gate must never
        # silently pass because a record lost its metrics
        return 1
    return 1 if failures else 0


def _trace_device_kind(path: str) -> Optional[str]:
    """The device a Kineto trace ran on: its ``deviceProperties``' first
    name, ``cpu`` for a trace of a run without a GPU."""
    from sagecal_tpu_torch.obs.devprof import _read_doc

    props = _read_doc(path).get("deviceProperties") or []
    if props:
        return props[0].get("name")
    return None


def roofline_report(path: str, events: Optional[str] = None,
                    device_kind: Optional[str] = None,
                    gap_threshold_us: float = 1000.0,
                    dtype: str = "f32",
                    spans: Optional[str] = None) -> Tuple[dict, dict]:
    """``diag roofline``'s report of one trace file: (report, the
    trace's attribution); ``spans`` the run's span file."""
    from sagecal_tpu_torch.obs.devprof import (
        attribute_trace, ledger_from_events,
    )
    from sagecal_tpu_torch.obs.roofline import build_report

    from sagecal_tpu_torch.obs.trace import read_spans

    attribution = attribute_trace(
        path, gap_threshold_us=gap_threshold_us,
        program_spans=read_spans(spans) if spans else None)
    ledger = ledger_from_events(events) if events else {}
    kind = device_kind or _trace_device_kind(path) or (
        "cpu" if not attribution["gpu"] else None)
    return build_report(attribution, ledger, kind, dtype=dtype), attribution


def _cmd_roofline(args) -> int:
    from sagecal_tpu_torch.obs.devprof import newest_trace_path
    from sagecal_tpu_torch.obs.roofline import (
        format_report,
        set_kernel_gauges,
    )

    path = args.trace
    if os.path.isdir(path):
        found = newest_trace_path(path)
        if not found:
            print(f"{path}: no *.trace.json[.gz] under it — was the "
                  f"capture armed (SAGECAL_DEVICE_PROFILE / "
                  f"--device-profile)?", file=sys.stderr)
            return 1
        path = found
    try:
        report, attribution = roofline_report(
            path, args.events, args.device_kind, args.gap_threshold_us,
            args.dtype, args.spans)
    except (OSError, ValueError) as e:
        print(f"{path}: {e}", file=sys.stderr)
        return 1
    if not attribution["n_op_events"]:
        print(f"{path}: no device events (ph=X of cat kernel, gpu_memcpy "
              f"or gpu_memset; cpu_op on a run without a GPU) — not a "
              f"device-profile trace?", file=sys.stderr)
        return 1
    set_kernel_gauges(report)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True, default=float))
    else:
        print(f"trace: {path}")
        print(format_report(report))
    return 0


def _cmd_evidence(args) -> int:
    from sagecal_tpu_torch.obs.evidence import (
        is_valid,
        metric_evidence,
        proof_kind,
        record_evidence,
    )
    from sagecal_tpu_torch.obs.perf import (
        GATE_DEFAULT_METRICS,
        GATE_HIGHER_BETTER,
        GATE_LOWER_BETTER,
        read_bench_history,
    )

    rec = _load_record(args.record)
    if rec is None:
        print(f"{args.record}: no bench record found", file=sys.stderr)
        return 1
    # the banked claims = every gate-able metric present in the record
    # (gate direction tables + defaults); config fields like
    # serve_batch_width are not claims and carry no class
    names = []
    for m in (*GATE_HIGHER_BETTER, *GATE_LOWER_BETTER,
              *GATE_DEFAULT_METRICS):
        if m in rec and m not in names:
            names.append(m)
    rc = 0
    ev_rec = record_evidence(rec)
    print(f"{args.record}: record-level evidence "
          f"{ev_rec or 'UNCLASSIFIED'}")
    w = max((len(m) for m in names), default=8) + 2
    print(f"{'metric':<{w}}{'value':>14}  {'evidence':<15}proof")
    counts = {}
    for m in names:
        ev = metric_evidence(rec, m)
        kind = proof_kind(ev)
        counts[kind] = counts.get(kind, 0) + 1
        v = rec.get(m)
        vs = f"{v:>14.6g}" if isinstance(v, (int, float)) \
            and not isinstance(v, bool) else f"{str(v):>14}"
        print(f"{m:<{w}}{vs}  {ev or 'UNCLASSIFIED':<15}{kind}")
        if not is_valid(ev):
            rc = 1
    # an evidence_classes override naming an unknown class is a bug in
    # the producer, not a missing stamp — flag it too
    for m, ev in (rec.get("evidence_classes") or {}).items():
        if not is_valid(ev):
            print(f"EVIDENCE: override {m}={ev!r} is not a known class",
                  file=sys.stderr)
            rc = 1
    summary = ", ".join(f"{n} {k}" for k, n in sorted(counts.items()))
    print(f"claims: {summary or 'none'}")
    if args.history:
        rows = read_bench_history(args.history)
        unclassified = sum(1 for r in rows if record_evidence(r) is None)
        print(f"{args.history}: {len(rows)} rows, "
              f"{unclassified} unclassified")
        if unclassified:
            print(f"EVIDENCE: {unclassified} history rows carry no "
                  f"resolvable evidence class — stamp their "
                  f"evidence field", file=sys.stderr)
            rc = 1
    if rc:
        print("EVIDENCE: unclassified claims present", file=sys.stderr)
    return rc


def _cmd_quality(args) -> int:
    import os

    from sagecal_tpu_torch.obs.quality import (
        analyze_events,
        write_baseline_heatmap,
        write_station_heatmap,
    )

    evs = read_events(args.file)
    if not evs:
        print(f"{args.file}: no events", file=sys.stderr)
        return 1
    report = analyze_events(evs, trend_thresh=args.trend_thresh)

    out_dir = args.out_dir or os.path.dirname(os.path.abspath(args.file))
    os.makedirs(out_dir, exist_ok=True)
    images = {}
    if report["station_matrix"] is not None:
        p = os.path.join(out_dir, "station_chi2.ppm")
        write_station_heatmap(report["station_matrix"], p)
        images["station_chi2"] = p
    if report["baseline_total"] is not None:
        p = os.path.join(out_dir, "baseline_chi2.ppm")
        write_baseline_heatmap(report["baseline_total"], p)
        images["baseline_chi2"] = p

    json_report = {
        k: v for k, v in report.items()
        if k not in ("station_matrix", "baseline_total")
    }
    json_report["images"] = images
    # arrays inside solves/consensus entries were already listified by
    # analyze_events / the event log round-trip
    rp = os.path.join(out_dir, "quality_report.json")
    with open(rp, "w", encoding="utf-8") as f:
        json.dump(json_report, f, indent=2, sort_keys=True, default=float)
        f.write("\n")

    verdict = ("DIVERGED" if report["diverged"]
               else "DEGRADED" if report["degraded"] else "OK")
    print(f"{args.file}: quality {verdict} "
          f"({report['n_solve_quality_events']} solve_quality events, "
          f"{len(report['consensus'])} consensus rounds)")
    for r in report["reasons"]:
        print(f"  {r}")
    for name, p in images.items():
        print(f"  {name} -> {p}")
    print(f"  report -> {rp}")
    if report["diverged"]:
        return 1
    if args.fail_degraded and report["degraded"]:
        return 1
    return 0


def _fmt_bound(b) -> str:
    lo, hi = b
    return f"[{lo:.3g}, {hi:.3g}]"


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    import math

    rank = min(len(sorted_vals),
               max(1, math.ceil(q * len(sorted_vals) - 1e-9)))
    return sorted_vals[rank - 1]


def _cmd_serve(args) -> int:
    """Fleet-view serve report: per-tenant/per-bucket latency tables
    (exact percentiles from manifests + merged-histogram bounds), cache
    hit ratio, queue-depth timeline, lifecycle completeness, SLO budget
    status and bench trends.  Exit 1 on a burning SLO, an incomplete
    lifecycle (when spans were provided), or nothing to report."""
    from sagecal_tpu_torch.obs.aggregate import (
        fleet_view,
        lifecycle_report,
        queue_depth_timeline,
        quantile_bounds_from_state,
        state_counter_total,
        state_label_values,
    )
    from sagecal_tpu_torch.obs.perf import (
        bench_trend,
        format_bench_trend,
        read_bench_history,
    )
    from sagecal_tpu_torch.obs.slo import (
        evaluate_results,
        format_slo_report,
        load_slo_specs,
    )

    out_dirs = list(args.out_dir)
    view = fleet_view(
        out_dirs,
        event_paths=args.events or (),
        span_paths=args.spans or (),
    )
    results = view["results"]
    state = view["state"]
    if not results and not state.get("counters"):
        print("no result manifests or metric snapshots under: "
              + ", ".join(out_dirs), file=sys.stderr)
        return 1
    rc = 0
    print(f"serve fleet view: {len(results)} requests, "
          f"{view['snapshots']} worker snapshot(s), "
          f"{len(view['spans'])} spans")

    # -- per-tenant latency table: exact from manifests, bounds from
    # the merged cross-process histograms
    by_tenant: dict = {}
    for r in results:
        by_tenant.setdefault(str(r.get("tenant", "?")), []).append(r)
    qs = (0.5, 0.95, 0.99)
    print("\nper-tenant latency (exact from manifests; [lo, hi] = "
          "merged-histogram quantile bounds):")
    print(f"{'tenant':<16s}{'n':>5s}{'ok':>5s}{'div':>5s}"
          f"{'p50':>9s}{'p95':>9s}{'p99':>9s}  histogram bounds")
    tenants = sorted(set(by_tenant)
                     | set(state_label_values(
                         state, "serve_request_latency_seconds",
                         "tenant")))
    for t in tenants:
        rs = by_tenant.get(t, [])
        lats = sorted(float(r.get("latency_s", 0.0)) for r in rs)
        ok = sum(1 for r in rs if r.get("verdict") == "ok")
        bounds = quantile_bounds_from_state(
            state, "serve_request_latency_seconds", qs, tenant=t)
        btxt = " ".join(
            f"p{int(q * 100)}={_fmt_bound(bounds[q])}"
            for q in qs if q in bounds) or "(no snapshot)"
        print(f"{t:<16s}{len(rs):>5d}{ok:>5d}{len(rs) - ok:>5d}"
              f"{_percentile(lats, 0.5):>9.3f}"
              f"{_percentile(lats, 0.95):>9.3f}"
              f"{_percentile(lats, 0.99):>9.3f}  {btxt}")

    # -- per-bucket table + cache hit ratio
    by_bucket: dict = {}
    for r in results:
        by_bucket.setdefault(str(r.get("bucket", "?")), []).append(r)
    if by_bucket:
        print("\nper-bucket:")
        print(f"{'bucket':<28s}{'n':>5s}{'p50_s':>9s}{'max_s':>9s}"
              "  kernel_path")
        for b in sorted(by_bucket):
            lats = sorted(float(r.get("latency_s", 0.0))
                          for r in by_bucket[b])
            # which kernel actually solved this bucket's requests —
            # stamped per manifest by the service (the capability
            # check is per (bucket, fingerprint), so mixed values
            # here mean the bucket re-routed mid-run)
            paths = sorted({str(r.get("kernel_path", "?"))
                            for r in by_bucket[b]})
            print(f"{b:<28s}{len(lats):>5d}"
                  f"{_percentile(lats, 0.5):>9.3f}{lats[-1]:>9.3f}"
                  f"  {'+'.join(paths)}")
    hits = state_counter_total(
        state, "serve_executable_cache_hits_total")
    misses = state_counter_total(
        state, "serve_executable_cache_misses_total")
    if hits or misses:
        total = hits + misses
        print(f"\nexecutable cache: {hits:g} hits / {misses:g} misses "
              f"({hits / total:.1%} hit ratio, fleet-wide)")
    aot = {k: state_counter_total(
        state, f"serve_executable_cache_aot_{k}_total")
        for k in ("hits", "misses", "errors", "saves")}
    if any(aot.values()):
        print(f"AOT artifact store: {aot['hits']:g} loads / "
              f"{aot['saves']:g} saves / {aot['misses']:g} misses / "
              f"{aot['errors']:g} bad artifacts (recompiled)")

    # -- fleet lease queue (auto-detected <out_dir>/queue, the fleet
    # coordinator's default layout): claim/steal health at a glance
    for d in out_dirs:
        qdir = os.path.join(d, "queue")
        if not os.path.isdir(qdir):
            continue
        from sagecal_tpu_torch.fleet.queue import LeaseQueue

        q = LeaseQueue(qdir, worker="diag")
        st = q.stats()
        fails = sum(q.failure_count(i.request_id) for i in q.items())
        print(f"\nlease queue {qdir}: {st['done']}/{st['items']} done, "
              f"{st['leased']} live leases, "
              f"{st['expired_leases']} expired leases (stealable), "
              f"{fails} failure markers")
        if st["expired_leases"]:
            for it in q.pending():
                lease = q.read_lease(it.request_id)
                if lease is not None:
                    print(f"  EXPIRED: {it.request_id} held by "
                          f"{lease.get('worker', '?')}")

    # -- queue-depth timeline from manifests alone
    line = queue_depth_timeline(results, max_points=args.timeline_points)
    if line:
        peak = max(d for _, d in line)
        print(f"\nqueue depth timeline (from manifests; peak {peak}):")
        width = 40
        for t, d in line:
            bar = "#" * int(width * d / max(peak, 1))
            print(f"  t+{t:8.2f}s {d:>4d} {bar}")

    # -- lifecycle completeness (when spans are available)
    if view["spans"]:
        lr = lifecycle_report(view["spans"], results)
        print(f"\nlifecycle traces: {lr['complete']}/{lr['traces']} "
              f"complete ({lr['compile_traces']} compile, "
              f"{lr['cache_hit_traces']} cache-hit), "
              f"{lr['manifests_matched']}/{lr['manifests_with_trace']} "
              f"manifests matched to a complete trace")
        for p in lr["manifest_problems"][:10]:
            print(f"  INCOMPLETE: {p}")
        if not lr["ok"]:
            rc = 1

    # -- SLO budget status (burning -> nonzero exit, mirroring
    # `diag quality`'s divergence verdict)
    specs = {}
    if args.slo:
        specs = load_slo_specs(args.slo)
    if specs:
        evals = evaluate_results(specs, results)
        print("\nSLO budget status:")
        print(format_slo_report(evals))
        for ev in evals:
            if ev["burning"]:
                print(f"SLO BURNING: tenant {ev['tenant']} burn rates "
                      f"{['%.2f' % b for b in ev['burn_rates']]} over "
                      f"windows {ev['windows_s']}s", file=sys.stderr)
                rc = 1

    # -- bench trend over the last K history rows
    hist = read_bench_history(args.bench_history)
    if hist:
        trend = bench_trend(hist, last_k=args.last_k)
        print(f"\nbench trend (last {args.last_k} comparable of "
              f"{len(hist)} runs):")
        print(format_bench_trend(trend))
        # surface what the evidence filter dropped: silence here is how
        # CPU-fallback rows used to pass as TPU trend
        from sagecal_tpu_torch.obs.evidence import comparable, record_evidence

        ev_new = record_evidence(hist[-1])
        fp = hist[-1].get("config_fingerprint")
        excluded = sum(1 for r in hist
                       if r.get("config_fingerprint") == fp
                       and not comparable(record_evidence(r), ev_new))
        if excluded:
            print(f"(evidence filter: {excluded} same-config rows "
                  f"excluded — evidence class differs from newest "
                  f"[{ev_new}])")

    if args.report:
        doc = {
            "requests": len(results),
            "snapshots": view["snapshots"],
            "tenants": {
                t: {
                    "n": len(by_tenant.get(t, [])),
                    "ok": sum(1 for r in by_tenant.get(t, [])
                              if r.get("verdict") == "ok"),
                }
                for t in tenants
            },
            "cache": {"hits": hits, "misses": misses},
            "slo": evaluate_results(specs, results) if specs else [],
            "exit": rc,
        }
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True, default=float)
            f.write("\n")
        print(f"\nreport -> {args.report}")
    print("\nSERVE: " + ("UNHEALTHY" if rc else "OK"))
    return rc


def _cmd_load(args) -> int:
    """Load/capacity report of one ``load`` out-dir:
    curve + knee + shed + Little's-law cross-check + recommendation.
    Exit 1 on a missing/invalid timeline or a failed cross-check."""
    from sagecal_tpu_torch.obs.capacity import (
        analyze_load_run, format_load_report,
    )
    from sagecal_tpu_torch.obs.slo import load_slo_specs
    from sagecal_tpu_torch.obs.timeline import (
        read_timeline, timeline_path, validate_timeline,
    )

    out_dir = args.out_dir
    specs = {}
    slo = args.slo or os.path.join(out_dir, "workload", "slo.json")
    if os.path.exists(slo):
        specs = load_slo_specs(slo)
    rc = 0
    rows = read_timeline(timeline_path(out_dir))
    problems = validate_timeline(rows)
    if problems:
        print(f"timeline {timeline_path(out_dir)}: INVALID",
              file=sys.stderr)
        for p in problems[:10]:
            print(f"  {p}", file=sys.stderr)
        rc = 1
    try:
        report = analyze_load_run(
            out_dir, specs, knee_tol=args.knee_tol,
            littles_rtol=args.littles_rtol,
            littles_atol=args.littles_atol)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"{out_dir}: {e}", file=sys.stderr)
        return 1
    print(format_load_report(report))
    if not report["littles_law"]["ok"]:
        print("LITTLES-LAW CROSS-CHECK FAILED: live timeline, "
              "post-hoc reconstruction and λW disagree beyond "
              "tolerance", file=sys.stderr)
        rc = 1
    if report["reconcile"].get("comparable") \
            and not report["reconcile"]["ok"]:
        print("LIVE/POST-HOC DEPTH MISMATCH: the two queue-depth "
              "views disagree beyond tolerance", file=sys.stderr)
        rc = 1
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, sort_keys=True,
                      default=float)
            f.write("\n")
        print(f"report -> {args.report}")
    print("LOAD: " + ("UNHEALTHY" if rc else "OK"))
    return rc


def _cmd_drift(args) -> int:
    """Numerical-drift report of serve/fleet out-dirs: per-(path-pair,
    bucket, dtype) shadow-audit distributions with provable quantile
    bounds against the central tolerance policy.  Exit 1 on any
    tolerance breach or structural ledger problem; exit 0 with a
    warning when no samples exist (shadow auditing off)."""
    from sagecal_tpu_torch.obs.drift import analyze_drift, format_drift_report
    from sagecal_tpu_torch.obs.shadow import (
        drift_path, read_drift, validate_drift,
    )

    rows = []
    for d in args.out_dir:
        path = d if os.path.isfile(d) else drift_path(d)
        rows.extend(read_drift(path))
    rows.sort(key=lambda r: float(r.get("ts", 0.0)))
    rc = 0
    problems = validate_drift(rows) if rows else []
    if problems:
        print("drift ledger: INVALID", file=sys.stderr)
        for p in problems[:10]:
            print(f"  {p}", file=sys.stderr)
        rc = 1
    report = analyze_drift(rows, validate_problems=problems)
    for line in format_drift_report(report):
        print(line)
    if report["n_exceeded"]:
        rc = 1
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, sort_keys=True,
                      default=float)
            f.write("\n")
        print(f"report -> {args.report}")
    if not rows:
        # no samples is WARN-not-fail: a rate-0 run has nothing to
        # gate, and failing would force shadow auditing on everyone
        print("DRIFT: NO SAMPLES (warn)")
        return 0
    print("DRIFT: " + ("EXCEEDED" if rc else "OK"))
    return rc


def _cmd_trace(args) -> int:
    from sagecal_tpu_torch.obs.trace import (
        format_trace_report,
        read_spans,
        write_chrome_trace,
    )

    try:
        spans = read_spans(args.file)
    except OSError as e:
        print(f"{args.file}: {e}", file=sys.stderr)
        return 1
    if not spans:
        print(f"{args.file}: no spans (was the run SAGECAL_TRACE=1?)",
              file=sys.stderr)
        return 1
    print(format_trace_report(spans, ratio_thresh=args.straggler_ratio))
    if args.chrome:
        p = write_chrome_trace(spans, args.chrome)
        print(f"chrome trace -> {p}")
    return 0


def _cmd_flight(args) -> int:
    from sagecal_tpu_torch.obs.flight import format_dump, read_dump

    try:
        doc = read_dump(args.file)
    except (OSError, json.JSONDecodeError) as e:
        print(f"{args.file}: {e}", file=sys.stderr)
        return 1
    if not isinstance(doc, dict) or "reason" not in doc:
        print(f"{args.file}: not a flight-recorder dump", file=sys.stderr)
        return 1
    print(format_dump(doc, ring_tail=args.ring_tail))
    return 0


def _cmd_lint(args) -> int:
    # the lint package is import-light by design (stdlib ast only)
    from sagecal_tpu_torch.analysis.cli import main as lint_main

    return lint_main(args.lint_args)


def _cmd_kernelcheck(args) -> int:
    # lazy: the checker is stdlib-only unless --crosscheck builds the
    # kernels and profiles them on the card
    from sagecal_tpu_torch.analysis.kernel_check import main as kc_main

    return kc_main(args.kernelcheck_args)


def _cmd_protocol(args) -> int:
    """Exhaustively model-check the fleet lease/stream protocols
    (real queue + owner-lease code over the simulated fs).  Exit 0
    when every invariant holds on every reachable state, 1 on any
    violation (with the shortest counterexample trace printed)."""
    from sagecal_tpu_torch.analysis.protocol_check import run_protocol_check

    report = run_protocol_check(
        workers=args.workers, crash_budget=args.crashes,
        tick_budget=args.ticks, deadline_s=args.deadline,
        log=print)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    if not report["ok"]:
        return 1
    return 0


def _cmd_audit(args) -> int:
    """Event-sourced fleet audit: schema-registry validation, replay,
    conservation-law checks.  Exit 0 clean / 1 violation or gap / 2
    insufficient records (nothing to conserve)."""
    from sagecal_tpu_torch.obs.audit import format_audit, run_audit

    report = run_audit(
        args.out_dir, events_path=args.events, queue_dir=args.queue,
        max_skew_s=args.max_skew, slack_s=args.slack,
        inject=args.inject)
    if args.json:
        print(json.dumps(report.to_doc(), indent=2, sort_keys=True))
    else:
        print(format_audit(report, verbose=args.verbose))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report.to_doc(), f, indent=2, sort_keys=True)
        print(f"audit report -> {args.report}")
    return report.exit_code()


def _cmd_replay(args) -> int:
    """Deterministic fleet replay from records alone (no live state).
    Exit 2 when there is nothing to replay."""
    from sagecal_tpu_torch.obs.replay import format_replay, load_run, replay

    rec = load_run(args.out_dir, events_path=args.events,
                   queue_dir=args.queue)
    if not rec.items and not rec.manifests and not rec.events:
        print(f"{args.out_dir}: no replayable records "
              "(no queue items, manifests, or events)", file=sys.stderr)
        return 2
    state = replay(rec)
    if args.json:
        print(json.dumps(state.to_doc(), indent=2, sort_keys=True))
    else:
        print(format_replay(state, verbose=args.verbose))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(state.to_doc(), f, indent=2, sort_keys=True)
        print(f"replay state -> {args.report}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.apps.cli diag",
        description="observability diagnostics (manifests, event logs, "
                    "Prometheus export)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    mp = sub.add_parser("manifest", help="collect + print a run manifest")
    mp.add_argument("--out", default=None, help="write JSON here instead of stdout")
    mp.add_argument("--kernel-path", default="torch",
                    choices=("torch", "fused"))
    mp.set_defaults(fn=_cmd_manifest)

    vp = sub.add_parser("validate", help="validate a manifest JSON / event log")
    vp.add_argument("file")
    vp.set_defaults(fn=_cmd_validate)

    ep = sub.add_parser("events", help="summarize a JSONL event log")
    ep.add_argument("file")
    ep.set_defaults(fn=_cmd_events)

    pp = sub.add_parser("prom", help="Prometheus text dump of the registry")
    pp.add_argument("--events", default=None,
                    help="re-ingest phase timings from this event log first")
    pp.set_defaults(fn=_cmd_prom)

    fp = sub.add_parser(
        "perf", help="per-function compile/flops/bytes/memory attribution")
    fp.add_argument("path",
                    help="JSONL event log, or a run directory of *.jsonl")
    fp.set_defaults(fn=_cmd_perf)

    gp = sub.add_parser("gate", help="bench regression gate vs a baseline")
    gp.add_argument("new", help="fresh bench JSON record")
    gp.add_argument("--baseline", required=True,
                    help="pinned baseline bench JSON record")
    gp.add_argument("--tol", type=float, default=GATE_DEFAULT_TOLERANCE,
                    help="default relative tolerance (default 0.10)")
    gp.add_argument("--metric", action="append", default=None,
                    metavar="NAME=TOL",
                    help="gate an extra metric (repeatable), e.g. "
                         "analytic_tflops_per_sec=0.15")
    gp.add_argument("--strict", action="store_true",
                    help="compare even across an evidence-class mismatch")
    gp.set_defaults(fn=_cmd_gate)

    rp = sub.add_parser(
        "roofline",
        help="per-kernel-family roofline attribution from a device-"
             "profile trace (devprof capture)",
    )
    rp.add_argument("trace",
                    help="a *.trace.json[.gz] file, or a capture dir "
                         "(newest trace under it is used)")
    rp.add_argument("--events", default=None,
                    help="JSONL event log whose kernel_work events "
                         "supply the per-launch work ledger (bounds)")
    rp.add_argument("--device-kind", default=None,
                    help="override the device kind (default: the "
                         "trace's deviceProperties name)")
    rp.add_argument("--dtype", default="f32",
                    help="peak-table dtype column (default f32)")
    rp.add_argument("--gap-threshold-us", type=float, default=1000.0,
                    help="host gap (us) splitting device busy windows "
                         "for the dispatch analysis (default 1000)")
    rp.add_argument("--spans", default=None,
                    help="the run's span JSONL (SAGECAL_TRACE=1): each "
                         "dispatch gap's seconds by the innermost program "
                         "span open over it")
    rp.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    rp.set_defaults(fn=_cmd_roofline)

    evp = sub.add_parser(
        "evidence",
        help="evidence-class ledger: which banked claims are wall-"
             "clock-proven vs AOT-proven (exit 1 on any unclassified)",
    )
    evp.add_argument("record", nargs="?", default="BENCH_BASELINE.json",
                     help="bench record / baseline JSON (default "
                          "BENCH_BASELINE.json)")
    evp.add_argument("--history", default=None,
                     help="also audit this BENCH_HISTORY.jsonl for "
                          "unclassified rows")
    evp.set_defaults(fn=_cmd_evidence)

    sp = sub.add_parser(
        "serve",
        help="fleet serve report: latency/SLO/cache/lifecycle across "
             "worker out-dirs (exit 1 on burning SLO)",
    )
    sp.add_argument("out_dir", nargs="+",
                    help="serve --out-dir(s): result manifests + "
                         "metrics-*.json worker snapshots")
    sp.add_argument("--events", action="append", default=None,
                    metavar="FILE_OR_DIR",
                    help="JSONL event log(s) to fold in (repeatable)")
    sp.add_argument("--spans", action="append", default=None,
                    metavar="FILE_OR_DIR",
                    help="span JSONL(s) from SAGECAL_TRACE runs "
                         "(repeatable); enables lifecycle completeness "
                         "audit")
    sp.add_argument("--slo", default="",
                    help="slo.json (or request manifest with a 'slos' "
                         "key); burning tenant -> exit 1")
    sp.add_argument("--bench-history", default=None,
                    help="bench history JSONL (default: "
                         "$SAGECAL_BENCH_HISTORY; none otherwise)")
    sp.add_argument("--last-k", type=int, default=5,
                    help="bench-trend window (default 5)")
    sp.add_argument("--timeline-points", type=int, default=24,
                    help="max rows in the queue-depth timeline")
    sp.add_argument("--report", default=None,
                    help="also write a machine-readable JSON report")
    sp.set_defaults(fn=_cmd_serve)

    ldp = sub.add_parser(
        "load",
        help="load/capacity report: throughput-vs-offered curve, "
             "saturation knee, shed rate, Little's-law cross-check, "
             "autoscale recommendation (exit 1 on disagreement)",
    )
    ldp.add_argument("out_dir",
                     help="a `load` --out-dir (manifests "
                          "+ timeline.jsonl + load_steps.json)")
    ldp.add_argument("--slo", default="",
                     help="slo.json for goodput deadlines (default "
                          "<out_dir>/workload/slo.json)")
    ldp.add_argument("--knee-tol", type=float, default=0.10,
                     help="throughput this fraction below offered = "
                          "saturated (default 0.10)")
    ldp.add_argument("--littles-rtol", type=float, default=0.35,
                     help="relative tolerance of the L = λW "
                          "cross-check (default 0.35)")
    ldp.add_argument("--littles-atol", type=float, default=1.0,
                     help="absolute depth slack of the cross-check "
                          "(default 1.0 items)")
    ldp.add_argument("--report", default=None,
                     help="also write the machine-readable JSON "
                          "report here")
    ldp.set_defaults(fn=_cmd_load)

    dp = sub.add_parser(
        "drift",
        help="numerical-drift report from shadow-audit ledgers: "
             "per-(path-pair, bucket, dtype) distributions vs the "
             "central tolerance policy (exit 1 on any breach; exit 0 "
             "+ warning when no samples)",
    )
    dp.add_argument("out_dir", nargs="+",
                    help="serve/fleet --out-dir(s) holding drift.jsonl "
                         "(a ledger file path also works)")
    dp.add_argument("--report", default=None,
                    help="also write the machine-readable JSON report")
    dp.set_defaults(fn=_cmd_drift)

    aup = sub.add_parser(
        "audit",
        help="event-sourced fleet audit: schema-registry validation, "
             "deterministic replay, conservation-law gating (exit 1 "
             "on violation/gap, 2 on insufficient records)",
    )
    aup.add_argument("out_dir",
                     help="a fleet/load/serve --out-dir (queue/ + "
                          "manifests + sagecal_events.jsonl + "
                          "timeline.jsonl)")
    aup.add_argument("--events", default=None,
                     help="event log override (default "
                          "<out_dir>/sagecal_events.jsonl)")
    aup.add_argument("--queue", default=None,
                     help="queue dir override (default <out_dir>/queue)")
    aup.add_argument("--max-skew", type=float, default=30.0,
                     help="max tolerated per-writer clock offset, "
                          "seconds (default 30)")
    aup.add_argument("--slack", type=float, default=3.0,
                     help="timing slack for lease/timeline checks, "
                          "seconds (default 3)")
    aup.add_argument("--inject", default=None,
                     choices=("drop_event", "tear_record",
                              "forge_manifest", "skew_clock"),
                     help="inject an in-memory fault to prove the "
                          "detector (also: SAGECAL_AUDIT_INJECT)")
    aup.add_argument("--json", action="store_true",
                     help="print the full report as JSON")
    aup.add_argument("--report", default=None,
                     help="also write the machine-readable JSON report")
    aup.add_argument("-V", "--verbose", action="store_true",
                     help="list every violation and per-writer detail")
    aup.set_defaults(fn=_cmd_audit)

    rpp = sub.add_parser(
        "replay",
        help="deterministic fleet replay from records alone: queue "
             "state, request dispositions, worker lifecycle, clock "
             "offsets, SLO attainment (exit 2 when nothing to replay)",
    )
    rpp.add_argument("out_dir",
                     help="a fleet/load/serve --out-dir")
    rpp.add_argument("--events", default=None,
                     help="event log override (default "
                          "<out_dir>/sagecal_events.jsonl)")
    rpp.add_argument("--queue", default=None,
                     help="queue dir override (default <out_dir>/queue)")
    rpp.add_argument("--json", action="store_true",
                     help="print the replayed state as JSON")
    rpp.add_argument("--report", default=None,
                     help="also write the replayed state JSON here")
    rpp.add_argument("-V", "--verbose", action="store_true",
                     help="per-request and per-writer detail")
    rpp.set_defaults(fn=_cmd_replay)

    qp = sub.add_parser(
        "quality",
        help="calibration-quality report + chi^2 heatmaps from an event log",
    )
    qp.add_argument("file", help="JSONL event log of a telemetry run")
    qp.add_argument("--out-dir", default=None,
                    help="directory for the PPM heatmaps + JSON report "
                         "(default: alongside the event log)")
    qp.add_argument("--trend-thresh", type=float, default=2.0,
                    help="ADMM primal-residual growth treated as "
                         "divergence (default 2.0)")
    qp.add_argument("--fail-degraded", action="store_true",
                    help="exit non-zero on degradation too, not just "
                         "divergence")
    qp.set_defaults(fn=_cmd_quality)

    tp = sub.add_parser(
        "trace",
        help="span-tree report + straggler table from a span JSONL",
    )
    tp.add_argument("file", help="span JSONL (SAGECAL_TRACE_LOG)")
    tp.add_argument("--chrome", default=None, metavar="OUT",
                    help="also write a Perfetto-loadable trace.json here")
    tp.add_argument("--straggler-ratio", type=float, default=None,
                    help="slowest/median detection threshold (default "
                         "SAGECAL_STRAGGLER_RATIO or 1.5)")
    tp.set_defaults(fn=_cmd_trace)

    dp = sub.add_parser(
        "flight",
        help="render a flight-recorder dump (hang/crash forensics)",
    )
    dp.add_argument("file", help="flight_dump.json from a stall or crash")
    dp.add_argument("--ring-tail", type=int, default=20,
                    help="activity-ring entries to show (default 20)")
    dp.set_defaults(fn=_cmd_flight)

    lp = sub.add_parser(
        "lint",
        help="static-analysis gate: the JL rules over the port's Python "
             "and csrc/ (exit 1 on new gate findings)",
    )
    lp.add_argument("lint_args", nargs=argparse.REMAINDER,
                    help="arguments forwarded to the linter (paths, "
                         "--format, --baseline, --rules, --list-rules)")
    lp.set_defaults(fn=_cmd_lint)

    kcp = sub.add_parser(
        "kernelcheck",
        help="Hopper kernel-budget checker: shared memory, registers, "
             "threads against the model of csrc/*.cu (exit 1 on "
             "violation)",
    )
    kcp.add_argument("kernelcheck_args", nargs=argparse.REMAINDER,
                     help="arguments forwarded to kernel_check "
                          "(--json, --crosscheck)")
    kcp.set_defaults(fn=_cmd_kernelcheck)

    pcp = sub.add_parser(
        "protocol",
        help="model-check the fleet lease + stream owner-lease "
             "protocols (exhaustive interleavings, crash injection)",
    )
    pcp.add_argument("--workers", type=int, default=2,
                     help="logical queue workers to interleave "
                          "(default 2 = exhaustive in seconds)")
    pcp.add_argument("--crashes", type=int, default=1,
                     help="crash injections per schedule (default 1)")
    pcp.add_argument("--ticks", type=int, default=2,
                     help="clock advances per schedule (default 2)")
    pcp.add_argument("--deadline", type=float, default=55.0,
                     help="per-scenario exploration deadline seconds")
    pcp.add_argument("--json", action="store_true",
                     help="print the full report as JSON")
    pcp.set_defaults(fn=_cmd_protocol)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    # argparse REMAINDER cannot capture a leading option (bpo-17050:
    # `diag lint --format json ...` dies in the TOP-level parser), so
    # the pass-through subcommands forward by hand
    if argv and argv[0] == "lint":
        from sagecal_tpu_torch.analysis.cli import main as lint_main
        return lint_main(argv[1:])
    if argv and argv[0] == "kernelcheck":
        from sagecal_tpu_torch.analysis.kernel_check import main as kc_main
        return kc_main(argv[1:])
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
