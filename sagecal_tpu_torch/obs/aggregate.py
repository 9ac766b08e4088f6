"""Metric snapshots and the fleet view (a copy of
``sagecal_tpu/obs/aggregate.py``, stdlib only; that module cannot be
imported without JAX).

The serve path writes one cumulative snapshot of the process's registry
at the end of a run (``metrics-<worker>.json`` under its out-dir); a
reader loads every snapshot of a directory and keeps the newest per
worker.  :func:`fleet_view` merges the snapshots, result manifests,
events and spans of several workers into one view; the fleet
coordinator's summary reads it.  ``diag serve`` waits for ROADMAP.md's
A11.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from sagecal_tpu_torch.obs.registry import MetricsRegistry, _Histogram

METRICS_SNAPSHOT_SCHEMA_VERSION = 1

#: per-request lifecycle phases every accepted serve request must log
#: (in order); ``compile``/``cache_hit`` is the alternation between a
#: bucket's first dispatch and every later one
LIFECYCLE_PHASES = ("enqueue", "schedule", "pack", "execute", "unpack",
                    "write_manifest")
LIFECYCLE_ALTERNATIVES = ("compile", "cache_hit")
LIFECYCLE_ROOT = "serve.request"


def worker_id() -> str:
    """Stable identity of this worker for snapshot lineage:
    ``SAGECAL_WORKER_ID`` when the deployment sets one (so a resumed
    replacement supersedes its predecessor's snapshot), else the pid."""
    return os.environ.get("SAGECAL_WORKER_ID", "").strip() \
        or str(os.getpid())


def metrics_snapshot_path(out_dir: str,
                          worker: Optional[str] = None) -> str:
    """Canonical snapshot path for one worker under a serve output
    directory.  Snapshots are CUMULATIVE (a worker rewrites its own
    file), so the path must be stable per worker identity."""
    return os.path.join(out_dir, f"metrics-{worker or worker_id()}.json")


def write_metrics_snapshot(path: str, registry=None, **extra) -> str:
    """Atomically dump one process's registry state (tmp + replace so a
    concurrent reader never sees a torn file).  Returns the path."""
    if registry is None:
        from sagecal_tpu_torch.obs.registry import get_registry

        registry = get_registry()
    doc = {
        "kind": "metrics_snapshot",
        "schema_version": METRICS_SNAPSHOT_SCHEMA_VERSION,
        "ts": time.time(),
        "pid": os.getpid(),
        "worker_id": worker_id(),
        "state": registry.export_state(),
    }
    for k, v in extra.items():
        doc.setdefault(k, v)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.write("\n")
    os.replace(tmp, path)
    return path


def expand_snapshot_paths(path: str) -> List[str]:
    """Resolve a snapshot argument to the files it names: a directory
    expands to its ``metrics-*.json`` members, a file to itself."""
    if os.path.isdir(path):
        return sorted(_glob.glob(os.path.join(path, "metrics-*.json")))
    return [path] if os.path.exists(path) else []


def read_metrics_snapshots(*paths: str) -> List[dict]:
    """Load every snapshot document the arguments name (skipping
    unreadable/corrupt files rather than failing — a preempted worker
    may never have written one)."""
    out: List[dict] = []
    for p in paths:
        for f in expand_snapshot_paths(p):
            try:
                with open(f, "r", encoding="utf-8") as fh:
                    doc = json.load(fh)
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(doc, dict) and doc.get("state") is not None:
                out.append(doc)
    out.sort(key=lambda d: float(d.get("ts", 0.0)))
    return out


def dedupe_snapshots(docs: Sequence[dict]) -> List[dict]:
    """Keep only the newest snapshot per worker id.  Snapshots are
    cumulative registry dumps — merging two generations of the SAME
    worker would double-count everything the older one already held."""
    latest: Dict[str, dict] = {}
    for d in docs:
        wid = str(d.get("worker_id") or d.get("pid") or id(d))
        prev = latest.get(wid)
        if prev is None or float(d.get("ts", 0.0)) >= float(
                prev.get("ts", 0.0)):
            latest[wid] = d
    return sorted(latest.values(), key=lambda d: float(d.get("ts", 0.0)))


def merge_states(states: Iterable[dict]) -> dict:
    """Fold any number of ``export_state`` documents into one merged
    state: counters add, histograms merge bucket-by-bucket, gauges keep
    the first (i.e. for snapshot lists sorted by ts, the earliest)
    value per series.  Associative and order-independent for counters
    and histograms."""
    reg = MetricsRegistry()
    for st in states:
        reg.restore_state(st)
    return reg.export_state()


def _labels_match(entry_labels: Sequence[Sequence[str]],
                  want: Dict[str, str]) -> bool:
    have = {k: v for k, v in entry_labels}
    return all(have.get(k) == str(v) for k, v in want.items())


def state_counter_total(state: dict, name: str, **labels) -> float:
    """Sum of every counter series in ``state`` matching ``name`` and
    the given label subset."""
    return sum(float(e["value"]) for e in state.get("counters", ())
               if e["name"] == name and _labels_match(e["labels"], labels))


def state_histogram(state: dict, name: str, **labels
                    ) -> Optional[_Histogram]:
    """Merge every histogram series matching ``name`` + label subset
    into one :class:`_Histogram` (None when nothing matches)."""
    merged: Optional[_Histogram] = None
    for e in state.get("histograms", ()):
        if e["name"] != name or not _labels_match(e["labels"], labels):
            continue
        h = _Histogram.from_snapshot(e)
        if merged is None:
            merged = h
        else:
            merged.merge(h)
    return merged


def state_label_values(state: dict, name: str, label: str) -> List[str]:
    """Distinct values of one label across every series of a metric
    (counters + histograms), sorted."""
    vals = set()
    for kind in ("counters", "gauges", "histograms"):
        for e in state.get(kind, ()):
            if e["name"] != name:
                continue
            for k, v in e["labels"]:
                if k == label:
                    vals.add(v)
    return sorted(vals)


def quantile_bounds_from_state(state: dict, name: str,
                               qs: Sequence[float] = (0.5, 0.95, 0.99),
                               **labels) -> Dict[float, Tuple[float, float]]:
    """Exact quantile bounds per requested quantile from the merged
    histogram of a metric (empty dict when no observations)."""
    h = state_histogram(state, name, **labels)
    if h is None or h.count == 0:
        return {}
    out = {}
    for q in qs:
        b = h.quantile_bounds(q)
        if b is not None:
            out[float(q)] = b
    return out


# ---------------------------------------------------------------------------
# result manifests (the per-request ground truth)


def read_result_manifests(*out_dirs: str) -> List[dict]:
    """Every ``*.result.json`` under the given serve output dirs, in
    completion-time order (falls back to request_id order for pre-PR
    manifests without timestamps)."""
    out: List[dict] = []
    for d in out_dirs:
        for p in sorted(_glob.glob(os.path.join(d, "*.result.json"))):
            try:
                with open(p, "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(doc, dict) and doc.get("request_id"):
                out.append(doc)
    out.sort(key=lambda r: (float(r.get("completed_at", 0.0)),
                            str(r.get("request_id", ""))))
    return out


def queue_depth_series(results: Sequence[dict]) -> List[Tuple[float, int]]:
    """Reconstruct the waiting-room depth from result manifests alone:
    +1 at ``enqueued_at``, -1 at ``started_at``, ABSOLUTE timestamps.
    Shed manifests participate (a to-be-shed request occupied the queue
    until its shed decision — ``started_at`` — exactly like the live
    view counts it); they are excluded from *served-work* accounting by
    obs/capacity.served_results, not from depth.  At equal timestamps
    arrivals apply before departures, so a zero-wait disposition (e.g.
    an instant shed with ``started_at == enqueued_at``) can never swing
    the reconstructed depth negative."""
    edges: List[Tuple[float, int]] = []
    for r in results:
        enq = r.get("enqueued_at")
        sta = r.get("started_at")
        if enq is None or sta is None:
            continue
        edges.append((float(enq), +1))
        edges.append((float(sta), -1))
    if not edges:
        return []
    edges.sort(key=lambda e: (e[0], -e[1]))
    depth = 0
    line: List[Tuple[float, int]] = []
    for t, d in edges:
        depth += d
        line.append((t, depth))
    return line


def queue_depth_timeline(results: Sequence[dict],
                         max_points: int = 64) -> List[Tuple[float, int]]:
    """:func:`queue_depth_series` rebased to run-relative seconds and
    down-sampled to ``max_points`` (the ``diag serve`` rendering)."""
    series = queue_depth_series(results)
    if not series:
        return []
    t0 = series[0][0]
    line = [(t - t0, depth) for t, depth in series]
    if len(line) > max_points:
        step = len(line) / float(max_points)
        line = [line[int(i * step)] for i in range(max_points)]
    return line


# ---------------------------------------------------------------------------
# lifecycle (span-chain) completeness across the manifest boundary


def lifecycle_traces(spans: Sequence[dict]) -> Dict[str, List[dict]]:
    """Group spans by trace id, keeping only traces that contain a
    ``serve.request`` root (run-level spans keep their own trace id and
    are excluded)."""
    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        tid = s.get("trace_id")
        if tid:
            by_trace.setdefault(tid, []).append(s)
    return {t: ss for t, ss in by_trace.items()
            if any(s.get("name") == LIFECYCLE_ROOT for s in ss)}


def check_lifecycle(spans: Sequence[dict]) -> dict:
    """Validate one request's span chain: exactly one root, every
    required phase present, exactly one of ``compile``/``cache_hit``,
    every child parented to the root.  Returns a verdict dict with a
    ``complete`` bool and the list of ``problems``."""
    problems: List[str] = []
    roots = [s for s in spans if s.get("name") == LIFECYCLE_ROOT]
    if len(roots) != 1:
        problems.append(f"expected 1 {LIFECYCLE_ROOT} root, got {len(roots)}")
    names = [s.get("name") for s in spans]
    for ph in LIFECYCLE_PHASES:
        if ph not in names:
            problems.append(f"missing phase: {ph}")
    alts = [n for n in names if n in LIFECYCLE_ALTERNATIVES]
    if len(alts) != 1:
        problems.append(
            f"expected exactly one of {'|'.join(LIFECYCLE_ALTERNATIVES)}, "
            f"got {alts or 'none'}")
    if roots:
        root_id = roots[0].get("span_id")
        for s in spans:
            if s is roots[0]:
                continue
            if s.get("parent_id") != root_id:
                problems.append(
                    f"span {s.get('name')} not parented to root")
    return {
        "complete": not problems,
        "problems": problems,
        "phases": [n for n in names if n != LIFECYCLE_ROOT],
        "path": alts[0] if len(alts) == 1 else None,
    }


def lifecycle_report(spans: Sequence[dict],
                     results: Sequence[dict] = ()) -> dict:
    """Fleet-wide lifecycle audit: every result manifest carrying a
    ``trace_id`` must have a complete span chain somewhere in ``spans``
    (possibly written by a different process — the ids inside the
    manifests are what carry the lifecycle across that boundary)."""
    traces = lifecycle_traces(spans)
    verdicts: Dict[str, dict] = {
        t: check_lifecycle(ss) for t, ss in traces.items()}
    missing: List[str] = []
    matched = 0
    for r in results:
        tid = r.get("trace_id")
        if not tid:
            continue
        v = verdicts.get(tid)
        if v is None:
            missing.append(f"{r.get('request_id')}: no spans for trace "
                           f"{tid}")
        elif not v["complete"]:
            missing.append(f"{r.get('request_id')}: "
                           + "; ".join(v["problems"]))
        else:
            matched += 1
    incomplete = {t: v["problems"] for t, v in verdicts.items()
                  if not v["complete"]}
    return {
        "traces": len(verdicts),
        "complete": sum(1 for v in verdicts.values() if v["complete"]),
        "incomplete": incomplete,
        "manifests_with_trace": sum(
            1 for r in results if r.get("trace_id")),
        "manifests_matched": matched,
        "manifest_problems": missing,
        "cache_hit_traces": sum(
            1 for v in verdicts.values() if v.get("path") == "cache_hit"),
        "compile_traces": sum(
            1 for v in verdicts.values() if v.get("path") == "compile"),
        "ok": not missing and not incomplete,
    }


# ---------------------------------------------------------------------------
# the fleet view


def fleet_view(out_dirs: Sequence[str],
               snapshot_paths: Sequence[str] = (),
               event_paths: Sequence[str] = (),
               span_paths: Sequence[str] = ()) -> Dict[str, Any]:
    """One merged view of a multi-worker serve deployment.

    ``out_dirs`` are scanned for result manifests AND metric snapshots;
    extra snapshot/event/span paths (files or directories, pid-suffix
    companions included) widen the net.  Returns a dict with ``results``
    (per-request manifests), ``state`` (merged metrics), ``events``,
    ``spans`` and ``snapshots`` (count of snapshot files merged)."""
    from sagecal_tpu_torch.obs.events import read_events_merged
    from sagecal_tpu_torch.obs.trace import read_spans

    snaps = dedupe_snapshots(read_metrics_snapshots(
        *(list(out_dirs) + list(snapshot_paths))))
    events: List[dict] = []
    for p in event_paths:
        events.extend(read_events_merged(p))
    events.sort(key=lambda e: float(e.get("ts", 0.0)))
    spans: List[dict] = []
    for p in span_paths:
        from sagecal_tpu_torch.obs.events import expand_event_paths

        for f in expand_event_paths(p):
            spans.extend(read_spans(f))
    return {
        "results": read_result_manifests(*out_dirs),
        "state": merge_states(d["state"] for d in snaps),
        "snapshots": len(snaps),
        "events": events,
        "spans": spans,
    }
