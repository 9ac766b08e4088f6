"""Execution tracing: hierarchical spans and the Chrome-trace export
(counterpart of ``sagecal_tpu/obs/trace.py``, copied).

Host-side half of the causal-timing story (the metrics registry answers
"how much", spans answer "where and in what order").  A :class:`Tracer`
keeps a thread-local span stack so nested ``with tracer.span(...)``
blocks form a tree (trace id / span id / parent id), times each span
with ``time.monotonic()``, and appends one JSON line per finished span
to a JSONL file (``SAGECAL_TRACE_LOG``, default
``sagecal_trace.jsonl``).  ``close()`` additionally emits a Chrome
trace event file (``trace.json``) loadable in Perfetto / chrome://tracing.

Span records share the event-log vocabulary: the tracer's ``trace_id``
is set to the run manifest's ``run_id`` by the apps, so spans join
against the JSONL event stream on that id.

Per-band attribution: where a consensus loop runs as one device
program, per-band wall time cannot be measured on the host.
:func:`band_attribution` distributes a measured phase wall-time over
per-band work weights (unflagged-row fractions) into *synthetic* child
spans that sum exactly to the phase total; :func:`straggler_stats`
turns per-band seconds (real or attributed) into slowest/median ratio
and skew gauges.  Modes with a genuine host-side per-band loop
(minibatch consensus) record real band spans instead.

Discipline mirrors the rest of :mod:`sagecal_tpu_torch.obs`:

- zero-cost when disabled — :func:`get_tracer` hands out a shared
  :class:`NullTracer` whose ``span()`` returns a reusable no-op context
  manager, so instrumented call sites never branch;
- host-side only — a span times host wall clock; it holds no device
  synchronize, so a span around asynchronous CUDA work ends when the
  work is queued unless the code inside synchronizes;
- import-light — this module imports neither torch nor numpy.

Enable with ``SAGECAL_TRACE=1``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# v2: spans carry writer identity + mono/seq audit stamps (appended
# after the v1 keys; v1 readers are unaffected, the offline auditor in
# obs/ledger.py accepts both versions)
SPAN_SCHEMA_VERSION = 2

_TRUTHY = ("1", "true", "yes", "on")

DEFAULT_TRACE_LOG = "sagecal_trace.jsonl"
DEFAULT_STRAGGLER_RATIO = 1.5


def _env_enabled() -> bool:
    return os.environ.get("SAGECAL_TRACE", "").strip().lower() in _TRUTHY


_enabled: Optional[bool] = None  # None -> defer to the env var


def trace_enabled() -> bool:
    """Master tracing switch: ``set_trace`` override if set, otherwise
    the ``SAGECAL_TRACE`` env var."""
    if _enabled is not None:
        return _enabled
    return _env_enabled()


def set_trace(on: Optional[bool]) -> None:
    """Force tracing on/off for this process (``None`` restores env-var
    control)."""
    global _enabled
    _enabled = on


def _jsonable(x):
    from sagecal_tpu_torch.obs.events import _jsonable as ev_jsonable

    return ev_jsonable(x)


class _NullSpan:
    """Reusable no-op context manager (shared instance, allocation-free
    on the disabled path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span handle; written to the tracer's JSONL on ``__exit__``."""

    __slots__ = ("tracer", "name", "attrs", "span_id", "parent_id",
                 "_t0_mono", "_t0_unix")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = ""
        self.parent_id = None
        self._t0_mono = 0.0
        self._t0_unix = 0.0

    def __enter__(self) -> "_Span":
        tr = self.tracer
        stack = tr._stack()
        self.parent_id = stack[-1] if stack else None
        self.span_id = tr._new_span_id()
        stack.append(self.span_id)
        self._t0_unix = time.time()
        self._t0_mono = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.monotonic() - self._t0_mono
        tr = self.tracer
        stack = tr._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        elif self.span_id in stack:  # unbalanced exit: drop down to us
            del stack[stack.index(self.span_id):]
        attrs = self.attrs
        if exc_type is not None:
            attrs = dict(attrs)
            attrs["error"] = exc_type.__name__
        tr._write_span(self.name, self.span_id, self.parent_id,
                       self._t0_unix, dur, attrs)
        return False


class Tracer:
    """Process tracer: thread-local span stacks, one JSONL line per
    finished span (single ``os.write`` on an ``O_APPEND`` fd, so
    multi-process writers interleave whole lines), Chrome-trace export
    on :meth:`close`."""

    enabled = True

    def __init__(self, path: str, trace_id: Optional[str] = None,
                 chrome_path: Optional[str] = None):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._fd: Optional[int] = os.open(
            path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        if trace_id is None:
            import uuid

            trace_id = uuid.uuid4().hex[:12]
        self.trace_id = trace_id
        self.chrome_path = chrome_path or default_chrome_path(path)
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._pid = os.getpid()
        self._lock = threading.Lock()
        from sagecal_tpu_torch.obs.events import writer_identity

        self._writer = writer_identity()
        self._seq = itertools.count(0)

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _new_span_id(self) -> str:
        return f"{self._pid:x}.{next(self._ids):x}"

    def current_span_id(self) -> Optional[str]:
        stack = self._stack()
        return stack[-1] if stack else None

    def allocate_span_id(self) -> str:
        """Reserve a span id to hand out (e.g. embed in a result
        manifest) before the span itself is recorded via
        :meth:`add_span` with ``span_id=``."""
        return self._new_span_id()

    def span(self, name: str, **attrs) -> _Span:
        """Context manager timing a nested span; attrs land in the
        record's ``attrs`` object."""
        return _Span(self, name, attrs)

    def add_span(self, name: str, seconds: float, *,
                 parent_id: Optional[str] = None,
                 start_unix: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 **attrs) -> str:
        """Record an already-measured span (used for synthetic per-band
        / per-round attribution children, and for serve's per-request
        lifecycle chains).  ``trace_id`` overrides the tracer-wide id so
        one process can write many logical traces (one per request);
        ``span_id`` records under a previously
        :meth:`allocate_span_id`-reserved id.  Returns the span id so
        callers can parent further children under it."""
        if span_id is None:
            span_id = self._new_span_id()
        if start_unix is None:
            start_unix = time.time() - seconds
        if parent_id is None:
            parent_id = self.current_span_id()
        self._write_span(name, span_id, parent_id, start_unix,
                         float(seconds), attrs, trace_id=trace_id)
        return span_id

    def _write_span(self, name: str, span_id: str,
                    parent_id: Optional[str], ts: float, dur: float,
                    attrs: Dict[str, Any],
                    trace_id: Optional[str] = None) -> None:
        rec = {
            "kind": "span",
            "schema_version": SPAN_SCHEMA_VERSION,
            "trace_id": trace_id or self.trace_id,
            "span_id": span_id,
            "parent_id": parent_id,
            "name": name,
            "ts": ts,
            "dur": dur,
            "pid": self._pid,
            "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
        }
        if attrs:
            rec["attrs"] = {str(k): _jsonable(v) for k, v in attrs.items()}
        # v2 audit stamps, appended after the v1 layout: writer
        # identity + per-writer sequence + a monotonic reading taken at
        # write time (same-writer ordering under wall-clock steps)
        rec["writer"] = self._writer
        rec["mono"] = time.monotonic()
        rec["seq"] = next(self._seq)
        line = (json.dumps(rec) + "\n").encode("utf-8")
        fd = self._fd
        if fd is None:
            return
        try:
            os.write(fd, line)  # one write per line: atomic under O_APPEND
        except OSError:
            pass
        from sagecal_tpu_torch.obs.flight import note_activity

        note_activity("span", name=name, dur=dur)

    def close(self) -> None:
        """Close the JSONL fd and (re)write the Chrome trace file from
        every span recorded so far at :attr:`path`."""
        with self._lock:
            fd, self._fd = self._fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass
        try:
            spans = read_spans(self.path)
            if spans:
                write_chrome_trace(spans, self.chrome_path)
        except OSError:
            pass


class NullTracer:
    """No-op tracer handed out when tracing is disabled: ``span()``
    returns a shared allocation-free context manager, everything else
    returns immediately.  Shared singleton."""

    enabled = False

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def add_span(self, name, seconds, *, parent_id=None, start_unix=None,
                 trace_id=None, span_id=None, **attrs) -> None:
        return None

    def current_span_id(self) -> None:
        return None

    def allocate_span_id(self) -> str:
        return ""

    def close(self) -> None:
        pass


_NULL = NullTracer()
_TRACER: Optional[Tracer] = None
_TRACER_LOCK = threading.Lock()


def default_trace_path() -> str:
    return os.environ.get("SAGECAL_TRACE_LOG") or DEFAULT_TRACE_LOG


def default_chrome_path(trace_path: str) -> str:
    base = trace_path[:-6] if trace_path.endswith(".jsonl") else trace_path
    return base + ".trace.json"


def configure_tracer(run_id: Optional[str] = None,
                     path: Optional[str] = None) -> Optional[Tracer]:
    """App entry point: install the process tracer (correlated with the
    run manifest's ``run_id``) when tracing is enabled.  Returns None
    when disabled.  The first configuration wins; later calls return
    the existing tracer."""
    global _TRACER
    if not trace_enabled():
        return None
    with _TRACER_LOCK:
        if _TRACER is None:
            _TRACER = Tracer(path or default_trace_path(), trace_id=run_id)
        return _TRACER


def get_tracer() -> Any:
    """The process tracer when tracing is on (auto-configured from env
    on first use), else the shared :class:`NullTracer`."""
    tr = _TRACER
    if tr is not None:
        return tr
    if not trace_enabled():
        return _NULL
    return configure_tracer() or _NULL


def close_tracer() -> None:
    """Flush + close the process tracer (writes the Chrome trace file);
    the next :func:`configure_tracer` starts fresh."""
    global _TRACER
    with _TRACER_LOCK:
        tr, _TRACER = _TRACER, None
    if tr is not None:
        tr.close()


# ---------------------------------------------------------------------------
# span file readers / Chrome trace export


def read_spans(path: str) -> List[dict]:
    """Load span records from a span JSONL file (tolerates foreign /
    corrupt lines the same way :func:`obs.events.read_events` does)."""
    from sagecal_tpu_torch.obs.events import read_events

    return [r for r in read_events(path) if r.get("kind") == "span"]


def to_chrome_trace(spans: Sequence[dict]) -> dict:
    """Convert span records to the Chrome trace event format (JSON
    object flavour: ``{"traceEvents": [...]}``) — Perfetto and
    chrome://tracing both load it directly.

    Lanes: spans carry an optional ``attrs.lane`` (e.g. ``band3`` for
    synthetic per-band children); otherwise the recording thread is the
    lane.  Timestamps are rebased to the earliest span = 0 µs.
    """
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(float(s.get("ts", 0.0)) for s in spans)
    lanes: Dict[Tuple[int, str], int] = {}
    events: List[dict] = []
    pids = sorted({int(s.get("pid", 0)) for s in spans})
    for s in spans:
        pid = int(s.get("pid", 0))
        attrs = s.get("attrs") or {}
        lane = str(attrs.get("lane") or s.get("thread") or s.get("tid", 0))
        key = (pid, lane)
        if key not in lanes:
            lanes[key] = len([k for k in lanes if k[0] == pid]) + 1
        args = dict(attrs)
        args["span_id"] = s.get("span_id")
        if s.get("parent_id"):
            args["parent_id"] = s.get("parent_id")
        args["trace_id"] = s.get("trace_id")
        events.append({
            "name": s.get("name", "?"),
            "ph": "X",
            "ts": (float(s.get("ts", 0.0)) - t0) * 1e6,
            "dur": max(float(s.get("dur", 0.0)), 0.0) * 1e6,
            "pid": pid,
            "tid": lanes[key],
            "cat": str(attrs.get("kind", "span")),
            "args": args,
        })
    meta: List[dict] = []
    for pid in pids:
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": f"sagecal-tpu pid={pid}"}})
    for (pid, lane), tid in sorted(lanes.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": lane}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: Sequence[dict], path: str) -> str:
    """Write :func:`to_chrome_trace` output atomically; returns path."""
    doc = to_chrome_trace(spans)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# span-tree analysis (pure python; used by `diag trace` and tests)


def build_span_tree(spans: Sequence[dict]):
    """Return ``(roots, children)``: root span records (no parent, or
    parent missing from the file) and a ``parent_id -> [child, ...]``
    map, both in start-time order."""
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in spans:
        pid = s.get("parent_id")
        if pid and pid in by_id:
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)
    key = lambda s: float(s.get("ts", 0.0))  # noqa: E731
    roots.sort(key=key)
    for v in children.values():
        v.sort(key=key)
    return roots, children


def format_span_tree(spans: Sequence[dict], max_children: int = 12) -> str:
    """Indented span-tree rendering (durations in seconds)."""
    roots, children = build_span_tree(spans)
    lines: List[str] = []

    def emit(s: dict, depth: int) -> None:
        attrs = s.get("attrs") or {}
        extra = ""
        tag = []
        if attrs.get("synthetic"):
            tag.append("synthetic")
        for k in ("band", "round", "tile"):
            if k in attrs:
                tag.append(f"{k}={attrs[k]}")
        if tag:
            extra = "  [" + " ".join(tag) + "]"
        lines.append(
            f"{'  ' * depth}{s.get('name','?'):<24s}"
            f" {float(s.get('dur',0.0)):10.4f}s{extra}")
        kids = children.get(s.get("span_id"), [])
        for c in kids[:max_children]:
            emit(c, depth + 1)
        if len(kids) > max_children:
            lines.append(f"{'  ' * (depth + 1)}... {len(kids) - max_children}"
                         " more children elided")

    for r in roots:
        emit(r, 0)
    return "\n".join(lines)


def critical_path(spans: Sequence[dict]) -> List[dict]:
    """Greedy critical path: from the longest root, repeatedly descend
    into the longest child.  A useful first answer to "where did the
    wall-clock go" without needing precise overlap accounting."""
    roots, children = build_span_tree(spans)
    if not roots:
        return []
    path = [max(roots, key=lambda s: float(s.get("dur", 0.0)))]
    while True:
        kids = children.get(path[-1].get("span_id"), [])
        if not kids:
            return path
        path.append(max(kids, key=lambda s: float(s.get("dur", 0.0))))


def aggregate_by_name(spans: Sequence[dict]) -> Dict[str, dict]:
    """Per-span-name totals: ``{name: {count, total, max}}``."""
    out: Dict[str, dict] = {}
    for s in spans:
        a = out.setdefault(s.get("name", "?"),
                           {"count": 0, "total": 0.0, "max": 0.0})
        dur = float(s.get("dur", 0.0))
        a["count"] += 1
        a["total"] += dur
        a["max"] = max(a["max"], dur)
    return out


def band_seconds_from_spans(spans: Sequence[dict]) -> Dict[int, float]:
    """Sum span durations per ``attrs.band`` (real or synthetic)."""
    out: Dict[int, float] = {}
    for s in spans:
        attrs = s.get("attrs") or {}
        if "band" in attrs:
            try:
                b = int(attrs["band"])
            except (TypeError, ValueError):
                continue
            out[b] = out.get(b, 0.0) + float(s.get("dur", 0.0))
    return out


# ---------------------------------------------------------------------------
# straggler attribution


def band_attribution(total_seconds: float,
                     weights: Sequence[float]) -> List[float]:
    """Distribute a measured wall-time over per-band work weights.

    The weights are per-band work proxies (unflagged-row fractions for
    the mesh ADMM; padding bands carry weight 0 and get 0 s).  Falls
    back to a uniform split when the weights are all zero/negative.
    The returned list sums to ``total_seconds`` exactly (last band
    absorbs the float residue) so synthesized child spans reconcile
    with the parent phase."""
    w = [max(float(x), 0.0) for x in weights]
    n = len(w)
    if n == 0:
        return []
    tot = sum(w)
    if tot <= 0.0:
        w = [1.0] * n
        tot = float(n)
    out = [total_seconds * x / tot for x in w]
    out[-1] += total_seconds - sum(out)
    return out


def straggler_ratio_threshold() -> float:
    """Slowest/median ratio above which a band counts as a straggler
    (``SAGECAL_STRAGGLER_RATIO``, default 1.5)."""
    try:
        return float(os.environ.get("SAGECAL_STRAGGLER_RATIO", ""))
    except ValueError:
        return DEFAULT_STRAGGLER_RATIO


def straggler_stats(band_seconds: Sequence[float],
                    ratio_thresh: Optional[float] = None) -> dict:
    """Imbalance gauges over per-band seconds (real or attributed):
    slowest/median ratio, relative skew ``(max-mean)/mean``, the worst
    band, and a detection verdict at ``ratio_thresh`` (default from
    :func:`straggler_ratio_threshold`).  Delegates the array math to
    :func:`sagecal_tpu_torch.parallel.consensus.band_imbalance` so the
    definition lives next to the other consensus health metrics.

    Reading the straggler table under bounded staleness (the
    ``--consensus-staleness`` async rounds of
    ``parallel/async_consensus.py``): a heavy band refreshing every
    ``p`` rounds bills its solve time to 1-in-``p`` rounds, so its
    per-round attributed seconds — and hence this ratio — drop by
    ~``p``x relative to the synchronous schedule.  A PERSISTENT high
    ratio in async mode therefore means the refresh periods no longer
    match the actual skew (e.g. flag fractions drifted since the
    periods were derived) rather than an unscheduled slow band."""
    if ratio_thresh is None:
        ratio_thresh = straggler_ratio_threshold()
    secs = [float(x) for x in band_seconds]
    if not secs:
        return {"ratio": 1.0, "skew": 0.0, "argmax": 0, "median": 0.0,
                "detected": False, "threshold": ratio_thresh,
                "band_seconds": []}
    from sagecal_tpu_torch.parallel.consensus import band_imbalance

    ratio, skew, worst = band_imbalance(secs)
    srt = sorted(secs)
    n = len(srt)
    med = (srt[n // 2] if n % 2 else 0.5 * (srt[n // 2 - 1] + srt[n // 2]))
    return {
        "ratio": float(ratio),
        "skew": float(skew),
        "argmax": int(worst),
        "median": float(med),
        "detected": bool(float(ratio) > ratio_thresh and n > 1),
        "threshold": float(ratio_thresh),
        "band_seconds": secs,
    }


def format_straggler_table(band_seconds: Dict[int, float],
                           ratio_thresh: Optional[float] = None) -> str:
    """Per-band straggler table for ``diag trace``."""
    if not band_seconds:
        return "(no per-band spans)"
    bands = sorted(band_seconds)
    secs = [band_seconds[b] for b in bands]
    stats = straggler_stats(secs, ratio_thresh)
    total = sum(secs) or 1.0
    lines = [f"{'band':>6s} {'seconds':>12s} {'share':>8s} "
             f"{'vs median':>10s}"]
    for b, s in zip(bands, secs):
        vs = s / stats["median"] if stats["median"] > 0 else float("inf")
        mark = "  <-- straggler" if (
            stats["detected"] and b == bands[stats["argmax"]]) else ""
        lines.append(f"{b:>6d} {s:>12.4f} {s / total:>7.1%} "
                     f"{vs:>9.2f}x{mark}")
    verdict = ("STRAGGLER DETECTED" if stats["detected"] else "balanced")
    lines.append(
        f"slowest/median {stats['ratio']:.2f}x (threshold "
        f"{stats['threshold']:.2f}x), skew {stats['skew']:+.2f} -> {verdict}")
    return "\n".join(lines)


def format_trace_report(spans: Sequence[dict],
                        ratio_thresh: Optional[float] = None) -> str:
    """Full ``diag trace`` report: summary, span tree, per-name
    attribution, critical path, per-band straggler table."""
    if not spans:
        return "(no spans)"
    traces = sorted({s.get("trace_id") for s in spans if s.get("trace_id")})
    tmin = min(float(s.get("ts", 0.0)) for s in spans)
    tmax = max(float(s.get("ts", 0.0)) + float(s.get("dur", 0.0))
               for s in spans)
    out = [
        f"spans: {len(spans)}  traces: {len(traces)} "
        f"({', '.join(traces[:4])}{'...' if len(traces) > 4 else ''})",
        f"wall window: {tmax - tmin:.4f}s",
        "",
        "span tree:",
        format_span_tree(spans),
        "",
        "attribution by span name:",
    ]
    agg = aggregate_by_name(spans)
    out.append(f"{'name':<26s} {'count':>6s} {'total_s':>10s} {'max_s':>10s}")
    for name, a in sorted(agg.items(), key=lambda kv: -kv[1]["total"]):
        out.append(f"{name:<26s} {a['count']:>6d} {a['total']:>10.4f} "
                   f"{a['max']:>10.4f}")
    path = critical_path(spans)
    out.append("")
    out.append("critical path: " + " > ".join(
        f"{s.get('name','?')}({float(s.get('dur',0.0)):.3f}s)"
        for s in path))
    out.append("")
    out.append("per-band attribution (straggler table):")
    out.append(format_straggler_table(band_seconds_from_spans(spans),
                                      ratio_thresh))
    return "\n".join(out)
