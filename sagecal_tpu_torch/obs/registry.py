"""Metrics registry: counters, gauges, histograms, Prometheus export
(a copy of ``sagecal_tpu/obs/registry.py``, which is stdlib-only but
cannot be imported without JAX).

The host feeds numbers it already holds (phase times, convergence
records, quality gauges) into the process-wide registry after a solve
returns.  With telemetry off (``SAGECAL_TELEMETRY`` unset or falsy)
:func:`get_registry` hands out a shared :class:`NullRegistry` whose
mutators do nothing, so call sites need no guards.  ``export_state``
gives the structured dump the serve path writes as a metrics snapshot
at the end of a run (``obs/aggregate.py``), and a histogram's
``quantile_bounds`` serve the drift report (``obs/drift.py``).
``restore_state`` and the histogram merge serve the service's resume
(its checkpoints carry the registry) and the fleet view.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
from typing import Dict, Optional, Tuple

_TRUTHY = ("1", "true", "yes", "on")


def _env_enabled() -> bool:
    return os.environ.get("SAGECAL_TELEMETRY", "").strip().lower() in _TRUTHY


_enabled: Optional[bool] = None  # None -> defer to the env var


def telemetry_enabled() -> bool:
    """Master telemetry switch: ``set_telemetry`` override if set,
    otherwise the ``SAGECAL_TELEMETRY`` env var."""
    if _enabled is not None:
        return _enabled
    return _env_enabled()


def set_telemetry(on: Optional[bool]) -> None:
    """Force telemetry on/off for this process (``None`` restores env-var
    control).  The apps read it once per run, when they build the
    solver config."""
    global _enabled
    _enabled = on


# default histogram buckets: wall-clock seconds from sub-ms to minutes
_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 300.0
)


def _labels_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Histogram:
    __slots__ = ("buckets", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.count += 1
        self.total += value
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)

    def snapshot(self) -> dict:
        """JSON-able full state, bucket edges included."""
        return {
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "_Histogram":
        h = cls(snap["buckets"])
        counts = list(snap["counts"])
        if len(counts) != len(h.counts):
            raise ValueError(
                f"histogram snapshot has {len(counts)} buckets, "
                f"expected {len(h.counts)}")
        h.counts = [int(c) for c in counts]
        h.count = int(snap["count"])
        h.total = float(snap["sum"])
        if h.count:
            h.vmin = float(snap["min"])
            h.vmax = float(snap["max"])
        return h

    def merge(self, other: "_Histogram") -> None:
        """Fold ``other`` into this histogram in place.  Bucket layouts
        must match exactly — merging is only defined shard-by-shard over
        the same metric."""
        if self.buckets != other.buckets:
            raise ValueError(
                f"cannot merge histograms with different buckets: "
                f"{self.buckets} vs {other.buckets}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def quantile_bounds(self, q: float) -> Optional[Tuple[float, float]]:
        """Exact (lower, upper) bound on the q-quantile from the bucket
        counts alone: the true quantile lies in the closed interval;
        ``None`` when the histogram is empty."""
        if self.count == 0:
            return None
        q = min(max(float(q), 0.0), 1.0)
        rank = min(self.count, max(1, math.ceil(q * self.count - 1e-9)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                lo = self.buckets[i - 1] if i > 0 else float("-inf")
                hi = self.buckets[i] if i < len(self.buckets) else float("inf")
                # observed extremes tighten open-ended edges
                return (max(lo, self.vmin), min(hi, self.vmax))
        return (self.vmin, self.vmax)


class MetricsRegistry:
    """Threadsafe counter/gauge/histogram store with Prometheus text
    export (exposition format 0.0.4).  Metric names should be
    ``snake_case``; labels are free-form key/value strings."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[tuple, float]] = {}
        self._gauges: Dict[str, Dict[tuple, float]] = {}
        self._histograms: Dict[str, Dict[tuple, _Histogram]] = {}
        self._help: Dict[str, str] = {}

    @property
    def enabled(self) -> bool:
        return True

    def counter_inc(self, name: str, value: float = 1.0,
                    help: Optional[str] = None, **labels) -> None:
        with self._lock:
            if help:
                self._help.setdefault(name, help)
            series = self._counters.setdefault(name, {})
            key = _labels_key(labels)
            series[key] = series.get(key, 0.0) + float(value)

    def gauge_set(self, name: str, value: float,
                  help: Optional[str] = None, **labels) -> None:
        with self._lock:
            if help:
                self._help.setdefault(name, help)
            self._gauges.setdefault(name, {})[_labels_key(labels)] = float(value)

    def observe(self, name: str, value: float,
                buckets=_DEFAULT_BUCKETS,
                help: Optional[str] = None, **labels) -> None:
        with self._lock:
            if help:
                self._help.setdefault(name, help)
            series = self._histograms.setdefault(name, {})
            key = _labels_key(labels)
            if key not in series:
                series[key] = _Histogram(buckets)
            series[key].observe(float(value))

    def get_counter(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(name, {}).get(_labels_key(labels), 0.0)

    def get_gauge(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name, {}).get(_labels_key(labels))

    def snapshot(self) -> dict:
        """Plain-dict dump (JSONL-embeddable; see obs.events)."""
        with self._lock:
            out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
            for name, series in self._counters.items():
                for key, v in series.items():
                    out["counters"][name + _fmt_labels(key)] = v
            for name, series in self._gauges.items():
                for key, v in series.items():
                    out["gauges"][name + _fmt_labels(key)] = v
            for name, series in self._histograms.items():
                for key, h in series.items():
                    out["histograms"][name + _fmt_labels(key)] = h.snapshot()
            return out

    def export_state(self) -> dict:
        """Structured, JSON-able, label-preserving dump: labels kept as
        ``[key, value]`` pairs, so another process can rebuild the exact
        series (the metrics snapshot of ``obs/aggregate.py``)."""
        with self._lock:
            return {
                "schema_version": 1,
                "counters": [
                    {"name": name, "labels": [list(kv) for kv in key],
                     "value": v}
                    for name, series in self._counters.items()
                    for key, v in series.items()
                ],
                "gauges": [
                    {"name": name, "labels": [list(kv) for kv in key],
                     "value": v}
                    for name, series in self._gauges.items()
                    for key, v in series.items()
                ],
                "histograms": [
                    {"name": name, "labels": [list(kv) for kv in key],
                     **h.snapshot()}
                    for name, series in self._histograms.items()
                    for key, h in series.items()
                ],
            }

    def restore_state(self, state: dict) -> None:
        """Fold an :meth:`export_state` document back into this registry
        (used on ``--resume`` so counters stay monotonic across
        preemptions).  Counters and histograms accumulate; gauges are
        only restored where no fresher value exists."""
        if not state:
            return
        with self._lock:
            for ent in state.get("counters", ()):
                key = tuple(tuple(kv) for kv in ent["labels"])
                series = self._counters.setdefault(ent["name"], {})
                series[key] = series.get(key, 0.0) + float(ent["value"])
            for ent in state.get("gauges", ()):
                key = tuple(tuple(kv) for kv in ent["labels"])
                series = self._gauges.setdefault(ent["name"], {})
                series.setdefault(key, float(ent["value"]))
            for ent in state.get("histograms", ()):
                key = tuple(tuple(kv) for kv in ent["labels"])
                series = self._histograms.setdefault(ent["name"], {})
                incoming = _Histogram.from_snapshot(ent)
                if key in series:
                    series[key].merge(incoming)
                else:
                    series[key] = incoming

    def to_prometheus(self) -> str:
        """Prometheus text exposition (scrape a long run by dumping this
        to a file the node exporter's textfile collector watches)."""
        lines = []
        with self._lock:
            for name in sorted(self._counters):
                if name in self._help:
                    lines.append(f"# HELP {name} {self._help[name]}")
                lines.append(f"# TYPE {name} counter")
                for key, v in sorted(self._counters[name].items()):
                    lines.append(f"{name}{_fmt_labels(key)} {v:g}")
            for name in sorted(self._gauges):
                if name in self._help:
                    lines.append(f"# HELP {name} {self._help[name]}")
                lines.append(f"# TYPE {name} gauge")
                for key, v in sorted(self._gauges[name].items()):
                    lines.append(f"{name}{_fmt_labels(key)} {v:g}")
            for name in sorted(self._histograms):
                if name in self._help:
                    lines.append(f"# HELP {name} {self._help[name]}")
                lines.append(f"# TYPE {name} histogram")
                for key, h in sorted(self._histograms[name].items()):
                    cum = 0
                    for b, c in zip(h.buckets, h.counts):
                        cum += c
                        le = _fmt_labels(key + (("le", f"{b:g}"),))
                        lines.append(f"{name}_bucket{le} {cum}")
                    le = _fmt_labels(key + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{le} {h.count}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} {h.total:g}")
                    lines.append(f"{name}_count{_fmt_labels(key)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._help.clear()

    def to_prometheus(self) -> str:
        """Prometheus text exposition (scrape a long run by dumping this
        to a file the node exporter's textfile collector watches)."""
        lines = []
        with self._lock:
            for name in sorted(self._counters):
                if name in self._help:
                    lines.append(f"# HELP {name} {self._help[name]}")
                lines.append(f"# TYPE {name} counter")
                for key, v in sorted(self._counters[name].items()):
                    lines.append(f"{name}{_fmt_labels(key)} {v:g}")
            for name in sorted(self._gauges):
                if name in self._help:
                    lines.append(f"# HELP {name} {self._help[name]}")
                lines.append(f"# TYPE {name} gauge")
                for key, v in sorted(self._gauges[name].items()):
                    lines.append(f"{name}{_fmt_labels(key)} {v:g}")
            for name in sorted(self._histograms):
                if name in self._help:
                    lines.append(f"# HELP {name} {self._help[name]}")
                lines.append(f"# TYPE {name} histogram")
                for key, h in sorted(self._histograms[name].items()):
                    cum = 0
                    for b, c in zip(h.buckets, h.counts):
                        cum += c
                        le = _fmt_labels(key + (("le", f"{b:g}"),))
                        lines.append(f"{name}_bucket{le} {cum}")
                    le = _fmt_labels(key + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{le} {h.count}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} {h.total:g}")
                    lines.append(f"{name}_count{_fmt_labels(key)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._help.clear()


class NullRegistry(MetricsRegistry):
    """No-op registry handed out when telemetry is disabled: mutators
    return immediately, reads report empty.  Shared singleton, so
    instrumented call sites stay branch-free."""

    def __init__(self) -> None:
        super().__init__()

    @property
    def enabled(self) -> bool:
        return False

    def counter_inc(self, name, value=1.0, help=None, **labels):
        pass

    def gauge_set(self, name, value, help=None, **labels):
        pass

    def observe(self, name, value, buckets=_DEFAULT_BUCKETS, help=None,
                **labels):
        pass


_GLOBAL = MetricsRegistry()
_NULL = NullRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry when telemetry is on, else the shared
    :class:`NullRegistry`."""
    return _GLOBAL if telemetry_enabled() else _NULL
