"""Per-phase wall-clock accounting (counterpart of
``sagecal_tpu/utils/profiling.py::PhaseTimer``).

:class:`PhaseTimer` sums the wall seconds of each named phase (load and
coherencies, solve, residual, write, ...) per tile and per run; each
phase is annotated with ``torch.profiler.record_function`` so a
``torch.profiler`` trace attributes device work to it, and while the
tracer records (``obs/trace.py``: ``SAGECAL_TRACE=1``, or an app run
started under a ``torch.profiler`` capture) each phase is a span of
kind ``phase``, its seconds the span's own stamps (its exit also feeds
the flight recorder's stall clock); off, the phase reads the same
clock, ``obs/trace.py::clock_ns``.  With telemetry
on, every phase's seconds are observed into the ``phase_seconds``
histogram of the process-wide registry and its memory watermark is
sampled (``obs/perf.py::record_memory_watermark``).  A phase's time is
the host's: work the device has queued but not finished when the phase
ends is counted in the phase that waits for it.

``SAGECAL_PROFILE_DIR=/some/dir`` (or :func:`trace` entered by hand)
captures a ``torch.profiler`` trace of the run (CPU and, on the card,
CUDA activity) into that directory as gzipped Chrome JSON, which ``diag
roofline`` and Perfetto read.  :func:`trace` stops the capture it
started on every exit, so a crashed run still leaves a loadable trace;
nested under an active one it passes through (the owner stops it).
The bare :func:`start_trace` / :func:`stop_trace` pair stays for REPL
use.
"""

from __future__ import annotations

import contextlib
import os
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

from sagecal_tpu_torch.obs.registry import get_registry, telemetry_enabled
from sagecal_tpu_torch.obs.trace import clock_ns, get_tracer

_TRACE_DIR_ENV = "SAGECAL_PROFILE_DIR"
_active_trace: Optional[dict] = None


def active_trace() -> Optional[str]:
    """The directory of the running trace, or None."""
    return None if _active_trace is None else _active_trace["dir"]


def start_trace(log_dir: Optional[str] = None,
                device=None) -> Optional[str]:
    """Begin a profiler trace (idempotent).  Returns the directory, or
    None when tracing is not requested (argument or
    ``SAGECAL_PROFILE_DIR``).  ``device`` the run's (None: the card)."""
    global _active_trace
    if _active_trace is not None:
        return _active_trace["dir"]
    log_dir = log_dir or os.environ.get(_TRACE_DIR_ENV)
    if not log_dir:
        return None
    from sagecal_tpu_torch.obs.devprof import begin_capture

    _active_trace = begin_capture(log_dir, device)
    return log_dir


def stop_trace() -> Optional[str]:
    """Stop the running trace; the path of the trace file written."""
    global _active_trace
    if _active_trace is None:
        return None
    from sagecal_tpu_torch.obs.devprof import end_capture

    cap, _active_trace = _active_trace, None
    return end_capture(cap)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None,
          device=None) -> Iterator[Optional[str]]:
    """Exception-safe trace scope (module doc): yields the directory
    (None when tracing is off) and always stops a trace it started."""
    owner = _active_trace is None
    d = start_trace(log_dir, device)
    try:
        yield d
    except BaseException:
        if owner and d is not None and _active_trace is not None:
            try:
                stop_trace()
            except RuntimeError:
                pass
        raise
    if owner and d is not None:
        stop_trace()


class PhaseTimer:
    """Accumulates wall-clock per named phase across tiles."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._tile: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        # the disabled tracer hands back one shared no-op span
        t0 = clock_ns()
        span = get_tracer().span(name, kind="phase").start(t0)
        try:
            with torch.profiler.record_function(name):
                yield
        except BaseException as e:
            span.stop(error=type(e))
            raise
        t1 = clock_ns()
        span.stop(t1)
        dt = (t1 - t0) * 1e-9
        self.totals[name] += dt
        self.counts[name] += 1
        self._tile[name] = self._tile.get(name, 0.0) + dt
        if telemetry_enabled():
            get_registry().observe(
                "phase_seconds", dt,
                help="wall-clock seconds per named pipeline phase",
                phase=name)
            from sagecal_tpu_torch.obs.perf import record_memory_watermark

            record_memory_watermark(name)

    def tile_timings(self) -> Dict[str, float]:
        """The current per-tile window (not reset): the per-tile payload
        of the JSONL event log."""
        return dict(self._tile)

    def tile_summary(self) -> str:
        """One-line per-tile breakdown; resets the per-tile window."""
        s = " ".join(f"{k}={v:.2f}s" for k, v in self._tile.items())
        self._tile = {}
        return s

    def run_summary(self) -> str:
        parts = [
            f"{k}: {self.totals[k]:.2f}s/{self.counts[k]}x"
            for k in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "phase totals: " + ", ".join(parts)
