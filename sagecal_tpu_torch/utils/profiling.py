"""Per-phase wall-clock accounting (counterpart of
``sagecal_tpu/utils/profiling.py::PhaseTimer``).

:class:`PhaseTimer` sums the wall seconds of each named phase (load and
coherencies, solve, residual, write, ...) per tile and per run; each
phase is annotated with ``torch.profiler.record_function`` so a
``torch.profiler`` trace attributes device work to it, and with
``SAGECAL_TRACE=1`` each phase is a span of kind ``phase``
(``obs/trace.py``; its exit also feeds the flight recorder's stall
clock).  With telemetry
on, every phase's seconds are observed into the ``phase_seconds``
histogram of the process-wide registry.  A phase's time is the host's:
work the device has queued but not finished when the phase ends is
counted in the phase that waits for it.  The reference's profiler-trace
scope (``trace``, ``SAGECAL_PROFILE_DIR``) waits for ROADMAP.md's A11.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

from sagecal_tpu_torch.obs.registry import get_registry, telemetry_enabled
from sagecal_tpu_torch.obs.trace import get_tracer


class PhaseTimer:
    """Accumulates wall-clock per named phase across tiles."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._tile: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        # the disabled tracer hands back one shared no-op span
        with get_tracer().span(name, kind="phase"):
            with torch.profiler.record_function(name):
                yield
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self._tile[name] = self._tile.get(name, 0.0) + dt
        if telemetry_enabled():
            get_registry().observe(
                "phase_seconds", dt,
                help="wall-clock seconds per named pipeline phase",
                phase=name)

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
