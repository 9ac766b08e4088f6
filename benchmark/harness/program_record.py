"""The program's own record of the traced app run, read by the per-layer
metrics of source ``program_span``: the spans and host-read counts that
``sagecal_tpu_torch/obs/trace.py`` keeps, in memory, for an app run
that starts under a ``torch.profiler`` capture (the traced run's; the
warm-up and the window record nothing), through its ``last_record()``.
A program without that accessor, or a run that recorded nothing, reads
None.

Span names are the program's (``apps/fullbatch.py``, ``solvers/``):
``tile`` a tile; under it ``coherencies``, ``solve``, ``residual`` and
the app's own phases; under ``solve`` the EM (``sage.em``, its cluster
solves ``sage.em.cluster``) and the joint LBFGS (``sage.lbfgs``); a
``read:<site>`` span at each device-to-host read.

The readers (``metrics/em_host_reads_per_tile.py``,
``em_read_wait_s_per_tile.py``, ``em_wall_s_per_tile.py``,
``lbfgs_wall_s_per_tile.py``, ``app_self_s_per_tile.py``) are listed in
``BENCHMARK.json`` by no entry yet: an entry that lists its cell fails
the traced run of a program that keeps no record
(``run.py::result_line``), and the benchmark's own check
(``tests/test_bench_harness.py``) wants every entry to list its cells.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def last_record():
    """The program's record of its last recorded run, or None."""
    try:
        from sagecal_tpu_torch.obs import trace
    except ImportError:
        return None
    get = getattr(trace, "last_record", None)
    return None if get is None else get()


class Tree:
    """The record's spans by id, with each span's ancestors' names."""

    def __init__(self, rec):
        self.spans: List[dict] = list(rec.spans)
        self.by_id: Dict[str, dict] = {s["span_id"]: s for s in self.spans}
        self.tiles = [s for s in self.spans if s["name"] == "tile"]

    def named(self, name: str) -> List[dict]:
        return [s for s in self.spans if s["name"] == name]

    def under(self, span: dict, name: str) -> bool:
        """Whether a span named ``name`` encloses ``span``."""
        seen = set()
        pid = span.get("parent_id")
        while pid in self.by_id and pid not in seen:
            seen.add(pid)
            parent = self.by_id[pid]
            if parent["name"] == name:
                return True
            pid = parent.get("parent_id")
        return False

    def children(self, span: dict) -> List[dict]:
        return [s for s in self.spans
                if s.get("parent_id") == span["span_id"]]


def tree() -> Optional[Tree]:
    """The last record as a :class:`Tree`, None without one or without
    a ``tile`` span."""
    rec = last_record()
    if rec is None:
        return None
    t = Tree(rec)
    return t if t.tiles else None


def em_reads(t: Tree) -> List[dict]:
    """The ``read:*`` spans inside the EM (``sage.em``)."""
    return [s for s in t.spans
            if s["name"].startswith("read:") and t.under(s, "sage.em")]

