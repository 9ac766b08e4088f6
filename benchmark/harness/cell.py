"""A cell of ``BENCHMARK.json`` found by name, and the pieces the harness
finds by name beside it.

A workload names a configuration (``configs/<config>.json``) and a
traffic mix (``mixes/<traffic>.json``); the mix names its driver
(``drivers/<driver>.py``, a module with ``run(cell) -> Outcome``); the
cell's limits on the numbers its check compares are
``limits/<workload>.json``; each per-layer metric has a reader
``metrics/<metric name>.py`` with ``read(ctx) -> float or None``.  A
quantity split by cells (``idle_share.<config>``) is read by the file of
its full name where there is one, else by that of the name before its
first dot; an end-to-end metric split so is the harness's quantity of
that first part.  A new
configuration, mix, driver, limit set or metric is a new file and a new
entry in ``BENCHMARK.json``: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Callable, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file of the benchmark by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    bench_dir: str
    workload: dict  # the BENCHMARK.json entry
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    log: Callable = lambda msg: print(msg, file=sys.stderr, flush=True)
    # (apps.fullbatch module, observation) -> undo: the control's
    # stand-in for a stage of the program (benchmark/readings.py)
    program_patches: List[Callable] = dataclasses.field(default_factory=list)
    warmup: bool = True  # False: readings that time nothing

    @property
    def name(self) -> str:
        return self.workload["name"]

    def driver(self):
        name = self.mix["driver"]
        return load_module(os.path.join(self.bench_dir, "drivers",
                                        f"{name}.py"), f"bench_driver_{name}")


def benchmark_spec(bench_dir: str = BENCH_DIR) -> dict:
    """``BENCHMARK.json`` beside the benchmark's folder."""
    return _json(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))


def load_cell(name: str, seed: int, seconds: float, trace: bool,
              device: str, t_start: float, bench_dir: str = BENCH_DIR,
              spec: Optional[dict] = None) -> Cell:
    spec = benchmark_spec(bench_dir) if spec is None else spec
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = _json(os.path.join(os.path.dirname(bench_dir), conf["file"]))
    mix = _json(os.path.join(bench_dir, "mixes", f"{wl['traffic']}.json"))
    limits = _json(os.path.join(bench_dir, "limits", f"{name}.json"))
    return Cell(bench_dir=bench_dir, workload=wl, config=config, mix=mix,
                limits={k: float(v) for k, v in limits["limits"].items()},
                seed=int(seed), seconds=float(seconds), trace=bool(trace),
                device=device, t_start=t_start)


@dataclasses.dataclass
class LayerContext:
    """What a per-layer reader reads: the traced run's reduction (None
    without one), the host spans of the window's layer calls, the tiles
    the traced run covered and the cell's shapes (M clusters, N
    stations, rows a tile, F channels, nc chunks a cluster)."""

    reduction: object
    spans: dict
    tiles: int
    shapes: dict


def base_name(name: str) -> str:
    """The quantity a metric's name splits by cells (module doc)."""
    return name.split(".")[0]


def read_metric(bench_dir: str, name: str, ctx: LayerContext):
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(bench_dir, "metrics", f"{base_name(name)}.py")
    mod = load_module(path, "bench_metric_" + name.replace(".", "_"))
    return mod.read(ctx)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]
