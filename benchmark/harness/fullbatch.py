"""A cell that drives the ``sagecal`` fullbatch app in process: set-up,
the measured window, the traced run and the check.

Set-up: the kernels are built into the program's fixed build directory
inside the checkout (``sagecal_tpu_torch/_build/``; only a checkout's
first run builds), the observation is made on the card from the seed
(:mod:`benchmark.harness.inputs`), and one app run over the first tile,
at the cell's own shapes and flags, warms every kernel, library handle
and allocator pool the window will use.

The window runs the app over the whole observation again and again, as
a user runs it over successive observations, through the app's own
command-line configuration (``apps/cli.py::config_from_args``) and
``apps/fullbatch.py::run_fullbatch`` over the in-memory file.  It ends
with the first run that completes after ``--seconds``.  The rate is
every row of every completed run over their time; the peak is the
allocator's over the window.  After each run the benchmark keeps what
it will judge (:mod:`benchmark.harness.check`): that run's solutions
file and the column it wrote, all of it for the last run and, for the
others, one timeslot of each tile drawn from the seed; and, for a
calibration, the joint LBFGS calls that :class:`FitRecorder` sampled.

With ``--trace 1`` the window runs with the layer spans on
(:class:`benchmark.harness.devtrace.Probe`), and one more app run is
captured with the device markers on.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import numpy as np

from benchmark.harness import check as checks
from benchmark.harness import devtrace
from benchmark.harness.inputs import Observation, make_observation


@dataclasses.dataclass
class Spec:
    """What a fullbatch driver adds to the shared run."""

    flags: Callable  # (obs) -> the mix's own app flags
    judge: Callable  # (obs, runs, dev) -> numbers
    layers: dict  # apps.fullbatch name -> layer, for spans and markers
    keep_solutions: bool  # read each run's solutions file
    record_fits: bool = False  # sample the joint LBFGS's calls


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: dict
    checks: list
    device: dict
    reduction: Optional[devtrace.Reduction] = None
    spans: dict = dataclasses.field(default_factory=dict)
    tiles_profiled: int = 0
    shapes: dict = dataclasses.field(default_factory=dict)


def solver_flags(cfg: dict) -> list:
    """The configuration's solver settings as the app's flags."""
    return ["-t", str(cfg["tilesz"]), "-e", str(cfg["max_emiter"]),
            "-g", str(cfg["max_iter"]), "-l", str(cfg["max_lbfgs"]),
            "-m", str(cfg["lbfgs_m"]), "-j", str(cfg["solver_mode"]),
            "-L", str(cfg["nulow"]), "-H", str(cfg["nuhigh"])]


class App:
    """One observation's app runs: argv from the configuration, the mix
    and the files; each run's results, host seconds and divergences."""

    def __init__(self, cell, obs: Observation, spec: Spec, workdir: str):
        self.cell, self.obs, self.spec = cell, obs, spec
        self.solutions = os.path.join(workdir, "out.solutions")
        self.argv = (["-d", obs.path, "-s", obs.sky_path, "-c",
                      obs.cluster_path, "-p", self.solutions]
                     + solver_flags(cell.config) + ["--f32", "--fused"]
                     + list(spec.flags(obs)))

    def run(self, extra=()):
        import torch
        from sagecal_tpu_torch.apps.cli import build_parser, config_from_args
        from sagecal_tpu_torch.apps.fullbatch import run_fullbatch
        from sagecal_tpu_torch.io.memh5 import MemFile

        cfg = config_from_args(build_parser().parse_args(
            self.argv + list(extra)))
        lines = []

        def log(msg):
            lines.append(msg)
            self.cell.log(f"[app] {msg}")

        t = time.perf_counter()
        results = run_fullbatch(cfg, log=log, device=self.cell.device,
                                open_file=MemFile)
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        diverged = {int(ln.split()[1].rstrip(":")) // self.obs.tilesz
                    for ln in lines if ln.startswith("tile ")
                    and ": diverged (" in ln}
        return results, seconds, diverged


class FitRecorder:
    """Samples of the joint LBFGS's cost and gradient on the timed path
    (#3 and #4 on the card): wraps the solver's
    ``_make_fused_joint_cost`` (``solvers/sage.py``), whose every
    closure is one tile's fit, in the order the app solves its tiles.
    Of each fit it keeps the first call that asks for a gradient (at the
    EM's gains) and one more drawn from ``rng`` among the later ones (a
    reservoir of one): the parameters, the cost and, through a hook on
    the parameters, the gradient, as the program handed them to the
    LBFGS, left on the device until the window has closed."""

    def __init__(self, rng):
        self.rng = rng
        self.fits: list = []
        self._saved = None

    def install(self) -> None:
        import torch
        from sagecal_tpu_torch.solvers import sage

        real = sage._make_fused_joint_cost
        self._saved = (sage, real)

        def make(data, cdata, M, nchunk_max, n8, robust, mean_nu, *a, **kw):
            fn = real(data, cdata, M, nchunk_max, n8, robust, mean_nu,
                      *a, **kw)
            fit = {"nu": (torch.as_tensor(mean_nu).detach().clone()
                          if robust else None),
                   "samples": [None, None], "calls": 0}
            self.fits.append(fit)

            def cost_fn(pflat):
                if not pflat.requires_grad:
                    return fn(pflat)
                i = fit["calls"]
                fit["calls"] = i + 1
                slot = 0 if i == 0 else (
                    1 if self.rng.random() * i < 1.0 else None)
                out = fn(pflat)
                if slot is not None:
                    rec = {"p": pflat.detach().clone(), "cost": out.detach(),
                           "grad": None}
                    pflat.register_hook(
                        lambda g, rec=rec: rec.update(grad=g.detach().clone()))
                    fit["samples"][slot] = rec
                return out

            return cost_fn

        sage._make_fused_joint_cost = make

    def take(self) -> list:
        fits, self.fits = self.fits, []
        return fits

    def restore(self) -> None:
        if self._saved is not None:
            module, real = self._saved
            module._make_fused_joint_cost = real
            self._saved = None


def _snapshot(app: App, obs: Observation, results, diverged, last: bool,
              rng, fits) -> dict:
    """What the check needs of one app run (module doc)."""
    T = obs.tilesz
    column = "model" if "-a" in app.argv and \
        app.argv[app.argv.index("-a") + 1] != "0" else "corrected"
    spans = ([(t * T, (t + 1) * T) for t in range(obs.ntiles)] if last else
             [(a, a + 1) for a in (t * T + int(rng.integers(T))
                                   for t in range(obs.ntiles))])
    snap = {"results": list(results), "diverged": set(diverged),
            "columns": {(a, b): obs.read(column, a, b) for a, b in spans},
            "fits": fits}
    if app.spec.keep_solutions:
        from benchmark.harness.inputs import read_solutions

        snap["gains"] = read_solutions(app.solutions, obs.nstations)
    return snap


def run(cell, spec: Spec) -> Outcome:
    import torch
    from sagecal_tpu_torch.apps import fullbatch as fb
    from sagecal_tpu_torch.io import memh5

    dev = cell.device
    on_card = dev == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    marks = [("imports", time.perf_counter())]
    if on_card:
        from sagecal_tpu_torch.kernels.build import build_all

        build_all(["fused_cost"])
        marks.append(("kernels", time.perf_counter()))
    workdir = tempfile.mkdtemp(prefix="bench-", dir=tempfile.gettempdir())
    probe, recorder, undo = None, None, []
    try:
        obs = make_observation(cell.config, int(cell.mix["tiles_per_run"]),
                               cell.seed, dev, workdir)
        marks.append(("observation", time.perf_counter()))
        app = App(cell, obs, spec, workdir)
        undo = [patch(fb, obs) for patch in cell.program_patches]
        if cell.warmup:
            app.run(["-T", "1"])  # one tile at the cell's shapes
        if on_card:
            torch.cuda.synchronize()
        gc.collect()
        marks.append(("warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - cell.t_start
        t = cell.t_start
        parts = []
        for name, at in marks:
            parts.append(f"{name} {at - t:.3f}")
            t = at
        cell.log(f"[setup] {setup_s:.3f} s: {', '.join(parts)} s")

        if cell.trace:
            probe = devtrace.Probe()
            probe.install(fb, spec.layers)
        if spec.record_fits:
            recorder = FitRecorder(np.random.default_rng([cell.seed, 1]))
            recorder.install()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        rng = np.random.default_rng(cell.seed)
        runs, seconds = [], []
        t_open = time.perf_counter()
        while True:
            results, s, diverged = app.run()
            seconds.append(s)
            last = time.perf_counter() - t_open >= cell.seconds
            fits = recorder.take() if recorder is not None else []
            runs.append(_snapshot(app, obs, results, diverged, last, rng,
                                  fits))
            if last:
                break
        if recorder is not None:
            recorder.restore()
            recorder = None
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        rows = len(runs) * obs.ntime * obs.nbase
        e2e = {"vis_rows_per_s": rows / sum(seconds),
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        cell.log(f"[window] {len(runs)} runs of {obs.ntime * obs.nbase} "
                 f"rows: {', '.join(f'{s:.3f}' for s in seconds)} s")

        out = Outcome(attempted=len(runs) * obs.ntiles,
                      failed=sum(len(r["diverged"]) for r in runs),
                      e2e=e2e, checks=[], device={"memory_peak_bytes": peak},
                      shapes=dict(M=obs.nclusters, N=obs.nstations,
                                  rows=obs.tilesz * obs.nbase,
                                  F=len(obs.freqs), nc=1))
        if cell.trace:
            out.spans = {k: list(v) for k, v in probe.spans.items()}
            silent = sorted(set(spec.layers.values()) - set(out.spans))
            if silent:
                raise RuntimeError(f"layers never entered in the window: "
                                   f"{', '.join(silent)} (the app no longer "
                                   f"calls the names the probe wraps)")
            _, window_s, events = devtrace.profiled(app.run, probe)
            cell.log(f"[trace] profiled run {window_s:.3f} s beside the "
                     f"window's {', '.join(f'{s:.3f}' for s in seconds)} s; "
                     f"{len(events)} device operations")
            out.reduction = devtrace.reduce_trace(events, probe.marks,
                                                  window_s)
            cell.log(f"[trace] markers seen {out.reduction.markers[0]} of "
                     f"{out.reduction.markers[1]} launched, on one stream")
            out.tiles_profiled = obs.ntiles
        if probe is not None:
            probe.restore()
            probe = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        numbers = spec.judge(obs, runs, dev)
        cell.log("[numbers] " + " ".join(f"{k} {v!r}"
                                         for k, v in numbers.items()))
        if "res_ratio" in numbers:
            e2e["res_ratio"] = numbers["res_ratio"]
        out.checks = checks.judged(numbers, cell.limits)
        return out
    finally:
        if recorder is not None:
            recorder.restore()
        if probe is not None:
            probe.restore()
        for u in reversed(undo):
            u()
        memh5.remove(os.path.join(workdir, "vis.h5"))
        shutil.rmtree(workdir, ignore_errors=True)
