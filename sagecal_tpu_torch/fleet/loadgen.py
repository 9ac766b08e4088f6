"""Synthetic-tenant load harness: seeded open-loop arrivals vs a live fleet
(counterpart of ``sagecal_tpu/fleet/loadgen.py``).

ROADMAP item 3 wants scaling decisions driven by measured saturation,
which needs a load generator with three properties the ad-hoc benches
lack:

1. **deterministic** — the whole tenant population and every arrival
   instant derive from one seed (``random.Random``), so a load run is
   replayable and a schedule regression is byte-diffable;
2. **open-loop** — arrivals follow the schedule regardless of how the
   fleet is coping (closed-loop generators back off exactly when the
   system saturates, hiding the knee this harness exists to find);
3. **honest ground truth** — the offered load per step is recorded at
   submission time (``load_steps.json``), so the capacity analysis
   (obs/capacity.py) compares served throughput against what was
   *actually offered*, not against a nominal rate.

The population is heterogeneous on purpose: tenants cycle the serve
shape classes (different buckets), get staggered deadlines and
harmonically-decaying traffic weights — enough spread to exercise
bucket affinity, EDF ordering and per-tenant burn accounting in one
run.  Arrival processes are pluggable:

- ``poisson`` — exponential inter-arrivals at a constant mean rate;
- ``onoff``   — MMPP-style bursts: alternating ON/OFF phases with
  exponential phase lengths, each phase a Poisson process at its own
  rate;
- ``ramp``    — stepped offered rates (the saturation-sweep mode: each
  step is one point on the throughput-vs-offered-load curve).

:class:`LoadRunner` submits the schedule as real queue items against a
live coordinator+worker fleet (reusing FleetCoordinator for spawn /
respawn / timeline / elastic duties), then runs the capacity analysis
and writes ``load_report.json``.  The tenants' datasets are predicted on
``device`` (CUDA unless ``device="cpu"``) and written with ``open_file``
(``io/dataset.py``); :func:`tenant_datasets` is a pure function of the
:class:`LoadSpec`, so a worker process holding its own ``MemFile``
registry rebuilds the same datasets at the same paths.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import time
from typing import Any, Dict, List, Tuple

ARRIVAL_KINDS = ("poisson", "onoff", "ramp")

# v2: the doc carries a writer-identity stamp (obs/ledger.py accepts
# both versions)
LOAD_STEPS_SCHEMA_VERSION = 2


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One load run: the population and the arrival process."""

    arrival: str = "ramp"          # poisson | onoff | ramp
    # poisson / onoff
    rate: float = 1.0              # mean arrivals/s (ON-phase for onoff)
    rate_off: float = 0.0          # onoff OFF-phase rate
    mean_on_s: float = 8.0         # onoff mean phase lengths
    mean_off_s: float = 8.0
    duration_s: float = 30.0       # poisson/onoff run length
    # ramp (the saturation sweep)
    rates: Tuple[float, ...] = (0.25, 0.75, 2.0)
    step_s: float = 12.0
    # population
    tenants: int = 2
    seed: int = 23
    tilesz: int = 2
    deadline_s: float = 4.0        # base deadline; odd tenants get 1.5x
    availability: float = 0.9
    shed_burn: float = 3.0
    alert_burn: float = 2.0
    windows_s: Tuple[float, float] = (30.0, 120.0)
    # drain after the last arrival (0 = wait for full drain)
    drain_timeout_s: float = 0.0
    # lead-in between worker spawn and the schedule clock: workers pay
    # interpreter+torch startup before their first claim, and a capacity
    # sweep that starts submitting into that window mislabels startup
    # lag as saturation of the first step
    warmup_s: float = 0.0

    def __post_init__(self):
        if self.arrival not in ARRIVAL_KINDS:
            raise ValueError(
                f"arrival must be one of {ARRIVAL_KINDS}, "
                f"got {self.arrival!r}")
        if self.tenants < 1:
            raise ValueError("tenants must be >= 1")
        if self.arrival == "ramp" and not self.rates:
            raise ValueError("ramp arrival needs at least one rate")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One synthetic tenant: traffic share, request shape, SLO."""

    name: str
    weight: float
    shape: Tuple[int, int, int]    # (nstations, ntime, nchan)
    deadline_s: float
    availability: float
    shed_burn: float
    alert_burn: float
    windows_s: Tuple[float, float]


def build_population(spec: LoadSpec) -> List[TenantSpec]:
    """Deterministic heterogeneous tenant set: shapes cycle the serve
    shape classes (mixed buckets), weights decay harmonically (tenant 0
    dominates traffic), odd tenants get a 1.5x looser deadline."""
    from sagecal_tpu_torch.serve.synthetic import SHAPE_CLASSES

    pop: List[TenantSpec] = []
    norm = sum(1.0 / (i + 1) for i in range(spec.tenants))
    for i in range(spec.tenants):
        pop.append(TenantSpec(
            name=f"tenant{i}",
            weight=(1.0 / (i + 1)) / norm,
            shape=SHAPE_CLASSES[i % len(SHAPE_CLASSES)],
            deadline_s=spec.deadline_s * (1.5 if i % 2 else 1.0),
            availability=spec.availability,
            shed_burn=spec.shed_burn,
            alert_burn=spec.alert_burn,
            windows_s=spec.windows_s))
    return pop


# ---------------------------------------------------------------------------
# seeded arrival schedules


def _poisson_times(rng: random.Random, rate: float, t0: float,
                   t1: float) -> List[float]:
    out: List[float] = []
    if rate <= 0.0:
        return out
    t = t0 + rng.expovariate(rate)
    while t < t1:
        out.append(t)
        t += rng.expovariate(rate)
    return out


def build_schedule(spec: LoadSpec) -> Tuple[List[Dict[str, Any]],
                                            List[Dict[str, Any]]]:
    """The full run plan from one seed: ``(arrivals, steps)`` with
    run-relative times.  Each arrival is ``{"t", "request_id",
    "tenant"}``; each step is ``{"index", "t0", "t1", "offered_rate",
    "arrivals"}`` — the per-step offered-load ground truth the
    capacity curve is plotted against.  Same seed, same spec ->
    byte-identical schedule (pinned by a test)."""
    rng = random.Random(spec.seed)
    pop = build_population(spec)
    names = [t.name for t in pop]
    weights = [t.weight for t in pop]
    times: List[float] = []
    steps: List[Dict[str, Any]] = []
    if spec.arrival == "poisson":
        times = _poisson_times(rng, spec.rate, 0.0, spec.duration_s)
        steps = [{"index": 0, "t0": 0.0, "t1": spec.duration_s,
                  "offered_rate": spec.rate}]
    elif spec.arrival == "ramp":
        for k, r in enumerate(spec.rates):
            t0, t1 = k * spec.step_s, (k + 1) * spec.step_s
            times += _poisson_times(rng, float(r), t0, t1)
            steps.append({"index": k, "t0": t0, "t1": t1,
                          "offered_rate": float(r)})
    else:  # onoff (MMPP-style alternating-phase Poisson)
        t = 0.0
        k = 0
        on = True
        while t < spec.duration_s:
            mean = spec.mean_on_s if on else spec.mean_off_s
            rate = spec.rate if on else spec.rate_off
            dur = rng.expovariate(1.0 / mean) if mean > 0 else 0.0
            t1 = min(t + max(dur, 1e-6), spec.duration_s)
            times += _poisson_times(rng, rate, t, t1)
            steps.append({"index": k, "t0": t, "t1": t1,
                          "offered_rate": rate,
                          "phase": "on" if on else "off"})
            t = t1
            k += 1
            on = not on
    times.sort()
    arrivals = [{"t": round(t, 6),
                 "request_id": f"load-{i:05d}",
                 "tenant": rng.choices(names, weights=weights)[0]}
                for i, t in enumerate(times)]
    for s in steps:
        s["arrivals"] = sum(1 for a in arrivals
                            if s["t0"] <= a["t"] < s["t1"])
    return arrivals, steps


def schedule_json(spec: LoadSpec) -> str:
    """Canonical serialization of the schedule (the determinism
    fixture diffs these bytes across rebuilds)."""
    arrivals, steps = build_schedule(spec)
    return json.dumps({"arrivals": arrivals, "steps": steps},
                      sort_keys=True, separators=(",", ":"))


# ---------------------------------------------------------------------------
# workload materialization (datasets + manifests)


def tenant_datasets(workdir: str, spec: LoadSpec, open_file=None,
                    device=None) -> Tuple[str, Dict[str, str]]:
    """The sky files and one simulated dataset per tenant shape under
    ``workdir``: ``(sky path, {tenant: dataset path})``.  A pure function
    of ``spec`` (and the paths), so every process that calls it makes
    the same datasets."""
    import numpy as np
    import torch

    from sagecal_tpu_torch.io.dataset import _opener, simulate_dataset
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.serve.synthetic import _CLUSTER, _SKY

    os.makedirs(workdir, exist_ok=True)
    pop = build_population(spec)
    sky = os.path.join(workdir, "sky.txt")
    # tmp + replace: a worker rebuilding its datasets never shows another
    # process a half-written sky file
    for path, text in ((sky, _SKY), (sky + ".cluster", _CLUSTER)):
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    dec0 = math.radians(51.0)
    clusters, _, _ = load_sky(sky, sky + ".cluster", 0.0, dec0,
                              dtype=torch.float64, device=device)
    datasets: Dict[str, str] = {}
    for i, ten in enumerate(pop):
        nstations, ntime, nchan = ten.shape
        path = os.path.join(workdir,
                            f"{ten.name}_N{nstations}.vis.h5")
        simulate_dataset(
            path, nstations=nstations, ntime=ntime, nchan=nchan,
            clusters=clusters,
            jones=random_jones(len(clusters), nstations,
                               seed=17 + i, amp=0.1,
                               dtype=np.complex128, device=device),
            noise_sigma=1e-4, seed=i, dec0=dec0, open_file=open_file,
            device=device)
        with _opener(open_file)(path, "r+") as f:
            f.attrs["ra0"] = 0.0
            f.attrs["dec0"] = dec0
        datasets[ten.name] = path
    return sky, datasets


def materialize_workload(workdir: str, spec: LoadSpec,
                         arrivals, open_file=None,
                         device=None) -> Dict[str, str]:
    """Simulate one dataset per tenant shape (:func:`tenant_datasets`,
    on ``device`` through ``open_file``), write ``slo.json`` and a
    ``requests.json`` covering every scheduled arrival (small solver
    budgets — load runs measure the fleet, not the solver).  Returns
    ``{"requests": ..., "slo": ...}`` paths."""
    pop = build_population(spec)
    sky, datasets = tenant_datasets(workdir, spec, open_file=open_file,
                                    device=device)
    slo_path = os.path.join(workdir, "slo.json")
    with open(slo_path, "w") as f:
        json.dump({"slos": [
            {"tenant": t.name, "deadline_s": t.deadline_s,
             "availability": t.availability,
             "windows_s": list(t.windows_s),
             "alert_burn": t.alert_burn,
             "shed_burn": t.shed_burn} for t in pop]}, f, indent=1)
    by_name = {t.name: t for t in pop}
    counters: Dict[str, int] = {}
    requests: List[dict] = []
    for a in arrivals:
        ten = by_name[a["tenant"]]
        _, ntime, _ = ten.shape
        ntiles = max(ntime // spec.tilesz, 1)
        k = counters.get(ten.name, 0)
        counters[ten.name] = k + 1
        requests.append({
            "request_id": a["request_id"],
            "tenant": ten.name,
            "dataset": datasets[ten.name],
            "sky_model": sky,
            "t0": (k % ntiles) * spec.tilesz,
            "tilesz": spec.tilesz,
            "solver_mode": 1,
            "max_emiter": 1, "max_iter": 2, "max_lbfgs": 4,
        })
    manifest = os.path.join(workdir, "requests.json")
    tmp = f"{manifest}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"requests": requests}, f, indent=1)
    os.replace(tmp, manifest)
    return {"requests": manifest, "slo": slo_path}


# ---------------------------------------------------------------------------
# the open-loop runner


class LoadRunner:
    """Drive one load run against a live fleet.

    Reuses :class:`fleet.coordinator.FleetCoordinator` for everything
    fleet-shaped (spawn, timeline sampling, bounded respawn, elastic
    honor, shutdown, summary); owns only the open-loop submission —
    items enter the shared queue at their scheduled instants whether
    or not the fleet is keeping up."""

    def __init__(self, cfg, spec: LoadSpec, log=print,
                 clock=time.time, device=None, open_file=None,
                 argv_fn=None):
        self.cfg = cfg
        self.spec = spec
        self.log = log
        self.clock = clock
        # the tenants' datasets are predicted on ``device`` (None: the
        # card) and opened with ``open_file``; the workers run on
        # ``device`` too, or as ``argv_fn(cfg, slot)`` says
        self.device = device
        self.open_file = open_file
        self.argv_fn = argv_fn

    def _make_item(self, req, deadline_s: float, hint: str,
                   large: bool, now: float):
        from sagecal_tpu_torch.fleet.queue import WorkItem

        return WorkItem(
            request_id=req.request_id, tenant=req.tenant,
            request={k: v for k, v in req.__dict__.items()},
            deadline=now + deadline_s,
            bucket_hint=hint, enqueued_at=now, large=large)

    def run(self, elog=None) -> Dict[str, Any]:
        import functools

        from sagecal_tpu_torch.apps.fleet import worker_argv
        from sagecal_tpu_torch.fleet.coordinator import (
            FleetCoordinator, bucket_hint_for,
        )
        from sagecal_tpu_torch.io.dataset import VisDataset
        from sagecal_tpu_torch.obs.capacity import (
            analyze_load_run, format_load_report,
        )
        from sagecal_tpu_torch.obs.slo import load_slo_specs
        from sagecal_tpu_torch.serve.request import load_requests

        cfg, spec = self.cfg, self.spec
        os.makedirs(cfg.out_dir, exist_ok=True)
        arrivals, steps = build_schedule(spec)
        if not arrivals:
            raise ValueError("load schedule is empty — raise the "
                             "rate or the duration")
        paths = materialize_workload(
            os.path.join(cfg.out_dir, "workload"), spec, arrivals,
            open_file=self.open_file, device=self.device)
        cfg.requests = paths["requests"]
        cfg.slo = cfg.slo or paths["slo"]
        specs = load_slo_specs(cfg.slo)
        requests = {r.request_id: r
                    for r in load_requests(cfg.requests)}
        # one meta probe per dataset: bucket hints + placement flags
        # without reopening HDF5 at submit time
        meta_by_path: Dict[str, Any] = {}
        for r in requests.values():
            p = os.path.abspath(r.dataset)
            if p not in meta_by_path:
                with VisDataset(p, "r", self.open_file) as ds:
                    meta_by_path[p] = ds.meta
        argv_fn = self.argv_fn or functools.partial(worker_argv,
                                                    device=self.device)
        coord = FleetCoordinator(cfg, log=self.log, clock=self.clock,
                                 argv_fn=argv_fn, open_file=self.open_file)
        coord.setup_observability(specs=specs, elog=elog)
        self.log(
            f"load: {len(arrivals)} arrivals over {len(steps)} steps "
            f"({spec.arrival}, seed {spec.seed}, "
            f"{spec.tenants} tenants) vs {cfg.workers} workers")
        if elog is not None:
            elog.emit("load_started", arrival=spec.arrival,
                      seed=spec.seed, tenants=spec.tenants,
                      arrivals=len(arrivals), steps=len(steps),
                      workers=cfg.workers)
        submitted: List[Dict[str, Any]] = []
        try:
            coord.spawn_workers()
            t_ready = self.clock() + max(spec.warmup_s, 0.0)
            while True:
                now = self.clock()
                if now >= t_ready:
                    break
                coord.poll_duties(now)
                time.sleep(min(max(cfg.poll_s, 0.05), t_ready - now))
            t_start = self.clock()
            for a in arrivals:
                target = t_start + a["t"]
                while True:
                    now = self.clock()
                    if now >= target:
                        break
                    coord.poll_duties(now)
                    time.sleep(min(max(cfg.poll_s, 0.05),
                                   target - now))
                req = requests[a["request_id"]]
                meta = meta_by_path[os.path.abspath(req.dataset)]
                sp = specs.get(req.tenant)
                now = self.clock()
                coord.queue.put(self._make_item(
                    req,
                    sp.deadline_s if sp else float("inf"),
                    bucket_hint_for(meta, req.tilesz),
                    bool(cfg.large_stations
                         and meta.nstations >= cfg.large_stations),
                    now))
                submitted.append(dict(a, submitted_at=now))
            self._write_load_steps(t_start, steps, submitted)
            drained = coord.watch(timeout_s=spec.drain_timeout_s,
                                  poll_s=max(cfg.poll_s, 0.05))
        finally:
            coord.shutdown()
            coord.close_observability()
        report = analyze_load_run(cfg.out_dir, specs)
        report["drained"] = drained
        report["wall_s"] = self.clock() - t_start
        report["workers"] = cfg.workers
        rpath = os.path.join(cfg.out_dir, "load_report.json")
        tmp = f"{rpath}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        os.replace(tmp, rpath)
        if elog is not None:
            elog.emit("load_done", drained=drained,
                      wall_s=report["wall_s"],
                      manifests=report["manifests"],
                      served=report["served"], shed=report["shed"],
                      errors=report["errors"],
                      saturation_throughput_solves_per_sec=report[
                          "saturation_throughput_solves_per_sec"],
                      shed_rate_under_overload=report[
                          "shed_rate_under_overload"],
                      goodput_fraction_at_saturation=report[
                          "goodput_fraction_at_saturation"])
        self.log(format_load_report(report))
        return report

    def _write_load_steps(self, t_start: float, steps, submitted
                          ) -> None:
        """The offered-load ground truth, stamped at submission time:
        planned step windows shifted to absolute timestamps plus the
        realized arrival record (scheduled vs actual submit instants).
        Written before the drain so a killed run keeps its truth."""
        doc = {
            "schema_version": LOAD_STEPS_SCHEMA_VERSION,
            "kind": "load_steps",
            "seed": self.spec.seed,
            "arrival": dataclasses.asdict(self.spec),
            "t_start": t_start,
            "steps": [dict(s, t0=t_start + s["t0"],
                           t1=t_start + s["t1"]) for s in steps],
            "submitted": submitted,
        }
        from sagecal_tpu_torch.obs.events import writer_identity

        doc["writer"] = writer_identity()
        doc["pid"] = os.getpid()
        path = os.path.join(self.cfg.out_dir, "load_steps.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
