"""The ``load`` subcommand: synthetic-tenant load harness vs a live fleet
(counterpart of ``sagecal_tpu/apps/load.py``).

Builds a seeded tenant population + open-loop arrival schedule
(fleet/loadgen.py), spawns a real coordinator+worker fleet, submits
requests at their scheduled instants, then runs the capacity analysis
(obs/capacity.py) and writes ``load_report.json`` next to the result
manifests, ``timeline.jsonl`` and ``load_steps.json``.  The workers and
the tenants' datasets run on the CUDA device unless the caller passes
``device="cpu"``; the reference's ``diag load`` renderer comes with
ROADMAP.md's A11.

Exit codes: 0 queue fully drained; 4 requests left undrained.
"""

from __future__ import annotations

import argparse
import sys

from sagecal_tpu_torch.apps.config import FleetConfig
from sagecal_tpu_torch.fleet.loadgen import ARRIVAL_KINDS, LoadSpec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.apps.cli load",
        description="Seeded open-loop load generator driving a live "
        "coordinator+worker fleet; records offered-load ground truth, "
        "a live timeline, and the capacity report.")
    ap.add_argument("--out-dir", default="load-out")
    ap.add_argument("--queue-dir", default="",
                    help="shared queue directory "
                    "(default <out-dir>/queue)")
    ap.add_argument("--aot-store", default="",
                    help="shared AOT artifact store "
                    "(default <out-dir>/aot-store)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--arrival", choices=ARRIVAL_KINDS,
                    default="ramp",
                    help="open-loop arrival process")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="mean arrivals/s (poisson; onoff ON phase)")
    ap.add_argument("--rate-off", type=float, default=0.0,
                    help="onoff OFF-phase rate")
    ap.add_argument("--mean-on", type=float, default=8.0,
                    help="onoff mean ON-phase length (s)")
    ap.add_argument("--mean-off", type=float, default=8.0,
                    help="onoff mean OFF-phase length (s)")
    ap.add_argument("--duration", type=float, default=30.0,
                    help="poisson/onoff run length (s)")
    ap.add_argument("--rates", default="0.25,0.75,2.0",
                    help="ramp: comma-separated offered rates "
                    "(arrivals/s), one load step each")
    ap.add_argument("--step", type=float, default=12.0,
                    help="ramp: seconds per load step")
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--tilesz", type=int, default=2)
    ap.add_argument("--deadline", type=float, default=4.0,
                    help="base tenant SLO deadline (s); odd tenants "
                    "get 1.5x")
    ap.add_argument("--availability", type=float, default=0.9)
    ap.add_argument("--shed-burn", type=float, default=3.0,
                    help="short-window burn rate that trips admission "
                    "shedding")
    ap.add_argument("--warmup", type=float, default=0.0,
                    help="lead-in (s) between worker spawn and the "
                    "schedule clock, so worker startup lag is not "
                    "mislabeled as saturation of the first step")
    ap.add_argument("--drain-timeout", type=float, default=0.0,
                    help="give up waiting for the drain after this "
                    "many seconds (0 = wait for full drain)")
    ap.add_argument("--overload-policy",
                    choices=("shed", "degrade", "off"),
                    default="shed",
                    help="admission action under overload (load runs "
                    "default to shed so the shed-rate metric is "
                    "exercised)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lease-ttl", type=float, default=30.0)
    ap.add_argument("--poll", type=float, default=0.2)
    ap.add_argument("--max-idle", type=float, default=30.0,
                    help="worker idle exit (generous: an OFF phase "
                    "must not drain the fleet)")
    ap.add_argument("--max-respawns", type=int, default=2)
    ap.add_argument("--elastic-workers", action="store_true",
                    help="act on the autoscale recommender "
                    "(report-only otherwise)")
    ap.add_argument("--min-workers", type=int, default=1)
    ap.add_argument("--max-workers", type=int, default=0)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("-V", "--verbose", action="store_true")
    return ap


def config_from_args(args) -> FleetConfig:
    return FleetConfig(
        out_dir=args.out_dir, queue_dir=args.queue_dir,
        aot_store=args.aot_store, workers=args.workers,
        batch=args.batch, lease_ttl_s=args.lease_ttl,
        poll_s=args.poll, max_idle_s=args.max_idle,
        overload_policy=args.overload_policy,
        use_f64=not args.f32, verbose=args.verbose,
        max_respawns=args.max_respawns,
        elastic_workers=args.elastic_workers,
        min_workers=args.min_workers, max_workers=args.max_workers,
        open_loop=True)


def spec_from_args(args) -> LoadSpec:
    rates = tuple(float(r) for r in str(args.rates).split(",") if r)
    return LoadSpec(
        arrival=args.arrival, rate=args.rate, rate_off=args.rate_off,
        mean_on_s=args.mean_on, mean_off_s=args.mean_off,
        duration_s=args.duration, rates=rates, step_s=args.step,
        tenants=args.tenants, seed=args.seed, tilesz=args.tilesz,
        deadline_s=args.deadline, availability=args.availability,
        shed_burn=args.shed_burn,
        drain_timeout_s=args.drain_timeout, warmup_s=args.warmup)


def main(argv=None, device=None, open_file=None, argv_fn=None,
         log=print) -> int:
    """The ``load`` command line: the tenants' datasets and the workers
    on ``device`` (None: the card), the datasets opened with
    ``open_file``, the workers started as ``argv_fn(cfg, slot)`` says
    (None: ``apps/fleet.py::worker_argv``).  Returns the exit code: 0
    when the queue drained, 4 when requests were left undrained."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    spec = spec_from_args(args)
    from sagecal_tpu_torch.apps.fleet import _obs_setup, _obs_teardown
    from sagecal_tpu_torch.fleet.loadgen import LoadRunner

    elog = _obs_setup(cfg, "loadgen", "cpu")
    try:
        report = LoadRunner(cfg, spec, log=log, device=device,
                            open_file=open_file,
                            argv_fn=argv_fn).run(elog=elog)
    finally:
        _obs_teardown(elog)
    return 0 if report.get("drained") else 4


if __name__ == "__main__":
    sys.exit(main())
