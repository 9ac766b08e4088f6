"""``fleet``: a coordinator and worker processes over a shared
filesystem work queue (``fleet/``); counterpart of
``sagecal_tpu/apps/fleet.py``, with the same flags and defaults.

Two roles share one entry point:

- ``--role coordinator`` (default) seeds the queue from the request
  manifest, spawns ``--workers`` worker subprocesses, watches the
  lease files, and prints the merged fleet summary;
- ``--role worker`` (normally spawned by the coordinator, but valid
  standalone: point any number of processes at the same queue
  directory) runs the claim-solve-complete loop.

Workers share the built kernel libraries through the kernel store
(``serve/aot_store.py``): only the first worker builds them.  The
command line means the card; :func:`main` and :func:`run_coordinator`
take ``device`` for Python callers, and with ``device="cpu"`` the
spawned workers run on the CPU too (:func:`worker_argv`).
:func:`run_worker` runs one worker in this process (the tests'
in-process worker).  ``open_file``: the datasets' opener (``io.dataset``).

Exit codes: 0 queue fully drained; 4 requests left undrained; 2 for a
usage error or ``--profile-worker`` / ``SAGECAL_PROFILE_DIR``
(ROADMAP.md, A11).
"""

from __future__ import annotations

import argparse
import os
import sys

from sagecal_tpu_torch.apps.config import FleetConfig

# a worker process on a device other than the card's default
_WORKER_ENTRY = ("import sys; from sagecal_tpu_torch.apps.fleet import "
                 "main; sys.exit(main(sys.argv[1:], device={device!r}))")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.apps.cli fleet",
        description="Coordinator + N workers draining a shared "
        "filesystem work queue with atomic lease files.")
    ap.add_argument("--requests", default="",
                    help="request manifest (JSON; serve/request.py)")
    ap.add_argument("--out-dir", default="fleet-out")
    ap.add_argument("--queue-dir", default="",
                    help="shared queue directory "
                    "(default <out-dir>/queue)")
    ap.add_argument("--aot-store", default="",
                    help="shared kernel store (serve/aot_store.py; "
                    "default <out-dir>/aot-store)")
    ap.add_argument("--workers", type=int, default=2,
                    help="worker subprocesses the coordinator spawns")
    ap.add_argument("--role", choices=("coordinator", "worker"),
                    default="coordinator")
    ap.add_argument("--worker-id", default="",
                    help="stable worker identity (worker role)")
    ap.add_argument("--batch", type=int, default=4,
                    help="max requests claimed (and batched) per cycle")
    ap.add_argument("--lease-ttl", type=float, default=30.0,
                    help="lease expiry; a killed worker's claims "
                    "requeue after this many seconds")
    ap.add_argument("--poll", type=float, default=0.2,
                    help="idle queue poll period (s)")
    ap.add_argument("--max-idle", type=float, default=10.0,
                    help="worker exits after this long with nothing "
                    "claimable")
    ap.add_argument("--large-stations", type=int, default=0,
                    help="requests with >= this many stations are "
                    "placed on sharded_joint_fit across all local "
                    "devices when there are several (0 = always use "
                    "batch lanes)")
    ap.add_argument("--overload-policy",
                    choices=("shed", "degrade", "off"),
                    default="degrade",
                    help="admission action while a tenant's SLO "
                    "shed_burn threshold is tripped")
    ap.add_argument("--degrade-emiter", type=int, default=1)
    ap.add_argument("--degrade-lbfgs", type=int, default=4)
    ap.add_argument("--max-streams", type=int, default=8,
                    help="cap on concurrently open prefetch streams "
                    "per worker (LRU-evicted above)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="ignore --requests and seed N synthetic "
                    "requests (coordinator role)")
    ap.add_argument("--tenants", type=int, default=2,
                    help="tenant count for --synthetic")
    ap.add_argument("-e", "--max-emiter", type=int, default=3)
    ap.add_argument("-g", "--max-iter", type=int, default=2)
    ap.add_argument("-l", "--max-lbfgs", type=int, default=10)
    ap.add_argument("-m", "--lbfgs-m", type=int, default=7)
    ap.add_argument("-j", "--solver-mode", type=int, default=3)
    ap.add_argument("-L", "--nulow", type=float, default=2.0)
    ap.add_argument("-H", "--nuhigh", type=float, default=30.0)
    ap.add_argument("-R", "--no-randomize", action="store_true")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32")
    ap.add_argument("--fused", action="store_true",
                    help="route workers' batch solves through the fused "
                    "CUDA kernels: one batched launch per bucket when "
                    "the capability checks pass.  Requires --f32; "
                    "ignored under f64")
    ap.add_argument("--coh-dtype", choices=("f32", "bf16"), default="f32",
                    help="coherency-stack storage dtype on the fused "
                    "paths (bf16 halves the dominant HBM stream, f32 "
                    "accumulation)")
    ap.add_argument("--slo", default="",
                    help="per-tenant SLO specs (slo.json); also drives "
                    "admission control deadlines; falls back to a "
                    "'slos' key in the request manifest")
    ap.add_argument("--shadow-rate", type=float, default=0.0,
                    help="fraction of requests each worker shadow "
                    "re-solves on the torch-op/f32 reference path after "
                    "their manifests land, appending drift records to "
                    "the shared <out-dir>/drift.jsonl (obs/shadow.py)")
    ap.add_argument("--shadow-budget-s", type=float, default=120.0,
                    help="per-worker wall-clock budget for shadow "
                    "re-solves; sampled requests past it are skipped "
                    "and counted")
    ap.add_argument("--shadow-seed", type=int, default=0,
                    help="sampler seed: same seed -> same sampled "
                    "request ids fleet-wide, whichever worker claims")
    ap.add_argument("--abort-on-drift", action="store_true",
                    help="workers escalate a drift-tolerance breach "
                    "from report-only to an abort")
    ap.add_argument("-V", "--verbose", action="store_true")
    ap.add_argument("--no-timeline", action="store_true",
                    help="disable the coordinator's live timeline "
                    "sampler (obs/timeline.py timeline.jsonl) and the "
                    "report-only autoscale recommender")
    ap.add_argument("--max-respawns", type=int, default=2,
                    help="per-worker budget for respawning CRASHED "
                    "workers (nonzero exit with work left); clean "
                    "exits never respawn")
    ap.add_argument("--elastic-workers", action="store_true",
                    help="act on the autoscale recommender: spawn/"
                    "retire one worker per recommendation change, "
                    "clamped to [--min-workers, --max-workers].  "
                    "Retire = SIGTERM -> the worker's existing "
                    "lease-release path.  Off: report-only")
    ap.add_argument("--min-workers", type=int, default=1)
    ap.add_argument("--max-workers", type=int, default=0,
                    help="elastic ceiling (0 = max(--workers, "
                    "--min-workers))")
    ap.add_argument("--open-loop", action="store_true",
                    help="arrivals keep landing after workers start "
                    "(load harness): workers ignore the all-done exit "
                    "and hold on until --max-idle or SIGTERM")
    ap.add_argument("--profile-worker", default="", metavar="WID",
                    help="arm worker WID for a one-cycle device-profile "
                    "capture (not ported: ROADMAP.md, A11)")
    ap.add_argument("--profile-dir", default="",
                    help="capture directory for --profile-worker")
    return ap


def config_from_args(args) -> FleetConfig:
    return FleetConfig(
        requests=args.requests, out_dir=args.out_dir,
        queue_dir=args.queue_dir, aot_store=args.aot_store,
        workers=args.workers, role=args.role,
        worker_id=args.worker_id, batch=args.batch,
        lease_ttl_s=args.lease_ttl, poll_s=args.poll,
        max_idle_s=args.max_idle,
        large_stations=args.large_stations,
        overload_policy=args.overload_policy,
        degrade_emiter=args.degrade_emiter,
        degrade_lbfgs=args.degrade_lbfgs,
        max_streams=args.max_streams,
        max_emiter=args.max_emiter, max_iter=args.max_iter,
        max_lbfgs=args.max_lbfgs, lbfgs_m=args.lbfgs_m,
        solver_mode=args.solver_mode, nulow=args.nulow,
        nuhigh=args.nuhigh, randomize=not args.no_randomize,
        use_f64=not args.f32, use_fused_predict=args.fused,
        coh_dtype=args.coh_dtype, verbose=args.verbose, slo=args.slo,
        timeline=not args.no_timeline,
        max_respawns=args.max_respawns,
        elastic_workers=args.elastic_workers,
        min_workers=args.min_workers, max_workers=args.max_workers,
        open_loop=args.open_loop, shadow_rate=args.shadow_rate,
        shadow_budget_s=args.shadow_budget_s,
        shadow_seed=args.shadow_seed,
        abort_on_drift=args.abort_on_drift)


def _obs_setup(cfg, role: str, dev):
    """RunManifest, event log, crash handlers and tracer, as the serve
    app."""
    from sagecal_tpu_torch.obs.events import RunManifest, default_event_log
    from sagecal_tpu_torch.obs.flight import (
        get_flight_recorder, install_crash_handlers, register_event_log,
    )
    from sagecal_tpu_torch.obs.trace import configure_tracer

    manifest = RunManifest.collect(
        kernel_path="torch", device=dev, app="fleet", role=role,
        out_dir=cfg.out_dir)
    # fleet runs default the event log into the out-dir, so every record
    # of one run lands in one directory; SAGECAL_EVENT_LOG still wins
    path = None
    if not os.environ.get("SAGECAL_EVENT_LOG") and cfg.out_dir:
        path = os.path.join(cfg.out_dir, "sagecal_events.jsonl")
    elog = default_event_log(manifest=manifest, path=path)
    install_crash_handlers()
    if elog is not None:
        register_event_log(elog)
    get_flight_recorder(run_id=manifest.run_id)
    configure_tracer(run_id=manifest.run_id)
    return elog


def _obs_teardown(elog) -> None:
    from sagecal_tpu_torch.obs.flight import (
        close_flight_recorder, unregister_event_log,
    )
    from sagecal_tpu_torch.obs.trace import close_tracer

    close_tracer()
    if elog is not None:
        elog.close()
        unregister_event_log(elog)
    close_flight_recorder()


def worker_argv(cfg: FleetConfig, index: int, device=None) -> list:
    """One worker's command line (``fleet/coordinator.py::worker_argv``);
    with ``device`` the worker runs there instead of on the card."""
    from sagecal_tpu_torch.fleet.coordinator import worker_argv as argv_of

    argv = argv_of(cfg, index)
    if device is None:
        return argv
    return [sys.executable, "-c",
            _WORKER_ENTRY.format(device=str(device))] + argv[3:]


def run_worker(cfg: FleetConfig, log=print, device=None, open_file=None):
    """One worker's whole life in this process on ``device`` (CUDA
    unless ``device="cpu"``); returns its summary."""
    from sagecal_tpu_torch.device import resolve_device
    from sagecal_tpu_torch.fleet.worker import FleetWorker

    dev = resolve_device(device)
    elog = _obs_setup(cfg, "worker", dev)
    try:
        return FleetWorker(cfg, log=log, device=dev,
                           open_file=open_file).run(elog=elog)
    finally:
        _obs_teardown(elog)


def run_coordinator(cfg: FleetConfig, requests=None, log=print,
                    device=None, open_file=None, argv_fn=None):
    """Seed, spawn, watch and report; returns the fleet summary.  The
    coordinator touches no device; ``device`` is passed to the workers
    (None: the card), ``argv_fn(cfg, slot)`` replaces their command
    line."""
    import functools

    from sagecal_tpu_torch.fleet.coordinator import FleetCoordinator
    from sagecal_tpu_torch.serve.request import load_requests

    if requests is None:
        requests = load_requests(cfg.requests)
    if argv_fn is None:
        argv_fn = functools.partial(worker_argv, device=device)
    elog = _obs_setup(cfg, "coordinator", "cpu")
    try:
        return FleetCoordinator(cfg, log=log, argv_fn=argv_fn,
                                open_file=open_file).run(requests,
                                                         elog=elog)
    finally:
        _obs_teardown(elog)


def main(argv=None, device=None, open_file=None) -> int:
    """The ``fleet`` command line on ``device`` (None: the card).
    Returns the exit code."""
    from sagecal_tpu_torch.apps.fullbatch import _FALSY

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.profile_worker or os.environ.get(
            "SAGECAL_PROFILE_DIR", "").strip().lower() not in _FALSY:
        print("sagecal_tpu_torch fleet: device profiling is not ported "
              "yet (ROADMAP.md, A11)", file=sys.stderr)
        return 2
    if cfg.role == "worker":
        if not (cfg.queue_dir or cfg.out_dir):
            build_parser().error("--queue-dir (or --out-dir) required")
        run_worker(cfg, device=device, open_file=open_file)
        return 0
    requests = None
    if args.synthetic > 0:
        from sagecal_tpu_torch.serve.request import load_requests
        from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

        path = make_synthetic_workload(cfg.out_dir, args.synthetic,
                                       n_tenants=args.tenants,
                                       device=device)
        cfg.requests = path
        requests = load_requests(path)
    elif not cfg.requests:
        build_parser().error("--requests (or --synthetic N) is required")
    summary = run_coordinator(cfg, requests=requests, device=device,
                              open_file=open_file)
    return 0 if summary.get("drained") else 4


if __name__ == "__main__":
    sys.exit(main())
