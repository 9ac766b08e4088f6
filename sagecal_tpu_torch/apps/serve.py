"""``serve``: drain a multi-tenant request manifest through the batch
calibration service (``serve/``); counterpart of
``sagecal_tpu/apps/serve.py``, with the same flags and defaults.

``python -m sagecal_tpu_torch.apps.cli serve --requests r.json ...``
serves on the CUDA device; :func:`main` and :func:`run_serve` take
``device`` for Python callers (``device="cpu"`` in the tests), and
:func:`run_serve` takes the datasets' opener ``open_file``
(``io.memh5.MemFile`` on a machine without h5py).

``--resume`` / ``--checkpoint-every`` / ``--checkpoint-dir`` keep
per-tenant checkpoints (``serve/service.py``); ``--aot-store DIR`` loads
the kernel libraries from a shared store (``serve/aot_store.py``).

Exit codes: 0 success; 3 a request diverged under
``--abort-on-divergence`` (or drift under ``--abort-on-drift``); 5
``--resume`` refused (a checkpoint of another configuration); 2 for a
usage error.
"""

from __future__ import annotations

import argparse
import sys

from sagecal_tpu_torch.apps.config import ServeConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.apps.cli serve",
        description="Multi-tenant batch calibration service: bucketed "
        "batch solves over a JSON request manifest.")
    ap.add_argument("--requests", default="",
                    help="request manifest (JSON); see serve/request.py "
                    "for the schema")
    ap.add_argument("--out-dir", default="serve-out",
                    help="per-request solutions + result manifests")
    ap.add_argument("--batch", type=int, default=8,
                    help="lanes per bucketed batch solve (a bucket "
                    "dispatches when this many same-shape requests "
                    "accumulate; the ragged tail pads by replication)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="ignore --requests and serve N synthetic "
                    "requests (datasets are simulated under --out-dir)")
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
                    help="solve in float32 (the fused kernels' precision)")
    ap.add_argument("--fused", action="store_true",
                    help="route batch solves' joint LBFGS through the "
                    "fused-objective CUDA kernels: the batched kernels "
                    "when the bucket passes the capability checks "
                    "(solvers/batched.choose_batched_path), the solo "
                    "kernels lane by lane or the torch-op cost "
                    "otherwise.  Requires --f32; ignored under f64")
    ap.add_argument("--coh-dtype", choices=("f32", "bf16"), default="f32",
                    help="coherency-stack storage dtype on the fused "
                    "paths (bf16 halves the dominant memory stream, f32 "
                    "accumulation)")
    ap.add_argument("--abort-on-divergence", action="store_true")
    ap.add_argument("--shadow-rate", type=float, default=0.0,
                    help="fraction of requests to shadow re-solve on "
                    "the torch-op/f32 reference path after their "
                    "manifests land, appending drift records to "
                    "<out-dir>/drift.jsonl (obs/shadow.py); 0 = off")
    ap.add_argument("--shadow-budget-s", type=float, default=120.0,
                    help="wall-clock budget for shadow re-solves; "
                    "sampled requests past it are skipped + counted")
    ap.add_argument("--shadow-seed", type=int, default=0,
                    help="sampler seed: same seed -> same sampled "
                    "request ids, independent of scheduling")
    ap.add_argument("--abort-on-drift", action="store_true",
                    help="escalate a drift-tolerance breach "
                    "(obs/shadow.DRIFT_TOLERANCES) from report-only to "
                    "a run abort (exit 3) after the drain")
    ap.add_argument("--resume", action="store_true",
                    help="skip requests a previous (preempted) server "
                    "run already completed (per-tenant checkpoints)")
    ap.add_argument("--slo", default="",
                    help="per-tenant SLO specs (slo.json; obs/slo.py). "
                    "Report-only: burn-rate alerts + serve_slo_* gauges; "
                    "falls back to a 'slos' key in the request manifest")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="per-tenant checkpoints every this many served "
                    "requests")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--aot-store", default="",
                    help="cross-worker kernel store directory "
                    "(serve/aot_store.py); workers joining a warm store "
                    "build nothing")
    ap.add_argument("--max-streams", type=int, default=0,
                    help="cap on concurrently open prefetch streams; "
                    "LRU-evicted above the cap (0 = unbounded)")
    ap.add_argument("-V", "--verbose", action="store_true")
    return ap


def config_from_args(args) -> ServeConfig:
    return ServeConfig(
        requests=args.requests, out_dir=args.out_dir, batch=args.batch,
        max_emiter=args.max_emiter, max_iter=args.max_iter,
        max_lbfgs=args.max_lbfgs, lbfgs_m=args.lbfgs_m,
        solver_mode=args.solver_mode, nulow=args.nulow,
        nuhigh=args.nuhigh, randomize=not args.no_randomize,
        abort_on_divergence=args.abort_on_divergence,
        resume=args.resume, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, use_f64=not args.f32,
        use_fused_predict=args.fused, coh_dtype=args.coh_dtype,
        verbose=args.verbose, slo=args.slo, aot_store=args.aot_store,
        max_streams=args.max_streams, shadow_rate=args.shadow_rate,
        shadow_budget_s=args.shadow_budget_s,
        shadow_seed=args.shadow_seed,
        abort_on_drift=args.abort_on_drift)


def run_serve(cfg: ServeConfig, requests=None, log=print, device=None,
              open_file=None):
    """Serve ``requests`` (or the ``cfg.requests`` manifest) to
    completion on ``device`` (CUDA unless ``device="cpu"``), the
    datasets opened with ``open_file`` (None: ``h5py.File``); returns
    the service summary dict."""
    from sagecal_tpu_torch.device import resolve_device
    from sagecal_tpu_torch.obs.events import RunManifest, default_event_log
    from sagecal_tpu_torch.obs.flight import (
        close_flight_recorder, get_flight_recorder, install_crash_handlers,
        register_event_log, unregister_event_log,
    )
    from sagecal_tpu_torch.obs.trace import close_tracer, configure_tracer
    from sagecal_tpu_torch.serve.request import load_requests
    from sagecal_tpu_torch.serve.service import CalibrationService

    dev = resolve_device(device)
    if requests is None:
        requests = load_requests(cfg.requests)
    # the manifest stamps the CONFIGURED route; the route each batch
    # took is in its ``serve_batch_dispatched`` event and result manifests
    fused_intent = cfg.use_fused_predict and not cfg.use_f64
    manifest = RunManifest.collect(
        kernel_path="fused" if fused_intent else "torch", device=dev,
        x64_enabled=cfg.use_f64, app="serve", requests=len(requests),
        tenants=len({r.tenant for r in requests}), batch=cfg.batch,
        out_dir=cfg.out_dir)
    elog = default_event_log(manifest=manifest)
    install_crash_handlers()
    if elog is not None:
        register_event_log(elog)
    get_flight_recorder(run_id=manifest.run_id)
    # request-lifecycle tracing (SAGECAL_TRACE=1): run-level spans join
    # the event log on run_id; each request writes its own trace
    configure_tracer(run_id=manifest.run_id)
    store = None
    if cfg.aot_store:
        from sagecal_tpu_torch.serve.aot_store import AOTArtifactStore

        store = AOTArtifactStore(cfg.aot_store)
    service = CalibrationService(cfg, log=log, device=dev,
                                 open_file=open_file, aot_store=store)
    try:
        summary = service.run(requests, elog=elog)
    finally:
        close_tracer()
        if elog is not None:
            elog.close()
            unregister_event_log(elog)
    log(f"served {summary['served']}/{summary['requests']} requests "
        f"in {summary['wall_s']:.1f}s — "
        f"{summary['solves_per_sec']:.2f} solves/s, "
        f"p50 latency {summary['p50_latency_s']:.1f}s, "
        f"buckets {summary['buckets']}")
    close_flight_recorder()
    return summary


def main(argv=None, device=None) -> int:
    """Run the ``serve`` command line ``argv`` (default
    ``sys.argv[1:]``) on ``device`` (None: the CUDA device).  Returns the
    exit code."""
    from sagecal_tpu_torch.elastic import ResumeRefused
    from sagecal_tpu_torch.obs.quality import DivergenceAbort

    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    try:
        requests = None
        if args.synthetic > 0:
            from sagecal_tpu_torch.serve.request import load_requests
            from sagecal_tpu_torch.serve.synthetic import (
                make_synthetic_workload,
            )

            path = make_synthetic_workload(cfg.out_dir, args.synthetic,
                                           n_tenants=args.tenants,
                                           device=device)
            cfg.requests = path
            requests = load_requests(path)
        elif not cfg.requests:
            build_parser().error("--requests (or --synthetic N) is required")
        run_serve(cfg, requests=requests, device=device)
    except DivergenceAbort as e:
        print(f"sagecal_tpu_torch serve: {e}", file=sys.stderr)
        return 3
    except ResumeRefused as e:
        print(f"sagecal_tpu_torch serve: {e}", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
