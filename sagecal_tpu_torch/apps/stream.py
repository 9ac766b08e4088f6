"""The ``stream`` subcommand: streaming/online calibration (counterpart
of ``sagecal_tpu/apps/stream.py``).

Sliding-window solves over a time stream with the elastic warm-start
chain (``fleet/stream.py``), on the CUDA device unless the caller passes
``device="cpu"``.  The reference's persistent compilation cache and perf
events (``obs/perf.py``) are not ported yet (ROADMAP.md, A11).  Exit
codes: 0 success; 5 resume refused (fingerprint mismatch, a live foreign
owner lease on the chain checkpoint, or a solutions file that disagrees
with it — the standard elastic mapping).
"""

from __future__ import annotations

import argparse
import sys

from sagecal_tpu_torch.apps.config import StreamConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.apps.cli stream",
        description="Sliding-window streaming calibration with "
        "warm-started windows (latency-to-first-solution workload).")
    ap.add_argument("-d", "--dataset", default="",
                    help="input vis.h5 consumed as a time stream")
    ap.add_argument("-s", "--sky", default="", help="sky model file")
    ap.add_argument("-c", "--clusters", default="",
                    help="cluster file (defaults to <sky>.cluster)")
    ap.add_argument("--out-dir", default="stream-out")
    ap.add_argument("-t", "--window", type=int, default=2,
                    help="time samples per sliding window")
    ap.add_argument("--hop", type=int, default=1,
                    help="samples the window advances per solve")
    ap.add_argument("--max-windows", type=int, default=0,
                    help="stop after this many windows (0 = stream end)")
    ap.add_argument("--cold", action="store_true",
                    help="disable the warm-start chain (every window "
                    "solves from identity with full budgets) — the "
                    "bench baseline the warm chain is gated against")
    ap.add_argument("--warm-emiter", type=int, default=1,
                    help="EM passes for warm-started windows")
    ap.add_argument("--warm-lbfgs", type=int, default=0,
                    help="LBFGS budget for warm windows (0 = inherit -l)")
    ap.add_argument("-I", "--in-column", default="vis")
    ap.add_argument("-e", "--max-emiter", type=int, default=3)
    ap.add_argument("-g", "--max-iter", type=int, default=2)
    ap.add_argument("-l", "--max-lbfgs", type=int, default=10)
    ap.add_argument("-m", "--lbfgs-m", type=int, default=7)
    ap.add_argument("-j", "--solver-mode", type=int, default=3)
    ap.add_argument("-L", "--nulow", type=float, default=2.0)
    ap.add_argument("-H", "--nuhigh", type=float, default=30.0)
    ap.add_argument("-R", "--no-randomize", action="store_true")
    ap.add_argument("--res-ratio", type=float, default=5.0,
                    help="divergence guard: res1 > ratio*res0 resets "
                    "the warm-start chain to identity")
    ap.add_argument("--resume", action="store_true",
                    help="adopt the newest chain checkpoint (refused "
                    "on fingerprint mismatch or a live owner lease)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help=">0 checkpoints the chain every this many "
                    "windows; --resume implies 1 when unset")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="chain checkpoint directory "
                    "(default <out-dir>/stream.ckpt)")
    ap.add_argument("--lease-ttl", type=float, default=30.0,
                    help="owner-lease TTL stamped into chain "
                    "checkpoints; a second process adopts the chain "
                    "only after this long without a renewal")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="ignore -d/-s and simulate an N-station "
                    "stream fixture in the out dir")
    ap.add_argument("--ntime", type=int, default=6,
                    help="stream length for --synthetic")
    ap.add_argument("--nchan", type=int, default=2)
    ap.add_argument("--noise-sigma", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("-V", "--verbose", action="store_true")
    return ap


def config_from_args(args) -> StreamConfig:
    return StreamConfig(
        dataset=args.dataset, sky_model=args.sky,
        cluster_file=args.clusters or (args.sky + ".cluster"),
        out_dir=args.out_dir, window=args.window, hop=args.hop,
        max_windows=args.max_windows, warm_start=not args.cold,
        warm_emiter=args.warm_emiter, warm_lbfgs=args.warm_lbfgs,
        in_column=args.in_column,
        max_emiter=args.max_emiter, max_iter=args.max_iter,
        max_lbfgs=args.max_lbfgs, lbfgs_m=args.lbfgs_m,
        solver_mode=args.solver_mode, nulow=args.nulow,
        nuhigh=args.nuhigh, randomize=not args.no_randomize,
        res_ratio=args.res_ratio, resume=args.resume,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        lease_ttl_s=args.lease_ttl, use_f64=not args.f32,
        verbose=args.verbose, synthetic=args.synthetic,
        ntime=args.ntime, nchan=args.nchan,
        noise_sigma=args.noise_sigma, seed=args.seed)


def run_stream(cfg: StreamConfig, log=print, device=None, open_file=None):
    """The stream on ``device`` (None: the CUDA device) over a dataset
    opened with ``open_file`` (``io/dataset.py``), with the run manifest,
    event log, flight recorder and tracer around it; returns the
    calibrator's summary."""
    from sagecal_tpu_torch.device import resolve_device
    from sagecal_tpu_torch.fleet.stream import StreamCalibrator
    from sagecal_tpu_torch.obs.events import RunManifest, default_event_log
    from sagecal_tpu_torch.obs.flight import (
        close_flight_recorder, get_flight_recorder, install_crash_handlers,
        register_event_log, unregister_event_log,
    )
    from sagecal_tpu_torch.obs.trace import close_tracer, configure_tracer

    dev = resolve_device(device)
    manifest = RunManifest.collect(
        kernel_path="torch", device=dev, app="stream", dataset=cfg.dataset,
        window=cfg.window, hop=cfg.hop, warm_start=cfg.warm_start,
        solver_mode=cfg.solver_mode)
    elog = default_event_log(manifest=manifest)
    install_crash_handlers()
    if elog is not None:
        register_event_log(elog)
    get_flight_recorder(run_id=manifest.run_id)
    configure_tracer(run_id=manifest.run_id)
    try:
        return StreamCalibrator(cfg, log=log, device=dev,
                                open_file=open_file).run(elog=elog)
    finally:
        close_tracer()
        if elog is not None:
            elog.close()
            unregister_event_log(elog)
        close_flight_recorder()


def main(argv=None, device=None, open_file=None) -> int:
    """The ``stream`` command line on ``device`` (None: the card), the
    datasets opened with ``open_file``.  Returns the exit code."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.synthetic > 0:
        from sagecal_tpu_torch.fleet.stream import make_synthetic_stream

        ds, sky, cluster = make_synthetic_stream(
            cfg.out_dir, nstations=cfg.synthetic, ntime=cfg.ntime,
            nchan=cfg.nchan, noise_sigma=cfg.noise_sigma,
            seed=cfg.seed, open_file=open_file, device=device)
        cfg.dataset, cfg.sky_model, cfg.cluster_file = ds, sky, cluster
    elif not (cfg.dataset and cfg.sky_model):
        build_parser().error(
            "-d and -s (or --synthetic N) are required")
    from sagecal_tpu_torch.elastic import ResumeRefused

    try:
        run_stream(cfg, device=device, open_file=open_file)
    except ResumeRefused as e:
        print(f"sagecal_tpu_torch stream: {e}", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
