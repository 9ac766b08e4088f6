"""Command line of the port: the reference ``sagecal`` flag surface of
``sagecal_tpu/apps/cli.py``, with the same flags and defaults.

``python -m sagecal_tpu_torch.apps.cli -d obs.h5 -s sky.txt -c
sky.txt.cluster -t 60 ...`` calibrates a ``vis.h5`` tile by tile on the
CUDA device (``apps/fullbatch.py``); ``-f 'band*.h5' ...`` runs the
multi-band consensus ADMM (``apps/distributed.py``; with ``-X`` or
``--spatial-*`` spatially regularized, with ``--spatial-diffuse-id``
under the diffuse constraint), ``-f ... -N 1`` federated calibration
(``apps/federated.py``), ``-N 1 ...`` the minibatch app
(``apps/minibatch.py``); ``... cli serve --requests r.json`` runs the
calibration service (``apps/serve.py``), ``... cli spatial -f
'band*.h5' ...`` the spatial app (``apps/spatial.py``), ``... cli
widefield ...`` the wide-field app (``apps/widefield.py``) and ``...
cli refine ...`` sky-model refinement (``apps/refine.py``), ``... cli
fleet ...`` a coordinator and its worker processes over a lease queue
(``apps/fleet.py``), ``... cli stream ...`` sliding-window streaming
calibration (``apps/stream.py``), ``... cli load ...`` the seeded load
generator against a live fleet (``apps/load.py``) and ``... cli convert
<ms> <h5> [spw]`` a MeasurementSet into a ``vis.h5`` (``io/dataset.py``;
it needs python-casacore); ``-f ...
--multihost`` runs the multi-band mode over ``torch.distributed`` ranks
(``parallel/multihost.py``).  :func:`main` takes ``device`` for
Python callers (``device="cpu"`` in the tests); the command line always
means the card.  Exit codes: 0 done, 3 when ``--abort-on-divergence``
stopped a diverged run, 5 when ``--resume`` found a checkpoint of
another configuration (or a solutions file that disagrees with it), 2
for a usage error or a mode the port does not have yet (the message
names its ROADMAP.md item), 4 when ``fleet`` or ``load`` left requests
undrained.
"""

from __future__ import annotations

import argparse
import sys

from sagecal_tpu_torch.apps.config import RunConfig

# subcommands of the reference CLI not ported yet and the ROADMAP.md
# item that ports each one
_SUBCOMMANDS = {"diag": "A11"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.apps.cli",
        description="Direction-dependent radio interferometric calibration "
        "on an NVIDIA GPU (the PyTorch/CUDA port of sagecal_tpu).",
    )
    ap.add_argument("-d", "--dataset", required=False, default="",
                    help="input vis.h5 dataset (ref: -d MS)")
    ap.add_argument("-s", "--sky", default="", help="sky model file (LSM)")
    ap.add_argument("-c", "--clusters", default="",
                    help="cluster file (defaults to <sky>.cluster)")
    ap.add_argument("-p", "--solutions", default="solutions.txt",
                    help="output solutions file")
    ap.add_argument("-q", "--init-solutions", default=None,
                    help="initial solutions (warm start)")
    ap.add_argument("-I", "--in-column", default="vis",
                    help="input dataset column: vis/corrected/model/... "
                    "(ref -I DATA/CORRECTED_DATA)")
    ap.add_argument("--out-column", default="corrected",
                    help="output dataset column for residuals "
                    "(ref -O OutField; -O is taken by spatial cadence)")
    ap.add_argument("-F", "--sky-format", type=int, default=-1,
                    choices=(-1, 0, 1),
                    help="sky model format: 0 LSM, 1 three-term spectra, "
                    "-1 auto-detect (ref -F)")
    ap.add_argument("-t", "--tilesz", type=int, default=120)
    ap.add_argument("-e", "--max-emiter", type=int, default=3)
    ap.add_argument("-g", "--max-iter", type=int, default=2)
    ap.add_argument("-l", "--max-lbfgs", type=int, default=10)
    ap.add_argument("-m", "--lbfgs-m", type=int, default=7)
    ap.add_argument("-j", "--solver-mode", type=int, default=3,
                    help="0..6 per Dirac.h SM_* modes")
    ap.add_argument("-x", "--min-uvcut", type=float, default=0.0)
    ap.add_argument("-y", "--max-uvcut", type=float, default=1e20)
    ap.add_argument("-L", "--nulow", type=float, default=2.0)
    ap.add_argument("-H", "--nuhigh", type=float, default=30.0)
    ap.add_argument("-R", "--no-randomize", action="store_true")
    ap.add_argument("-W", "--whiten", action="store_true")
    ap.add_argument("-B", "--beam", type=int, default=0,
                    help="beam model: 0 none, 1 array, 2 array+element, "
                    "3 element, 4/5/6 same per-channel (ref DOBEAM codes)")
    ap.add_argument("--element-coeffs", default=None,
                    help="element-beam coefficient table file "
                    "(default: built-in synthetic dipole)")
    ap.add_argument("-b", "--per-channel", action="store_true",
                    help="re-fit each channel after the averaged solve "
                    "(ref -b doChan)")
    ap.add_argument("-G", "--rho-file", default=None,
                    help="per-cluster ADMM rho file (read_arho_fromfile "
                    "format: cluster_id hybrid rho)")
    ap.add_argument("-K", "--skip-tiles", type=int, default=0,
                    help="skip this many solution tiles (partial rerun)")
    ap.add_argument("-T", "--max-tiles", type=int, default=0,
                    help="process at most this many tiles (0 = all)")
    ap.add_argument("-a", "--simulate", type=int, default=0,
                    help="1: model only, 2: add, 3: subtract")
    ap.add_argument("-z", "--ignore-clusters", default=None)
    ap.add_argument("-k", "--ccid", type=int, default=None,
                    help="cluster id whose inverse corrects the residual "
                    "(ref -k)")
    ap.add_argument("-E", "--gpu-predict", type=int, default=0,
                    help="accepted for drop-in compatibility (ref -E GPU "
                    "predict toggle); the whole compute path is the "
                    "GPU here")
    ap.add_argument("-o", "--correction-rho", type=float, default=1e-9,
                    help="robust rho added to the MMSE matrix inversion "
                    "when correcting residuals by a cluster's solution "
                    "(ref -o, main.cpp:80)")
    ap.add_argument("-J", "--phase-only", type=int, default=0,
                    help="if >0, phase-only correction (ref -J)")
    ap.add_argument("--phase-only-correction", action="store_true",
                    help="alias for -J 1")
    ap.add_argument("-n", "--threads", type=int, default=0,
                    help="accepted for drop-in compatibility (ref -n "
                    "worker threads)")
    ap.add_argument("-N", "--epochs", type=int, default=0)
    ap.add_argument("-M", "--minibatches", type=int, default=1)
    ap.add_argument("-w", "--bands", type=int, default=1)
    ap.add_argument("-A", "--admm-iters", type=int, default=0)
    ap.add_argument("-P", "--npoly", type=int, default=2)
    ap.add_argument("-Q", "--poly-type", type=int, default=2)
    ap.add_argument("-r", "--admm-rho", type=float, default=5.0)
    ap.add_argument("--consensus-zstep", choices=("grouped", "reduced"),
                    default="grouped",
                    help="consensus Z-step collective layout: 'reduced' "
                    "moves only basis-sized Gram terms per round "
                    "(transpose reduction) instead of the full "
                    "replicated psum; bit-close (<=1e-6) to 'grouped'")
    ap.add_argument("--consensus-cluster-groups", type=int, default=1,
                    help=">1 decomposes each ADMM x-step below band "
                    "granularity into this many cluster factor-node "
                    "groups (fine-grained consensus; rounds get "
                    "cheaper, the rotation covers all groups)")
    ap.add_argument("--consensus-staleness", type=int, default=0,
                    help=">0 bounded-staleness consensus rounds: bands "
                    "may contribute Gram terms up to K rounds stale "
                    "(rho-discounted); 0 = synchronous (bit-identical "
                    "to the default loop)")
    ap.add_argument("--consensus-staleness-discount", type=float,
                    default=1.0,
                    help="per-round rho discount applied to stale "
                    "consensus contributions (1.0 = undamped)")
    ap.add_argument("-C", "--adaptive-rho", type=int, default=0,
                    help="if >0, adaptive (Barzilai-Borwein) update of "
                    "the ADMM regularization (ref -C aadmm, default off "
                    "as in the reference)")
    ap.add_argument("--fused", action="store_true",
                    help="route the joint-LBFGS cost through the fused-"
                         "objective CUDA kernels (f32 runs only)")
    ap.add_argument("--coh-dtype", choices=("f32", "bf16"), default="f32",
                    help="coherency-stack storage dtype on the fused "
                         "path: bf16 halves the dominant HBM stream "
                         "(f32 accumulation, ~3 significant digits of "
                         "coherency precision); quality-watchdog events "
                         "record the active dtype.  Requires --fused "
                         "--f32")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32 (the fused kernels' precision)")
    ap.add_argument("-V", "--verbose", action="store_true")
    # distributed (sagecal-mpi) surface: -f pattern selects the mesh
    # driver (MPI/main.cpp:336; master MS discovery :60-224)
    ap.add_argument("-f", "--band-pattern", default=None,
                    help="glob of per-band vis.h5 datasets -> distributed "
                    "consensus-ADMM over the device mesh (ref sagecal-mpi "
                    "-f 'pattern')")
    ap.add_argument("--multihost", action="store_true",
                    help="run -f over torch.distributed ranks (RANK, "
                    "WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK "
                    "from the environment, as torchrun sets them)")
    ap.add_argument("-U", "--global-residual", type=int, default=0,
                    help="if >0, compute final residuals from the GLOBAL "
                    "consensus solution B_f Z instead of the per-band "
                    "solutions (ref -U use_global_solution, "
                    "sagecal_slave.cpp:861-979)")
    ap.add_argument("-X", "--spatialreg", default=None,
                    metavar="lam,mu,n0,fista_maxiter,cadence",
                    help="enable spatial regularization with these "
                    "parameters (ref -X; overrides the individual "
                    "--spatial-* flags)")
    ap.add_argument("--spatial-n0", type=int, default=0,
                    help=">0 enables spatial regularization of Z with a "
                    "basis of this order (the -X n0 component)")
    ap.add_argument("--spatial-beta", type=float, default=0.01,
                    help="shapelet basis scale; <=0 uses the master's "
                    "auto scale 4*sqrt(l_max^2/M)")
    ap.add_argument("--spatial-mu", type=float, default=1e-3)
    ap.add_argument("-O", "--spatial-cadence", type=int, default=2,
                    help="run the spatial FISTA update every this many "
                    "ADMM iterations (ref admm_cadence)")
    ap.add_argument("--spatial-basis", choices=("shapelet", "sharmonic"),
                    default="shapelet",
                    help="spatial basis: shapelet(l,m) or spherical-"
                    "harmonic(r,theta) modes (ref spatialreg_basis)")
    ap.add_argument("--spatial-diffuse-id", type=int, default=None,
                    help="cluster id of the all-shapelet diffuse cluster "
                    "to constrain/re-predict from the spatial model "
                    "(ref sp_diffuse_id)")
    ap.add_argument("--spatial-gamma", type=float, default=0.1,
                    help="diffuse-constraint coupling (ref sp_gamma)")
    ap.add_argument("--spatial-lam", type=float, default=1e-3,
                    help="diffuse-constraint L2 (ref sh_lambda)")
    ap.add_argument("--mdl", action="store_true",
                    help="score consensus polynomial orders by AIC/MDL "
                    "each tile (ref master -M, mdl.c)")
    ap.add_argument("-u", "--federated-alpha", type=float, default=5.0,
                    help="federated Z~Zavg coupling strength for the "
                    "-f + -N stochastic mode (ref alpha, "
                    "find_prod_inverse_full_fed)")
    ap.add_argument("-i", "--influence", action="store_true",
                    help="write influence-function diagnostics instead of "
                    "residuals (ref -i)")
    ap.add_argument("--abort-on-divergence", action="store_true",
                    help="terminate (with a structured run_aborted event) "
                    "when the quality watchdog reports a diverged solve; "
                    "default is report-only")
    # elastic execution (elastic/)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest valid checkpoint in the "
                    "checkpoint directory (refused, exit 5, when the run "
                    "configuration or data fingerprint mismatches)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help=">0 writes an atomic solver-state checkpoint "
                    "every this many tile (or minibatch) boundaries; "
                    "--resume implies 1 when unset")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint directory (default: "
                    "<solutions>.ckpt)")
    # device profiling (not ported: ROADMAP.md, A11)
    ap.add_argument("--device-profile", default=None, metavar="DIR",
                    help="capture a device-profiler trace of this run "
                    "into DIR for `diag roofline` (same as "
                    "SAGECAL_DEVICE_PROFILE=DIR)")
    return ap


def config_from_args(args) -> RunConfig:
    return RunConfig(
        dataset=args.dataset,
        sky_model=args.sky,
        cluster_file=args.clusters or (args.sky + ".cluster"),
        out_solutions=args.solutions,
        init_solutions=args.init_solutions,
        tilesz=args.tilesz,
        max_emiter=args.max_emiter,
        max_iter=args.max_iter,
        max_lbfgs=args.max_lbfgs,
        lbfgs_m=args.lbfgs_m,
        solver_mode=args.solver_mode,
        nulow=args.nulow,
        nuhigh=args.nuhigh,
        randomize=not args.no_randomize,
        min_uvcut=args.min_uvcut,
        max_uvcut=args.max_uvcut,
        whiten=args.whiten,
        beam_mode=args.beam,
        element_coeffs=args.element_coeffs,
        per_channel=args.per_channel,
        rho_file=args.rho_file,
        skip_tiles=args.skip_tiles,
        max_tiles=args.max_tiles,
        simulation_mode=args.simulate,
        ignore_clusters_file=args.ignore_clusters,
        ccid=args.ccid,
        correction_rho=args.correction_rho,
        phase_only_correction=(args.phase_only_correction
                               or args.phase_only > 0),
        epochs=args.epochs,
        minibatches=args.minibatches,
        in_column=args.in_column,
        out_column=args.out_column,
        sky_format=args.sky_format,
        bands=args.bands,
        admm_iters=args.admm_iters,
        npoly=args.npoly,
        poly_type=args.poly_type,
        admm_rho=args.admm_rho,
        consensus_zstep=args.consensus_zstep,
        consensus_cluster_groups=args.consensus_cluster_groups,
        consensus_staleness=args.consensus_staleness,
        consensus_staleness_discount=args.consensus_staleness_discount,
        use_f64=not args.f32,
        verbose=args.verbose,
        influence=args.influence,
        use_fused_predict=args.fused,
        coh_dtype=args.coh_dtype,
        abort_on_divergence=args.abort_on_divergence,
        resume=args.resume,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
    )


def _warn_dropped_fused(args, log=print):
    if args.fused and not args.f32:
        log("warning: --fused requires --f32 (the fused kernels compute "
            "in float32); the fused path is DISABLED for this f64 run")
    if getattr(args, "coh_dtype", "f32") == "bf16" and not (
            args.fused and args.f32):
        log("warning: --coh-dtype bf16 only applies to the fused f32 "
            "path (--fused --f32); coherencies stay at the run precision")


def _not_ported(what: str, item: str) -> int:
    print(f"sagecal_tpu_torch: {what} is not ported yet "
          f"(ROADMAP.md, {item})", file=sys.stderr)
    return 2


def main(argv=None, device=None, open_file=None) -> int:
    """Run the command line ``argv`` (default ``sys.argv[1:]``) on
    ``device`` (None: the CUDA device), opening datasets with
    ``open_file`` (None: ``h5py.File``; ``io.memh5.MemFile`` on a machine
    without h5py).  Returns the exit code."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from sagecal_tpu_torch.apps.serve import main as serve_main

        return serve_main(argv[1:], device=device)
    if argv and argv[0] == "spatial":
        from sagecal_tpu_torch.apps.spatial import main as spatial_main

        return spatial_main(argv[1:], device=device, open_file=open_file)
    if argv and argv[0] == "widefield":
        from sagecal_tpu_torch.apps.widefield import main as widefield_main

        return widefield_main(argv[1:], device=device)
    if argv and argv[0] == "refine":
        from sagecal_tpu_torch.apps.refine import main as refine_main

        return refine_main(argv[1:], device=device, open_file=open_file)
    if argv and argv[0] == "fleet":
        from sagecal_tpu_torch.apps.fleet import main as fleet_main

        return fleet_main(argv[1:], device=device, open_file=open_file)
    if argv and argv[0] == "load":
        from sagecal_tpu_torch.apps.load import main as load_main

        return load_main(argv[1:], device=device, open_file=open_file)
    if argv and argv[0] == "stream":
        from sagecal_tpu_torch.apps.stream import main as stream_main

        return stream_main(argv[1:], device=device, open_file=open_file)
    if argv and argv[0] == "convert":
        # convert <ms> <h5> [spw] — multi-SPW MSs convert one window
        # per .h5 band file; needs python-casacore
        from sagecal_tpu_torch.io.dataset import ms_to_h5

        ms_to_h5(argv[1], argv[2],
                 spw=int(argv[3]) if len(argv) > 3 else 0,
                 open_file=open_file)
        return 0
    if argv and argv[0] in _SUBCOMMANDS:
        return _not_ported(f"the {argv[0]!r} subcommand",
                           _SUBCOMMANDS[argv[0]])
    args = build_parser().parse_args(argv)
    _warn_dropped_fused(args)
    cfg = config_from_args(args)
    if args.device_profile:
        return _not_ported("--device-profile", "A11")
    from sagecal_tpu_torch.elastic import ResumeRefused
    from sagecal_tpu_torch.obs.quality import DivergenceAbort

    try:
        return _dispatch(args, cfg, device, open_file)
    except DivergenceAbort as e:
        # the run already emitted its run_aborted event
        print(f"sagecal_tpu_torch: {e}", file=sys.stderr)
        return 3
    except ResumeRefused as e:
        # the resume_refused event is already in the event log
        print(f"sagecal_tpu_torch: {e}", file=sys.stderr)
        return 5
    except NotImplementedError as e:
        print(f"sagecal_tpu_torch: {e}", file=sys.stderr)
        return 2
    return 0


def _spatial_options(args) -> dict:
    """``run_distributed``'s spatial options from the flags; ``-X
    lam,mu,n0,fista_maxiter,cadence`` (MPI/main.cpp:102) overrides the
    ``--spatial-*`` ones it names.  A malformed ``-X`` is a usage
    error."""
    sp = dict(n0=args.spatial_n0, mu=args.spatial_mu, lam=args.spatial_lam,
              fista_maxiter=30, cadence=args.spatial_cadence)
    if args.spatialreg:
        parts = args.spatialreg.split(",")
        try:
            if len(parts) != 5:
                raise ValueError
            sp = dict(lam=float(parts[0]), mu=float(parts[1]),
                      n0=int(parts[2]), fista_maxiter=int(parts[3]),
                      cadence=int(parts[4]))
        except ValueError:
            build_parser().error(
                f"-X expects 5 comma-separated values "
                f"lam,mu,n0,fista_maxiter,cadence, got {args.spatialreg!r}")
    return {f"spatial_{k}": v for k, v in sp.items()}


def _dispatch(args, cfg, device, open_file=None) -> int:
    """The reference's mode dispatch (main.cpp:295-307; -f is the
    sagecal-mpi mode, MPI/main.cpp:336-366): -f with -N > 0 to the
    federated app, -f to the distributed app, -N > 0 to the minibatch
    app, else fullbatch.  ``--multihost`` spreads a -f run over the
    environment's ranks; the other modes ignore it, as the JAX
    package's do."""
    if args.band_pattern and cfg.epochs > 0:
        from sagecal_tpu_torch.apps.federated import run_federated

        cfg.dataset = args.band_pattern
        run_federated(cfg, nadmm=max(cfg.admm_iters, 2), epochs=cfg.epochs,
                      minibatches=max(cfg.minibatches, 1),
                      alpha=args.federated_alpha, device=device,
                      open_file=open_file)
    elif args.band_pattern:
        from sagecal_tpu_torch.apps.distributed import run_distributed

        cfg.dataset = args.band_pattern
        run_distributed(cfg, nadmm=max(cfg.admm_iters, 2),
                        spatial_beta=args.spatial_beta,
                        spatial_basis=args.spatial_basis,
                        spatial_diffuse_id=args.spatial_diffuse_id,
                        spatial_gamma=args.spatial_gamma,
                        **_spatial_options(args), mdl=args.mdl,
                        global_residual=bool(args.global_residual),
                        adaptive_rho=args.adaptive_rho > 0, device=device,
                        open_file=open_file, multihost=args.multihost)
    elif cfg.epochs > 0:
        from sagecal_tpu_torch.apps.minibatch import run_minibatch

        run_minibatch(cfg, device=device, open_file=open_file)
    else:
        from sagecal_tpu_torch.apps.fullbatch import run_fullbatch

        run_fullbatch(cfg, device=device, open_file=open_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
