"""The ``refine`` app: differentiable sky-model refinement (counterpart
of ``sagecal_tpu/apps/refine.py``).

An outer LBFGS over the free sky parameters (``--free-flux 0:0,1:2``
and the like) around the inner gain solve, with gradients through the
inner fixed point (``refine/``).  Two input modes:

- dataset mode: one tile of a ``vis.h5`` (``open_file`` may be
  ``io.memh5.MemFile``) with sky and cluster files; the catalog values
  of the freed parameters are refined against the data;
- ``--synthetic N``: an N-station simulated sky with known truth
  (``data/simsky.py::make_sky``); one flux is perturbed by
  ``--perturb`` and refined back, and the result carries the true-flux
  relative error.

Every outer iteration appends one JSON line to ``<out>.trace.jsonl``
and emits a ``refine_iter`` event; the run writes ``<out>.json`` and
``<out>.npz`` and emits ``refine_done``.  Everything runs on ``device``
(CUDA unless ``device="cpu"``) on the torch-op predict; ``--fused``
exits 2 with ``FusedSkyGradientError`` (the hand kernels have no
coherency cotangent).  ``--checkpoint-every`` checkpoints after outer
iterations (``theta``, the inner warm start ``p_warm`` and the outer
LBFGS memory ``mem.<i>``, as the reference) and ``--resume`` continues
from the newest checkpoint (exit 5 when it belongs to another
configuration).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

from sagecal_tpu_torch.apps.config import RefineConfig
from sagecal_tpu_torch.device import resolve_device


def parse_keys(text: str) -> List[Tuple[int, int]]:
    """'0:0,1:2' -> [(0, 0), (1, 2)] (cluster:index pairs)."""
    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        c, _, s = part.partition(":")
        out.append((int(c), int(s)))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.apps.cli refine",
        description="Differentiable sky-model refinement: outer LBFGS "
        "over sky parameters around the inner calibration solve.")
    ap.add_argument("-d", "--dataset", default="",
                    help="input vis.h5 dataset (one tile)")
    ap.add_argument("-s", "--sky", default="", help="sky model file")
    ap.add_argument("-c", "--clusters", default="",
                    help="cluster file (defaults to <sky>.cluster)")
    ap.add_argument("-o", "--out", default="refine-out",
                    help="output prefix (<out>.json/.npz/.trace.jsonl)")
    ap.add_argument("-t", "--tilesz", type=int, default=2)
    ap.add_argument("--free-flux", default="0:0",
                    help="free fluxes, 'cluster:source' comma list")
    ap.add_argument("--free-spec", default="",
                    help="free spectral indices, 'cluster:source' list")
    ap.add_argument("--free-pos", default="",
                    help="free (ll,mm) positions, 'cluster:source' list")
    ap.add_argument("--free-modes", default="",
                    help="free shapelet modes, 'cluster:flat_mode' list")
    ap.add_argument("--outer-iters", type=int, default=10)
    ap.add_argument("-m", "--lbfgs-m", type=int, default=7)
    ap.add_argument("--gradient", choices=("implicit", "unrolled"),
                    default="implicit",
                    help="gradient route through the inner solve: IFT "
                    "adjoint at the fixed point, or truncated unrolling")
    ap.add_argument("--tol", type=float, default=0.0,
                    help=">0 stops when the outer gradient norm drops "
                    "below it")
    ap.add_argument("--inner-iters", type=int, default=12)
    ap.add_argument("--cg-iters", type=int, default=32)
    ap.add_argument("--damping", type=float, default=1e-6)
    ap.add_argument("--adjoint-cg-iters", type=int, default=64)
    ap.add_argument("--adjoint-matvec", choices=("hvp", "jtj"),
                    default="hvp",
                    help="IFT adjoint Hessian: exact HVP or Gauss-Newton")
    ap.add_argument("--ridge", type=float, default=1e-2,
                    help="inner gain-prior strength (breaks the "
                    "flux/gain scale degeneracy)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="refine a perturbed N-station simulated sky "
                    "instead of a dataset")
    ap.add_argument("--perturb", type=float, default=1.15,
                    help="flux perturbation factor for --synthetic")
    ap.add_argument("--noise-sigma", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--fused", action="store_true",
                    help="rejected: refinement needs coherency "
                    "cotangents the fused kernels cannot produce")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("-V", "--verbose", action="store_true")
    return ap


def config_from_args(args) -> RefineConfig:
    return RefineConfig(
        dataset=args.dataset, sky_model=args.sky,
        cluster_file=args.clusters or (args.sky + ".cluster"
                                       if args.sky else ""),
        out_prefix=args.out, tilesz=args.tilesz,
        free_flux=args.free_flux, free_spec=args.free_spec,
        free_pos=args.free_pos, free_modes=args.free_modes,
        outer_iters=args.outer_iters, lbfgs_m=args.lbfgs_m,
        gradient=args.gradient, tol=args.tol,
        inner_iters=args.inner_iters, cg_iters=args.cg_iters,
        damping=args.damping, adjoint_cg_iters=args.adjoint_cg_iters,
        adjoint_matvec=args.adjoint_matvec, ridge=args.ridge,
        synthetic=args.synthetic, perturb=args.perturb,
        noise_sigma=args.noise_sigma, seed=args.seed,
        resume=args.resume, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, use_f64=not args.f32,
        verbose=args.verbose)


def _build_problem(cfg: RefineConfig, spec, log, dev, open_file=None):
    """(RefineProblem, true_flux or None).  Synthetic mode simulates a
    known sky and perturbs one flux; dataset mode loads one tile and the
    sky catalog."""
    from sagecal_tpu_torch.refine import RefineProblem

    dtype = np.float64 if cfg.use_f64 else np.float32
    if cfg.synthetic > 0:
        from sagecal_tpu_torch.data.simsky import make_sky, perturb_flux

        sky = make_sky(nstations=cfg.synthetic, tilesz=cfg.tilesz,
                       noise_sigma=cfg.noise_sigma, seed=cfg.seed,
                       shapelet_n0=2 if cfg.free_modes else 0,
                       spectral=bool(cfg.free_spec), dtype=dtype, device=dev)
        c0, s0 = parse_keys(cfg.free_flux)[0] if cfg.free_flux else (0, 0)
        clusters = perturb_flux(sky, factor=cfg.perturb, cluster=c0,
                                source=s0)
        true_flux = float(sky.true_flux[c0][s0])
        log(f"synthetic sky: {cfg.synthetic} stations, flux "
            f"({c0},{s0}) perturbed x{cfg.perturb:.3f} "
            f"(true {true_flux:.4f})")
        problem = RefineProblem(
            data=sky.data, clusters=clusters, tables=sky.shapelet_tables,
            spec=spec, ridge=cfg.ridge)
        return problem, true_flux
    from sagecal_tpu_torch.io.dataset import VisDataset
    from sagecal_tpu_torch.io.skymodel import load_sky

    with VisDataset(cfg.dataset, "r", open_file) as ds:
        meta = ds.meta
        data = ds.load_tile(0, cfg.tilesz, dtype=dtype, device=dev)
    clusters, _, shapelets = load_sky(
        cfg.sky_model, cfg.cluster_file, meta.ra0, meta.dec0,
        dtype=torch.float64 if cfg.use_f64 else torch.float32, device=dev)
    tables = ([shapelets] * len(clusters)
              if shapelets is not None else None)
    problem = RefineProblem(data=data, clusters=clusters, tables=tables,
                            spec=spec, ridge=cfg.ridge)
    return problem, None


def run_refine_app(cfg: RefineConfig, log=print, device=None,
                   open_file=None) -> dict:
    """Run one refinement on ``device`` (CUDA unless ``device="cpu"``);
    returns the summary written to ``<out>.json``."""
    from sagecal_tpu_torch.elastic import (
        CheckpointManager, config_fingerprint, flatten_state,
        unflatten_state,
    )
    from sagecal_tpu_torch.obs.events import RunManifest, default_event_log
    from sagecal_tpu_torch.refine import (
        SkySpec, require_xla_predict, run_refine,
    )
    from sagecal_tpu_torch.solvers.lbfgs import LBFGSMemory

    require_xla_predict(False)
    dev = resolve_device(device)
    spec = SkySpec(flux=parse_keys(cfg.free_flux),
                   spec=parse_keys(cfg.free_spec),
                   pos=parse_keys(cfg.free_pos),
                   modes=parse_keys(cfg.free_modes))
    problem, true_flux = _build_problem(cfg, spec, log, dev, open_file)
    theta0 = spec.theta0(problem.clusters, problem.tables)

    manifest = RunManifest.collect(
        kernel_path="torch", device=dev, x64_enabled=cfg.use_f64,
        app="refine", nparams=spec.nparams, gradient=cfg.gradient,
        outer_iters=cfg.outer_iters, out_prefix=cfg.out_prefix)
    elog = default_event_log(manifest=manifest)
    fingerprint = config_fingerprint(
        app="refine", dataset=cfg.dataset, sky=cfg.sky_model,
        clusters=cfg.cluster_file, synthetic=cfg.synthetic,
        seed=cfg.seed, perturb=cfg.perturb, tilesz=cfg.tilesz,
        spec=repr(spec), gradient=cfg.gradient,
        inner_iters=cfg.inner_iters, cg_iters=cfg.cg_iters,
        ridge=cfg.ridge, use_f64=cfg.use_f64)
    every = cfg.checkpoint_every or (1 if cfg.resume else 0)
    manager = None
    if every > 0:
        manager = CheckpointManager(
            cfg.checkpoint_dir or f"{cfg.out_prefix}.ckpt", fingerprint,
            app="refine", every=every, elog=elog,
            log=log if cfg.verbose else None)

    start_iter = 0
    p_start = memory = None
    theta_start = theta0
    if cfg.resume and manager is not None:
        found = manager.resume()
        if found is not None:
            meta, arrays, path = found
            start_iter = int(meta["tile_index"]) + 1
            theta_start = torch.as_tensor(arrays["theta"]).to(
                theta0.device, theta0.dtype)
            p_start = arrays["p_warm"]
            memory = unflatten_state("mem", arrays, LBFGSMemory.init(
                int(theta0.shape[0]), cfg.lbfgs_m, theta0.dtype,
                theta0.device))
            log(f"resumed at outer iteration {start_iter} from {path}")

    out_dir = os.path.dirname(os.path.abspath(cfg.out_prefix))
    os.makedirs(out_dir, exist_ok=True)
    trace_fh = open(f"{cfg.out_prefix}.trace.jsonl",
                    "a" if start_iter > 0 else "w")

    def on_iteration(it, theta, mem, p_warm, entry):
        if true_flux is not None:
            entry["flux_err"] = abs(
                float(theta[0]) - true_flux) / abs(true_flux)
        trace_fh.write(json.dumps(entry) + "\n")
        trace_fh.flush()
        if elog is not None:
            elog.emit("refine_iter", **{k: v for k, v in entry.items()
                                        if k != "theta"})
        if manager is not None:
            manager.update(it, {"theta": theta, "p_warm": p_warm,
                                **flatten_state("mem", mem)})
        if cfg.verbose:
            log(f"outer {it}: cost {entry['cost']:.6e} "
                f"gradnorm {entry['gradnorm']:.3e}")

    t0 = time.perf_counter()
    try:
        res = run_refine(
            problem, theta0=theta_start, outer_iters=cfg.outer_iters,
            lbfgs_m=cfg.lbfgs_m, gradient=cfg.gradient,
            inner_iters=cfg.inner_iters, cg_iters=cfg.cg_iters,
            damping=cfg.damping, adjoint_cg_iters=cfg.adjoint_cg_iters,
            adjoint_matvec=cfg.adjoint_matvec, tol=cfg.tol,
            p_start=p_start, memory=memory, start_iter=start_iter,
            on_iteration=on_iteration)
    finally:
        trace_fh.close()
        if manager is not None:
            manager.flush()
            manager.close()
    wall = time.perf_counter() - t0

    theta = res.theta.detach().cpu().numpy()
    summary = {
        "app": "refine",
        "nparams": spec.nparams,
        "gradient": cfg.gradient,
        "outer_iters": res.iterations,
        "cost": res.cost,
        "gradnorm": res.gradnorm,
        "theta": theta.tolist(),
        "wall_s": wall,
        "outer_iters_per_sec": res.iterations / max(wall, 1e-9),
    }
    if true_flux is not None:
        summary["true_flux"] = true_flux
        summary["flux_err"] = abs(float(theta[0]) - true_flux) / abs(
            true_flux)
    with open(f"{cfg.out_prefix}.json", "w") as f:
        json.dump(summary, f, indent=2)
    np.savez(f"{cfg.out_prefix}.npz", theta=theta,
             p=res.p.detach().cpu().numpy())
    if elog is not None:
        elog.emit("refine_done", **{k: v for k, v in summary.items()
                                    if k != "theta"})
        elog.close()
    msg = (f"refine: {res.iterations} outer iterations in {wall:.1f}s, "
           f"cost {res.cost:.4e}, gradnorm {res.gradnorm:.3e}")
    if true_flux is not None:
        msg += f", flux rel err {summary['flux_err']:.2e}"
    log(msg)
    return summary


def main(argv=None, device=None, open_file=None) -> int:
    """The ``refine`` subcommand on ``device`` (None: the CUDA device),
    opening a dataset with ``open_file``.  Returns the exit code: 0; 5
    when ``--resume`` is refused; 2 for a usage error or ``--fused``
    (``FusedSkyGradientError``)."""
    from sagecal_tpu_torch.elastic import ResumeRefused
    from sagecal_tpu_torch.ops.rime_kernel import FusedSkyGradientError
    from sagecal_tpu_torch.refine import require_xla_predict

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.fused:
        try:
            require_xla_predict(True)
        except FusedSkyGradientError as e:
            print(f"sagecal_tpu_torch refine: FusedSkyGradientError: {e}",
                  file=sys.stderr)
            return 2
    cfg = config_from_args(args)
    if cfg.synthetic <= 0 and not cfg.dataset:
        ap.error("--dataset (or --synthetic N) is required")
    try:
        run_refine_app(cfg, device=device, open_file=open_file)
    except ResumeRefused as e:
        print(f"sagecal_tpu_torch refine: {e}", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
