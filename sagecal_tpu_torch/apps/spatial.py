"""The ``spatial`` app: spatial regularization as a workload of its own
(counterpart of ``sagecal_tpu/apps/spatial.py``).

The distributed app runs the spatial FISTA update inside its ADMM loop;
this app runs the same ``parallel/spatial.py`` machinery end to end over
consensus solutions:

1. each frequency band's calibration (``solvers/sage.py::sagefit``, the
   torch-op joint cost: it launches no CUDA kernel);
2. the consensus polynomial Z over the bands and the AIC/MDL scan of
   its order (``minimum_description_length``, the master's -M path);
3. the FISTA elastic-net regression of Z onto the spatial basis over the
   cluster centroids, and the raw and the spatially constrained
   consensus models written to ``<out>.json`` and ``<out>.npz``.

Input: ``-f`` glob of per-band vis.h5 datasets (over ``open_file``'s
registry when it has a ``glob``, as ``MemFile`` does) with sky and
cluster files, or ``--synthetic NBANDS`` (``data/simsky.py::
make_multiband_skies``: the same sky and gains in every band).  Every
step runs on ``device`` (CUDA unless ``device="cpu"``), in the run's
precision: float32/complex64 under ``--f32``, float64/complex128
otherwise.  Band b's OS-LM subsets come from a CPU generator seeded b
(the JAX package draws them from ``PRNGKey(b)``).  ``--checkpoint-every``
checkpoints after each solved band (``p.<b>`` for every band solved so
far, as the reference) and ``--resume`` restores the solved prefix
(exit 5 when the checkpoint belongs to another configuration).
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
import time

import numpy as np
import torch

from sagecal_tpu_torch.apps.config import SpatialConfig
from sagecal_tpu_torch.core.types import (
    complex_dtype_of, identity_jones, jones_to_params,
)
from sagecal_tpu_torch.data.simsky import make_multiband_skies
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.elastic.checkpoint import (
    CheckpointManager, ResumeRefused, config_fingerprint,
)
from sagecal_tpu_torch.io.dataset import VisDataset
from sagecal_tpu_torch.io.skymodel import load_sky
from sagecal_tpu_torch.obs.events import RunManifest, default_event_log
from sagecal_tpu_torch.parallel import consensus
from sagecal_tpu_torch.parallel.mesh import (
    _z_of_zbar_blocks, _zbar_blocks_of_z,
)
from sagecal_tpu_torch.parallel.spatial import (
    basis_blocks, cluster_centroids, minimum_description_length,
    phikk_matrix, spatial_basis_modes, spatial_model_apply,
    update_spatialreg_fista,
)
from sagecal_tpu_torch.solvers.sage import (
    SageConfig, build_cluster_data, sagefit,
)
from sagecal_tpu_torch.utils.precision import full_f32


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.apps.cli spatial",
        description="Spatial regularization of consensus solutions: "
        "per-band solves -> consensus polynomial + AIC/MDL scan -> "
        "FISTA elastic-net fit onto the spatial basis.")
    ap.add_argument("-f", "--band-pattern", default="",
                    help="glob of per-band vis.h5 datasets")
    ap.add_argument("-s", "--sky", default="", help="sky model file")
    ap.add_argument("-c", "--clusters", default="",
                    help="cluster file (defaults to <sky>.cluster)")
    ap.add_argument("-o", "--out", default="spatial-out",
                    help="output prefix (<out>.json/.npz)")
    ap.add_argument("-t", "--tilesz", type=int, default=2)
    ap.add_argument("-e", "--max-emiter", type=int, default=3)
    ap.add_argument("-g", "--max-iter", type=int, default=2)
    ap.add_argument("-l", "--max-lbfgs", type=int, default=10)
    ap.add_argument("-m", "--lbfgs-m", type=int, default=7)
    ap.add_argument("-j", "--solver-mode", type=int, default=3)
    ap.add_argument("-r", "--admm-rho", type=float, default=5.0)
    ap.add_argument("-P", "--npoly", type=int, default=2)
    ap.add_argument("-Q", "--poly-type", type=int, default=2)
    ap.add_argument("--spatial-n0", type=int, default=2,
                    help="spatial basis order (G = n0*n0 modes)")
    ap.add_argument("--spatial-beta", type=float, default=0.0,
                    help="shapelet basis scale; <=0 auto")
    ap.add_argument("--spatial-basis", choices=("shapelet", "sharmonic"),
                    default="shapelet")
    ap.add_argument("--spatial-mu", type=float, default=1e-3,
                    help="FISTA L1 strength")
    ap.add_argument("--fista-maxiter", type=int, default=60)
    ap.add_argument("--mdl-kmax", type=int, default=0,
                    help="max consensus order scanned (0: max(npoly,2))")
    ap.add_argument("--synthetic", type=int, default=0, metavar="NBANDS",
                    help="use a simulated multi-band sky instead of -f")
    ap.add_argument("--nstations", type=int, default=7,
                    help="stations for --synthetic")
    ap.add_argument("--noise-sigma", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("-V", "--verbose", action="store_true")
    return ap


def config_from_args(args) -> SpatialConfig:
    return SpatialConfig(
        band_pattern=args.band_pattern, sky_model=args.sky,
        cluster_file=args.clusters or (args.sky + ".cluster"
                                       if args.sky else ""),
        out_prefix=args.out, tilesz=args.tilesz,
        max_emiter=args.max_emiter, max_iter=args.max_iter,
        max_lbfgs=args.max_lbfgs, lbfgs_m=args.lbfgs_m,
        solver_mode=args.solver_mode, admm_rho=args.admm_rho,
        npoly=args.npoly, poly_type=args.poly_type,
        spatial_n0=args.spatial_n0, spatial_beta=args.spatial_beta,
        spatial_basis=args.spatial_basis, spatial_mu=args.spatial_mu,
        fista_maxiter=args.fista_maxiter, mdl_kmax=args.mdl_kmax,
        synthetic=args.synthetic, nstations=args.nstations,
        noise_sigma=args.noise_sigma, seed=args.seed,
        resume=args.resume, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, use_f64=not args.f32,
        verbose=args.verbose)


def _load_bands(cfg: SpatialConfig, log, dev, open_file=None):
    """-> (datas [F], clusters, freqs (F,)): the synthetic bands, or tile
    0 of each dataset in the glob."""
    dtype = np.float64 if cfg.use_f64 else np.float32
    if cfg.synthetic > 0:
        skies = make_multiband_skies(
            nbands=cfg.synthetic, nstations=cfg.nstations,
            tilesz=cfg.tilesz, noise_sigma=cfg.noise_sigma, seed=cfg.seed,
            dtype=dtype, device=dev)
        freqs = np.asarray([s.freq0 for s in skies])
        log(f"synthetic multi-band sky: {cfg.synthetic} bands, "
            f"{cfg.nstations} stations, {skies[0].nclusters} clusters")
        return [s.data for s in skies], skies[0].clusters, freqs
    finder = getattr(open_file, "glob", None)
    paths = (finder(cfg.band_pattern) if finder is not None
             else sorted(_glob.glob(cfg.band_pattern)))
    if not paths:
        raise FileNotFoundError(
            f"no datasets match band pattern {cfg.band_pattern!r}")
    datas, metas = [], []
    for p in paths:
        with VisDataset(p, "r", open_file) as ds:
            metas.append(ds.meta)
            datas.append(ds.load_tile(0, cfg.tilesz, dtype=dtype,
                                      device=dev))
    clusters, _, _ = load_sky(
        cfg.sky_model, cfg.cluster_file, metas[0].ra0, metas[0].dec0,
        dtype=torch.float64 if cfg.use_f64 else torch.float32, device=dev)
    freqs = np.asarray([m.freq0 for m in metas])
    log(f"{len(paths)} bands from {cfg.band_pattern!r}, "
        f"{len(clusters)} clusters")
    return datas, clusters, freqs


def _solve_bands(cfg: SpatialConfig, datas, clusters, manager, elog, log,
                 dev):
    """Per-band calibration solves -> (F, M, 8N) float64 numpy
    solutions.  Checkpointed per band; resume restores the solved
    prefix."""
    solved = {}
    start_band = 0
    if cfg.resume and manager is not None:
        found = manager.resume()
        if found is not None:
            meta, arrays, path = found
            start_band = int(meta["tile_index"]) + 1
            for b in range(start_band):
                solved[b] = arrays[f"p.{b}"]
            log(f"resumed: bands 0..{start_band - 1} restored from {path}")
    M = len(clusters)
    N = datas[0].nstations
    rdt = datas[0].u.dtype
    scfg = SageConfig(max_emiter=cfg.max_emiter, max_iter=cfg.max_iter,
                      max_lbfgs=cfg.max_lbfgs, lbfgs_m=cfg.lbfgs_m,
                      solver_mode=cfg.solver_mode)
    eye = jones_to_params(identity_jones(N, complex_dtype_of(rdt),
                                         device=dev))
    p0 = eye.expand(M, 1, 8 * N).clone()
    for b in range(start_band, len(datas)):
        t0 = time.perf_counter()
        cdata = build_cluster_data(datas[b], clusters, [1] * M)
        res = sagefit(datas[b], cdata, p0, scfg,
                      generator=torch.Generator().manual_seed(b), device=dev)
        solved[b] = res.p.double().reshape(M, -1).cpu().numpy()
        res_0, res_1 = float(res.res_0), float(res.res_1)
        if elog is not None:
            elog.emit("band_solved", band=b, res_0=res_0, res_1=res_1,
                      diverged=bool(res.diverged),
                      seconds=time.perf_counter() - t0)
        if cfg.verbose:
            log(f"band {b}: res {res_0:.4e} -> {res_1:.4e}")
        if manager is not None:
            manager.update(b, {f"p.{i}": solved[i] for i in sorted(solved)})
    return np.stack([solved[b] for b in range(len(datas))])


def run_spatial(cfg: SpatialConfig, log=print, device=None,
                open_file=None) -> dict:
    """Run the spatial pipeline on ``device`` (CUDA unless
    ``device="cpu"``); returns the summary written to ``<out>.json``."""
    dev = resolve_device(device)
    rdt = torch.float64 if cfg.use_f64 else torch.float32
    t_run = time.perf_counter()
    datas, clusters, freqs = _load_bands(cfg, log, dev, open_file)
    F, M, N = len(datas), len(clusters), datas[0].nstations
    n8 = 8 * N
    freq0 = float(np.mean(freqs))
    rho = np.full((M,), cfg.admm_rho)

    manifest = RunManifest.collect(
        device=dev, x64_enabled=cfg.use_f64, app="spatial", bands=F,
        nclusters=M, npoly=cfg.npoly, spatial_n0=cfg.spatial_n0,
        spatial_basis=cfg.spatial_basis, out_prefix=cfg.out_prefix)
    elog = default_event_log(manifest=manifest)
    fingerprint = config_fingerprint(
        app="spatial", band_pattern=cfg.band_pattern,
        sky=cfg.sky_model, clusters=cfg.cluster_file,
        synthetic=cfg.synthetic, nstations=cfg.nstations,
        seed=cfg.seed, tilesz=cfg.tilesz, bands=F,
        solver_mode=cfg.solver_mode, max_emiter=cfg.max_emiter,
        max_iter=cfg.max_iter, use_f64=cfg.use_f64)
    every = cfg.checkpoint_every or (1 if cfg.resume else 0)
    manager = None
    if every > 0:
        manager = CheckpointManager(
            cfg.checkpoint_dir or f"{cfg.out_prefix}.ckpt", fingerprint,
            app="spatial", every=every, elog=elog,
            log=log if cfg.verbose else None)
    try:
        J = _solve_bands(cfg, datas, clusters, manager, elog, log, dev)
    finally:
        if manager is not None:
            manager.flush()
            manager.close()

    # rho-scaled solutions (the master's weight*rho*J blocks); the bands
    # of one tile carry no flags here, so the band weights are 1
    w = np.ones((F,))
    Jst = J * w[:, None, None] * rho[None, :, None]
    kmax = cfg.mdl_kmax or max(cfg.npoly, 2)
    aic, mdl, k_aic, k_mdl = minimum_description_length(
        Jst, rho, freqs, freq0, weight=w, polytype=cfg.poly_type,
        Kstart=1, Kfinish=kmax)
    log(f"MDL scan orders 1..{kmax}: best AIC={k_aic} MDL={k_mdl} "
        f"(aic {np.array2string(aic, precision=2)}, "
        f"mdl {np.array2string(mdl, precision=2)})")
    if elog is not None:
        elog.emit("mdl_selected", k_aic=int(k_aic), k_mdl=int(k_mdl),
                  aic=[float(x) for x in aic],
                  mdl=[float(x) for x in mdl], kmax=kmax)

    with full_f32():
        # the consensus polynomial Z at the configured order, in the
        # run's precision on the device
        ptype = (consensus.POLY_NORMALIZED if cfg.npoly == 1
                 else cfg.poly_type)
        B = consensus.setup_polynomials(freqs, freq0, cfg.npoly,
                                        ptype).to(dev, rdt)
        Bi = consensus.find_prod_inverse(
            B, torch.as_tensor(w, dtype=rdt, device=dev))
        Jst_t = torch.as_tensor(Jst).to(dev, rdt)
        inv_rho = torch.as_tensor(1.0 / rho, dtype=rdt, device=dev)
        z = torch.einsum("fp,fmk->mpk", B, Jst_t) * inv_rho[:, None, None]
        Z = torch.einsum("pq,mqk->mpk", Bi, z)  # (M, Npoly, 8N)

        # the basis over the flux-weighted cluster centroids (nchunk 1:
        # the effective clusters are the clusters)
        lls, mms = cluster_centroids(clusters)
        modes, beta_used = spatial_basis_modes(
            lls, mms, cfg.spatial_n0,
            None if cfg.spatial_beta <= 0 else cfg.spatial_beta,
            cfg.spatial_basis)
        log(f"spatial basis {cfg.spatial_basis} n0={cfg.spatial_n0} "
            f"beta={beta_used:.4g}")
        Phi = basis_blocks(modes, complex_dtype_of(rdt), dev)
        Phikk = phikk_matrix(Phi, lam=1e-6)

        # FISTA elastic-net regression of Zbar onto the basis (fista.c)
        t_fista = time.perf_counter()
        Zbar = _zbar_blocks_of_z(Z, M, cfg.npoly, 1, n8)
        Zs = update_spatialreg_fista(Zbar, Phikk, Phi, cfg.spatial_mu,
                                     maxiter=cfg.fista_maxiter)
        Zbar_sp = spatial_model_apply(Zs, Phi)
        Z_spatial = _z_of_zbar_blocks(Zbar_sp, M, cfg.npoly, 1, n8)
        fit_rel = float(torch.linalg.norm((Zbar - Zbar_sp).reshape(-1))
                        / torch.clamp(torch.linalg.norm(Zbar.reshape(-1)),
                                      min=1e-30))
        fista_s = time.perf_counter() - t_fista
        nnz = int((Zs.abs() > 0).sum())
    log(f"FISTA fit: rel residual {fit_rel:.4e}, {nnz}/{Zs.numel()} "
        f"nonzero coefficients in {fista_s:.2f}s")
    if elog is not None:
        elog.emit("spatial_fista", fit_rel=fit_rel, nnz=nnz,
                  maxiter=cfg.fista_maxiter, mu=cfg.spatial_mu,
                  beta=beta_used, seconds=fista_s)

    wall = time.perf_counter() - t_run
    summary = {
        "app": "spatial", "bands": F, "nclusters": M, "nstations": N,
        "npoly": cfg.npoly, "spatial_n0": cfg.spatial_n0,
        "spatial_basis": cfg.spatial_basis, "beta": beta_used,
        "k_aic": int(k_aic), "k_mdl": int(k_mdl),
        "aic": [float(x) for x in aic], "mdl": [float(x) for x in mdl],
        "fista_fit_rel": fit_rel, "fista_nnz": nnz, "wall_s": wall,
    }
    os.makedirs(os.path.dirname(os.path.abspath(cfg.out_prefix)),
                exist_ok=True)
    with open(f"{cfg.out_prefix}.json", "w") as f:
        json.dump(summary, f, indent=2)
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    np.savez(f"{cfg.out_prefix}.npz", J=J, Z=host(Z), Zs=host(Zs),
             Z_spatial=host(Z_spatial), aic=aic, mdl=mdl, freqs=freqs)
    if elog is not None:
        elog.emit("spatial_done", **{k: v for k, v in summary.items()
                                     if k not in ("aic", "mdl")})
        elog.close()
    log(f"spatial: {F} bands -> order-{cfg.npoly} consensus -> "
        f"{cfg.spatial_n0 ** 2}-mode {cfg.spatial_basis} fit in "
        f"{wall:.1f}s -> {cfg.out_prefix}.json/.npz")
    return summary


def main(argv=None, device=None, open_file=None) -> int:
    """The ``spatial`` subcommand on ``device`` (None: the CUDA device),
    opening datasets with ``open_file``.  Returns the exit code: 0, 5
    when ``--resume`` is refused, or 2 for a usage error."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = build_parser()
    cfg = config_from_args(ap.parse_args(argv))
    if cfg.synthetic <= 0 and not cfg.band_pattern:
        ap.error("-f PATTERN (or --synthetic N) is required")
    try:
        run_spatial(cfg, device=device, open_file=open_file)
    except ResumeRefused as e:
        print(f"sagecal_tpu_torch spatial: {e}", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
