"""The ``widefield`` app: wide-field calibration through the
hierarchical sky predict (counterpart of ``sagecal_tpu/apps/widefield.py``).

A synthetic compact-array observation over ``nsources`` point sources
(``data/simsky.py::make_sky(wide_field=True)``) is calibrated tile by
tile: the full source list is collapsed into ``nclusters``
tree-partitioned effective directions (``sky/tree.py::partition_by_
tree``), each tile's per-cluster coherencies come from
``predict_coherencies_hier`` (or the exact predict under ``--exact``),
the sampled a-posteriori error is checked by the quality watchdog
(``obs/quality.py::check_hier_predict``), and the SAGE solve
(``solvers/sage.py::solve_tile``) runs warm-started from the previous
tile, reset to identity gains after a diverged tile.  Every step runs on
``device`` (CUDA unless ``device="cpu"``); the joint LBFGS is the
torch-op cost, as the JAX package's is XLA's, so no CUDA kernel of the
package is launched.  Tile t's OS-LM subsets come from a CPU generator
seeded ``seed + t`` (the JAX package folds t into ``PRNGKey(seed)``).

Writes ``widefield.json`` (the JAX package's keys; each tile adds its
plan, predict, check and solve seconds) and ``solutions.npz``.  Exit
codes: 0 done; 3 divergence abort (``--abort-on-divergence``); 5 resume
refused.  ``--checkpoint-every`` checkpoints at tile boundaries (every
solved tile's gains ``g.<t>``, the warm start ``warm`` and the tiles'
records, as the reference); ``--resume`` restores the solved prefix.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from sagecal_tpu_torch.apps.config import WidefieldConfig
from sagecal_tpu_torch.device import resolve_device, synchronize


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.apps.cli widefield",
        description="10k+-source wide-field calibration via the "
        "tree-clustered hierarchical sky predict.")
    ap.add_argument("--out-dir", default="widefield-out")
    ap.add_argument("-n", "--nstations", type=int, default=24)
    ap.add_argument("--ntiles", type=int, default=4)
    ap.add_argument("-t", "--tilesz", type=int, default=2)
    ap.add_argument("--nchan", type=int, default=1)
    ap.add_argument("-S", "--nsources", type=int, default=2000,
                    help="total point sources across the field")
    ap.add_argument("--nblobs", type=int, default=12,
                    help="spatial blobs the sky generator draws")
    ap.add_argument("--fov", type=float, default=1.1,
                    help="field diameter in direction cosines")
    ap.add_argument("--cluster-scale", type=float, default=0.004)
    ap.add_argument("--freq0", type=float, default=30e6)
    ap.add_argument("--extent-m", type=float, default=80.0,
                    help="station layout radius (compact-array regime)")
    ap.add_argument("--gain-amp", type=float, default=0.1)
    ap.add_argument("--noise-sigma", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("-k", "--nclusters", type=int, default=4,
                    help="tree-collapsed effective calibration "
                    "directions fed to the solver")
    ap.add_argument("-p", "--order", type=int, default=8,
                    help="multipole/Taylor truncation order")
    ap.add_argument("--theta", type=float, default=1.5,
                    help="well-separation phase budget (radians); "
                    "<= 0 forces the exact near-field path")
    ap.add_argument("--leaf-size", type=int, default=32)
    ap.add_argument("--tile-rows", type=int, default=128)
    ap.add_argument("--source-chunk", type=int, default=32)
    ap.add_argument("--exact", action="store_true",
                    help="use the exact predict for the cluster "
                    "coherencies (parity / baseline runs)")
    ap.add_argument("--hier-nsample", type=int, default=32,
                    help="baseline rows sampled per tile for the "
                    "a-posteriori error check (0 disables)")
    ap.add_argument("--hier-max-rel-err", type=float, default=1e-3,
                    help="watchdog threshold on the sampled error "
                    "(<= 0: the a-priori bound of (order, theta))")
    ap.add_argument("-e", "--max-emiter", type=int, default=3)
    ap.add_argument("-g", "--max-iter", type=int, default=2)
    ap.add_argument("-l", "--max-lbfgs", type=int, default=10)
    ap.add_argument("-m", "--lbfgs-m", type=int, default=7)
    ap.add_argument("-j", "--solver-mode", type=int, default=3)
    ap.add_argument("-L", "--nulow", type=float, default=2.0)
    ap.add_argument("-H", "--nuhigh", type=float, default=30.0)
    ap.add_argument("-R", "--no-randomize", action="store_true")
    ap.add_argument("--res-ratio", type=float, default=5.0)
    ap.add_argument("--abort-on-divergence", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="adopt the newest checkpoint (refused on "
                    "fingerprint mismatch, exit 5)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help=">0 checkpoints every this many tiles; "
                    "--resume implies 1 when unset")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint directory (default: "
                    "<out-dir>/widefield.ckpt)")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("-V", "--verbose", action="store_true")
    return ap


def config_from_args(args) -> WidefieldConfig:
    return WidefieldConfig(
        out_dir=args.out_dir, nstations=args.nstations,
        ntiles=args.ntiles, tilesz=args.tilesz, nchan=args.nchan,
        nsources=args.nsources, nblobs=args.nblobs, fov=args.fov,
        cluster_scale=args.cluster_scale, freq0=args.freq0,
        extent_m=args.extent_m, gain_amp=args.gain_amp,
        noise_sigma=args.noise_sigma, seed=args.seed,
        nclusters=args.nclusters, order=args.order, theta=args.theta,
        leaf_size=args.leaf_size, tile_rows=args.tile_rows,
        source_chunk=args.source_chunk, exact=args.exact,
        hier_nsample=args.hier_nsample,
        hier_max_rel_err=args.hier_max_rel_err,
        max_emiter=args.max_emiter, max_iter=args.max_iter,
        max_lbfgs=args.max_lbfgs, lbfgs_m=args.lbfgs_m,
        solver_mode=args.solver_mode, nulow=args.nulow,
        nuhigh=args.nuhigh, randomize=not args.no_randomize,
        res_ratio=args.res_ratio,
        abort_on_divergence=args.abort_on_divergence,
        resume=args.resume, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, use_f64=not args.f32,
        verbose=args.verbose)


def _slice_tile(data, t: int, tilesz: int):
    """Tile ``t`` of a long observation: ``tilesz`` consecutive time
    samples with the time index rebased so chunk maps start at 0."""
    rpt = data.nbase * tilesz
    sl = slice(t * rpt, (t + 1) * rpt)
    return data.replace(
        u=data.u[sl], v=data.v[sl], w=data.w[sl],
        ant_p=data.ant_p[sl], ant_q=data.ant_q[sl],
        vis=data.vis[:, :, sl], mask=data.mask[:, sl],
        time_idx=data.time_idx[sl] - t * tilesz, tilesz=tilesz)


def _tile_coherencies(cfg: WidefieldConfig, data_t, eff_clusters,
                      timing: dict = None):
    """Per-cluster (F, 4, rows) coherencies of one tile, stacked:
    hierarchical by default, exact under ``cfg.exact``.  ``timing``
    (optional) gains the seconds of the plans (``plan_s``) and of the
    predicts (``predict_s``), each ended by a device sync."""
    from sagecal_tpu_torch.ops.rime import predict_coherencies
    from sagecal_tpu_torch.sky.predict import (
        build_hier_plan, predict_coherencies_hier,
    )

    dev = data_t.u.device
    plan_s = predict_s = 0.0
    cohs = []
    for src in eff_clusters:
        t0 = time.perf_counter()
        if cfg.exact or cfg.theta <= 0.0:
            coh = predict_coherencies(
                data_t.u, data_t.v, data_t.w, data_t.freqs, src, 0.0,
                cfg.source_chunk, has_extended=False, has_shapelet=False)
        else:
            plan = build_hier_plan(
                data_t.u, data_t.v, data_t.w, data_t.freqs, src,
                theta=cfg.theta, leaf_size=cfg.leaf_size,
                tile_rows=cfg.tile_rows)
            synchronize(dev)
            t1 = time.perf_counter()
            plan_s += t1 - t0
            t0 = t1
            coh = predict_coherencies_hier(
                data_t.u, data_t.v, data_t.w, data_t.freqs, src,
                order=cfg.order, source_chunk=cfg.source_chunk, plan=plan)
        synchronize(dev)
        predict_s += time.perf_counter() - t0
        cohs.append(coh)
    if timing is not None:
        timing.update(plan_s=plan_s, predict_s=predict_s)
    return torch.stack(cohs)


def _merge_sources(clusters):
    """One source batch of every cluster's sources, in cluster order."""
    from sagecal_tpu_torch.ops.rime import SourceBatch

    return SourceBatch(**{
        f.name: torch.cat([getattr(c, f.name) for c in clusters])
        for f in dataclasses.fields(SourceBatch)})


def run_widefield(cfg: WidefieldConfig, log=print, device=None) -> dict:
    """Run the widefield pipeline on ``device`` (CUDA unless
    ``device="cpu"``).  Returns the summary also written to
    widefield.json."""
    from sagecal_tpu_torch.obs.events import RunManifest, default_event_log
    from sagecal_tpu_torch.obs.flight import (
        close_flight_recorder, get_flight_recorder, install_crash_handlers,
        register_event_log, unregister_event_log,
    )
    from sagecal_tpu_torch.obs.trace import close_tracer, configure_tracer

    dev = resolve_device(device)
    manifest = RunManifest.collect(
        kernel_path="torch", device=dev, x64_enabled=cfg.use_f64,
        app="widefield", nsources=cfg.nsources, nclusters=cfg.nclusters,
        ntiles=cfg.ntiles, order=cfg.order, theta=cfg.theta,
        exact=cfg.exact)
    elog = default_event_log(manifest=manifest)
    install_crash_handlers()
    if elog is not None:
        register_event_log(elog)
    get_flight_recorder(run_id=manifest.run_id)
    configure_tracer(run_id=manifest.run_id)
    try:
        return _run_tiles(cfg, elog, dev, log)
    finally:
        close_tracer()
        if elog is not None:
            elog.close()
            unregister_event_log(elog)
        close_flight_recorder()


def _run_tiles(cfg: WidefieldConfig, elog, dev, log) -> dict:
    from sagecal_tpu_torch.core.types import (
        complex_dtype_of, identity_jones, jones_to_params,
    )
    from sagecal_tpu_torch.data.simsky import make_sky
    from sagecal_tpu_torch.elastic import (
        CheckpointManager, config_fingerprint,
    )
    from sagecal_tpu_torch.obs.quality import (
        abort_if_diverged, check_and_emit, check_hier_predict,
    )
    from sagecal_tpu_torch.obs.trace import get_tracer
    from sagecal_tpu_torch.sky.farfield import apriori_rel_bound
    from sagecal_tpu_torch.sky.predict import (
        gather_sources, sampled_error_estimate,
    )
    from sagecal_tpu_torch.sky.tree import (
        build_source_tree, partition_by_tree,
    )
    from sagecal_tpu_torch.solvers.sage import (
        ClusterData, SageConfig, solve_tile,
    )

    t_run = time.perf_counter()
    os.makedirs(cfg.out_dir, exist_ok=True)
    dtype = np.float64 if cfg.use_f64 else np.float32

    # one long observation; tiles are consecutive time slices of it
    sky = make_sky(
        nstations=cfg.nstations, tilesz=cfg.ntiles * cfg.tilesz,
        nchan=cfg.nchan, nclusters=cfg.nblobs, freq0=cfg.freq0,
        gain_amp=cfg.gain_amp, noise_sigma=cfg.noise_sigma,
        seed=cfg.seed, dtype=dtype, wide_field=True,
        nsources=cfg.nsources, fov=cfg.fov,
        cluster_scale=cfg.cluster_scale, extent_m=cfg.extent_m, device=dev)

    # hierarchical collapse: all sources -> nclusters effective
    # calibration directions at the shallowest tree level that holds
    # them (sky/tree.py::partition_by_tree)
    merged = _merge_sources(sky.clusters)
    tree = build_source_tree(
        merged.ll.cpu().double().numpy(), merged.mm.cpu().double().numpy(),
        merged.nn.cpu().double().numpy(), leaf_size=cfg.leaf_size)
    groups = partition_by_tree(tree, cfg.nclusters)
    eff_clusters = [gather_sources(merged, g) for g in groups]
    M, N = len(eff_clusters), cfg.nstations
    bound = apriori_rel_bound(cfg.order, cfg.theta)
    tol = cfg.hier_max_rel_err if cfg.hier_max_rel_err > 0 else bound
    log(f"widefield: {cfg.nsources} sources in {cfg.nblobs} blobs -> "
        f"{M} effective clusters "
        f"({', '.join(str(len(g)) for g in groups)} sources); "
        f"predict={'exact' if cfg.exact else f'hier(p={cfg.order}, theta={cfg.theta})'}")

    rdt = sky.data.u.dtype
    eye = jones_to_params(identity_jones(N, complex_dtype_of(rdt),
                                         device=dev))
    pinit = eye.expand(M, 1, 8 * N).to(rdt).clone()
    scfg = SageConfig(
        max_emiter=cfg.max_emiter, max_iter=cfg.max_iter,
        max_lbfgs=cfg.max_lbfgs, lbfgs_m=cfg.lbfgs_m,
        solver_mode=cfg.solver_mode, nulow=cfg.nulow,
        nuhigh=cfg.nuhigh, randomize=cfg.randomize)

    gains: dict = {}
    tiles_meta: dict = {}
    p = pinit
    max_rel_err = 0.0
    watchdog_ok = True
    tracer = get_tracer()
    fingerprint = config_fingerprint(
        app="widefield", nstations=cfg.nstations, ntiles=cfg.ntiles,
        tilesz=cfg.tilesz, nchan=cfg.nchan, nsources=cfg.nsources,
        nblobs=cfg.nblobs, nclusters=cfg.nclusters, fov=cfg.fov,
        freq0=cfg.freq0, extent_m=cfg.extent_m, seed=cfg.seed,
        order=cfg.order, theta=cfg.theta, exact=cfg.exact,
        solver_mode=cfg.solver_mode, max_emiter=cfg.max_emiter,
        max_iter=cfg.max_iter, max_lbfgs=cfg.max_lbfgs,
        use_f64=cfg.use_f64)
    every = cfg.checkpoint_every or (1 if cfg.resume else 0)
    manager = None
    if every > 0:
        manager = CheckpointManager(
            cfg.checkpoint_dir or os.path.join(cfg.out_dir,
                                               "widefield.ckpt"),
            fingerprint, app="widefield", every=every, elog=elog,
            log=log if cfg.verbose else None)
    start_tile = 0
    if cfg.resume and manager is not None:
        found = manager.resume()
        if found is not None:
            meta, arrays, path = found
            start_tile = int(meta["tile_index"]) + 1
            for i in range(start_tile):
                gains[i] = arrays[f"g.{i}"]
            p = torch.as_tensor(arrays["warm"]).to(dev, rdt)
            tiles_meta = {int(k): v for k, v in
                          json.loads(meta.get("tiles_json", "{}")).items()}
            log(f"resumed: tiles 0..{start_tile - 1} restored from {path}")
    # the verification state of a resumed prefix, so the summary equals
    # an uninterrupted run's
    for i in range(start_tile):
        tm = tiles_meta.get(i, {})
        if tm.get("rel_err") is not None:
            max_rel_err = max(max_rel_err, float(tm["rel_err"]))
        if tm.get("hier_verdict", "ok") != "ok":
            watchdog_ok = False
    try:
        for t in range(start_tile, cfg.ntiles):
            t0 = time.perf_counter()
            span = tracer.span("tile", kind="tile", tile=t)
            span.__enter__()
            data_t = _slice_tile(sky.data, t, cfg.tilesz)
            timing: dict = {}
            coh = _tile_coherencies(cfg, data_t, eff_clusters, timing)
            rows = int(data_t.u.shape[0])
            cdata = ClusterData(
                coh=coh,
                chunk_map=torch.zeros((M, rows), dtype=torch.int64,
                                      device=dev),
                nchunk=torch.ones((M,), dtype=torch.int64, device=dev))

            # a-posteriori check of the hierarchical prediction: the exact
            # predict on a sampled row subset of the largest effective
            # cluster against the same rows of its coherencies
            rel_err = None
            h_verdict = "ok"
            tc = time.perf_counter()
            if not cfg.exact and cfg.hier_nsample > 0:
                est = sampled_error_estimate(
                    data_t.u, data_t.v, data_t.w, data_t.freqs,
                    eff_clusters[0], coh[0], nsample=cfg.hier_nsample,
                    seed=cfg.seed + t, source_chunk=cfg.source_chunk)
                rel_err = float(est["rel_err"])
                max_rel_err = max(max_rel_err, rel_err)
                h_verdict, _ = check_hier_predict(
                    elog, rel_err, tol, log=log, tile=t, app="widefield",
                    order=cfg.order, theta=cfg.theta, apriori_bound=bound,
                    nsample=int(est["nsample"]))
                watchdog_ok = watchdog_ok and (h_verdict == "ok")
            check_s = time.perf_counter() - tc

            ts = time.perf_counter()
            res = solve_tile(data_t, cdata, p, scfg,
                             generator=torch.Generator().manual_seed(
                                 cfg.seed + t), device=dev)
            res0, res1 = float(res.res_0), float(res.res_1)
            solve_s = time.perf_counter() - ts
            diverged = (not np.isfinite(res1) or res1 == 0.0
                        or res1 > cfg.res_ratio * res0)
            gains[t] = res.p.detach().double().cpu().numpy()
            # warm-start chain: the next tile starts from this solution
            # (identity after a diverged tile, the fullbatch guard)
            p = pinit if diverged else res.p.detach().to(rdt)

            q_verdict, q_reasons = "ok", []
            if getattr(res, "quality", None) is not None:
                q_verdict, q_reasons = check_and_emit(
                    elog, res.quality, log=log, tile=t, app="widefield")
            if diverged:
                if q_verdict != "diverged" and elog is not None:
                    elog.emit(
                        "solver_diverged",
                        reasons=[f"residual_ratio:{res0:.3e}->{res1:.3e}"],
                        tile=t, app="widefield")
                q_verdict = "diverged"
                q_reasons = q_reasons + [
                    f"residual_ratio:{res0:.3e}->{res1:.3e}"]
            span.__exit__(None, None, None)
            if cfg.abort_on_divergence:
                abort_if_diverged(elog, q_verdict, q_reasons, tile=t,
                                  app="widefield")

            tiles_meta[t] = {
                "res_0": res0, "res_1": res1, "rel_err": rel_err,
                "hier_verdict": h_verdict, "solve_verdict": q_verdict,
                "seconds": time.perf_counter() - t0,
                "plan_s": timing.get("plan_s", 0.0),
                "predict_s": timing["predict_s"], "check_s": check_s,
                "solve_s": solve_s}
            if elog is not None:
                elog.emit("widefield_tile", tile=t, **tiles_meta[t])
            if cfg.verbose:
                err_s = "n/a" if rel_err is None else f"{rel_err:.3e}"
                log(f"tile {t}: res {res0:.4e} -> {res1:.4e}, "
                    f"hier_err {err_s} ({tiles_meta[t]['seconds']:.1f}s)")
            if manager is not None:
                arrays = {f"g.{i}": gains[i] for i in sorted(gains)}
                arrays["warm"] = p
                manager.update(t, arrays, tiles_json=json.dumps(
                    {str(k): v for k, v in tiles_meta.items()}))
    finally:
        if manager is not None:
            manager.flush()
            manager.close()

    stacked = np.stack([gains[t] for t in range(cfg.ntiles)])
    np.savez(os.path.join(cfg.out_dir, "solutions.npz"), gains=stacked,
             cluster_sizes=np.asarray([len(g) for g in groups]))
    summary = {
        "app": "widefield",
        "nsources": cfg.nsources,
        "nblobs": cfg.nblobs,
        "nclusters_eff": M,
        "cluster_sizes": [int(len(g)) for g in groups],
        "ntiles": cfg.ntiles,
        "exact": bool(cfg.exact),
        "order": cfg.order,
        "theta": cfg.theta,
        "apriori_bound": float(bound),
        "hier_max_rel_err": (None if cfg.exact or cfg.hier_nsample <= 0
                             else float(max_rel_err)),
        "hier_watchdog_ok": bool(watchdog_ok),
        "tiles": [tiles_meta[t] for t in range(cfg.ntiles)],
        "seconds": time.perf_counter() - t_run,
    }
    with open(os.path.join(cfg.out_dir, "widefield.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    log(f"widefield: {cfg.ntiles} tiles in {summary['seconds']:.1f}s, "
        f"max sampled rel err "
        f"{'n/a' if summary['hier_max_rel_err'] is None else f'{max_rel_err:.3e}'} "
        f"(tolerance {tol:.3e}), watchdog "
        f"{'ok' if watchdog_ok else 'DEGRADED'}")
    return summary


def main(argv=None, device=None) -> int:
    """The ``widefield`` subcommand on ``device`` (None: the CUDA
    device).  Returns the exit code: 0; 3 after a divergence abort; 5
    when ``--resume`` is refused."""
    from sagecal_tpu_torch.elastic import ResumeRefused
    from sagecal_tpu_torch.obs.quality import DivergenceAbort

    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = config_from_args(build_parser().parse_args(argv))
    try:
        run_widefield(cfg, device=device)
    except DivergenceAbort as e:
        print(f"sagecal_tpu_torch widefield: {e}", file=sys.stderr)
        return 3
    except ResumeRefused as e:
        print(f"sagecal_tpu_torch widefield: {e}", file=sys.stderr)
        return 5
    return 0


if __name__ == "__main__":
    sys.exit(main())
