"""Multi-band consensus-ADMM calibration: the ``sagecal-mpi`` app
(counterpart of ``sagecal_tpu/apps/distributed.py``).

Per tile: every band's tile loaded (one prefetcher a band) with its
coherencies -> rho scaled by each band's unflagged fraction (master
:709-723) -> the consensus ADMM over the bands
(``parallel/mesh.py::make_admm_mesh_fn``, ``nshards`` virtual shards on
the one device) -> the global-Z file (master :499-533, :1165-1175), the
per-band solution files and each band's residual column (slave
:959-979).  The bands' metadata are checked against each other first
(master :238-287), and a band count that is not a multiple of the shard
count is padded with zero-weight bands.

``nshards`` defaults to the band count: one shard a band, every band
solved every round, as ``sagecal-mpi`` runs with one worker a band.  The
JAX package takes ``min(#devices, Nf)``, so its rounds depend on the
host; pass ``nshards`` to reproduce a given mesh (ROADMAP.md, Queue C).

The unflagged fractions are read to the host once a tile, where the JAX
package reads them.  The residuals go through the fused predict (kernel
#1) on float32 data, ``solvers/sage.py::predict_full_model`` on float64.
With ``-U`` (``global_residual``) the residual uses the consensus
solution B_f Z instead of the band's own.  ``mdl`` logs the AIC/MDL
scan of the consensus order each tile (``parallel/spatial.py``).

A run emits the ``admm_round`` (with per-band residuals and the rho
trajectory under ``SAGECAL_TELEMETRY=1``) and ``consensus_health``
events, runs the consensus watchdog (``--abort-on-divergence``), writes
a ``distributed`` run span, ``tile`` spans and the synthetic per-band
and per-round spans of the ADMM window, and keeps the flight recorder,
as the fullbatch app does.  ``resume`` / ``checkpoint_every`` need
ROADMAP.md's A9; spatial regularization and multi-host runs its A7.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from sagecal_tpu_torch.apps.config import RunConfig
from sagecal_tpu_torch.apps.fullbatch import _mat_of_flat, _refuse
from sagecal_tpu_torch.core.types import (
    identity_jones, jones_to_params, params_to_jones,
)
from sagecal_tpu_torch.device import resolve_device, synchronize
from sagecal_tpu_torch.io import solutions as solio
from sagecal_tpu_torch.io.dataset import TilePrefetcher, VisDataset
from sagecal_tpu_torch.io.skymodel import load_sky, read_cluster_rho
from sagecal_tpu_torch.obs.events import RunManifest, default_event_log
from sagecal_tpu_torch.obs.flight import (
    close_flight_recorder, get_flight_recorder, install_crash_handlers,
    note_activity, register_event_log, unregister_event_log,
)
from sagecal_tpu_torch.obs.registry import get_registry, telemetry_enabled
from sagecal_tpu_torch.obs.trace import (
    band_attribution, close_tracer, configure_tracer, get_tracer,
    straggler_stats,
)
from sagecal_tpu_torch.ops.residual import calculate_residuals
from sagecal_tpu_torch.parallel import consensus
from sagecal_tpu_torch.parallel.admm import (
    factor_schedule, round_work_weights,
)
from sagecal_tpu_torch.parallel.mesh import make_admm_mesh_fn, stack_for_mesh
from sagecal_tpu_torch.solvers.lm import LMConfig
from sagecal_tpu_torch.solvers.sage import build_cluster_data
from sagecal_tpu_torch.utils.profiling import PhaseTimer


def write_global_z_header(fh, freq0_hz, npoly, nstations, nclusters, neff):
    """Global-Z solution file header (sagecal_master.cpp:515-517)."""
    fh.write("# solution file (Z) created by SAGECal\n")
    fh.write("# reference_freq(MHz) polynomial_order stations clusters "
             "effective_clusters\n")
    fh.write(f"{freq0_hz * 1e-6:.6f} {npoly} {nstations} {nclusters} {neff}\n")


def append_global_z(fh, Z, nstations, npoly, nchunk_max, flush: bool = True):
    """One timeslot's Z rows (sagecal_master.cpp:1165-1175): row p of
    N*8*Npoly values, effective-cluster columns in reverse order, written
    in one buffered write.  Z: (M, Npoly, nchunk_max*8N) real, a tensor
    (copied to the host) or an array."""
    if isinstance(Z, torch.Tensor):
        Z = Z.detach().cpu().numpy()
    M = Z.shape[0]
    n8 = 8 * nstations
    Zb = np.asarray(Z).reshape(M, npoly, nchunk_max, n8)
    cols = [Zb[m, :, c, :].reshape(-1)
            for m in range(M) for c in range(nchunk_max)][::-1]
    buf = "".join(
        f"{p} " + " ".join(f"{col[p]:e}" for col in cols) + "\n"
        for p in range(npoly * n8))
    fh.write(buf)
    if flush:
        fh.flush()


def _check_band_consistency(metas, log):
    """The master's metadata validation (sagecal_master.cpp:238-287):
    every band must agree on N and the baseline count; the timeslot
    count is the minimum over the bands."""
    n0, nb0, nt0 = metas[0].nstations, metas[0].nbase, metas[0].ntime
    for i, m in enumerate(metas[1:], 1):
        if (m.nstations, m.nbase) != (n0, nb0):
            raise ValueError(
                f"band {i}: station/baseline layout mismatch "
                f"({m.nstations},{m.nbase}) != ({n0},{nb0})")
        if m.ntime != nt0:
            log(f"warning: band {i} has {m.ntime} timeslots != {nt0}; "
                f"using the minimum")
    return min(m.ntime for m in metas)


def _emit_admm_attribution(tracer, elog, log, t0, admm_seconds,
                           admm_start_unix, fratios, nf, nadmm, nslots,
                           plain_emiter, max_emiter, cluster_groups=1):
    """Straggler attribution of one tile's ADMM window: the measured
    seconds distributed over the bands' unflagged fractions and the
    per-round work model (``parallel/admm.py::round_work_weights``) as
    synthetic child spans that sum to the window, the straggler gauges,
    and a ``straggler_detected`` event.  Returns (band seconds, stats)."""
    weights = [float(f) for f in fratios[:nf]]
    band_secs = band_attribution(admm_seconds, weights)
    stats = straggler_stats(band_secs)
    if tracer.enabled:
        admm_id = tracer.add_span(
            "admm", admm_seconds, start_unix=admm_start_unix, kind="admm",
            tile=t0, nadmm=nadmm, nf=nf)
        rsecs = band_attribution(admm_seconds, round_work_weights(
            nadmm, nslots, plain_emiter, max_emiter, slot_rows=weights,
            cluster_groups=cluster_groups))
        r_start = admm_start_unix
        for r, s in enumerate(rsecs):
            tracer.add_span("admm.round", s, parent_id=admm_id,
                            start_unix=r_start, round=r, tile=t0,
                            synthetic=True, attribution="round-work-model")
            r_start += s
        for b, s in enumerate(band_secs):
            tracer.add_span("admm.band", s, parent_id=admm_id,
                            start_unix=admm_start_unix, band=b, tile=t0,
                            lane=f"band{b}", synthetic=True,
                            attribution="unflagged-rows")
    reg = get_registry()
    for b, s in enumerate(band_secs):
        reg.gauge_set("admm_band_seconds", s,
                      help="attributed per-band seconds of the last "
                           "ADMM window", band=str(b))
    reg.gauge_set("admm_straggler_ratio", stats["ratio"],
                  help="slowest/median attributed band seconds of the "
                       "last ADMM window")
    reg.gauge_set("admm_band_skew", stats["skew"],
                  help="(max-mean)/mean attributed band seconds")
    if stats["detected"]:
        if elog is not None:
            elog.emit("straggler_detected", tile=t0, band=stats["argmax"],
                      ratio=stats["ratio"], skew=stats["skew"],
                      band_seconds=band_secs, threshold=stats["threshold"])
        log(f"tile {t0}: straggler band {stats['argmax']} "
            f"({stats['ratio']:.2f}x median attributed work)")
    return band_secs, stats


def run_distributed(cfg: RunConfig, datasets: Optional[Sequence[str]] = None,
                    log=print, nadmm: Optional[int] = None, mdl: bool = False,
                    global_residual: bool = False, adaptive_rho: bool = True,
                    nshards: Optional[int] = None, device=None,
                    open_file=None):
    """Calibrate a multi-band observation on ``device`` (CUDA unless
    ``device="cpu"``).  ``datasets``: the band files, or None to expand
    ``cfg.dataset`` as a glob (the reference's ``-f 'pattern'``; over
    ``open_file``'s registry when it has a ``glob``, as ``MemFile``
    does).  ``nshards``: the virtual shards (module doc).  Returns the
    per-tile (dual_res, primal_res) traces."""
    _refuse(cfg)
    dev = resolve_device(device)
    if datasets is None:
        finder = getattr(open_file, "glob", None)
        datasets = (finder(cfg.dataset) if finder is not None
                    else sorted(_glob.glob(cfg.dataset)))
    if not datasets:
        raise ValueError(f"no band datasets match {cfg.dataset!r}")
    nadmm = nadmm if nadmm is not None else max(cfg.admm_iters, 2)
    handles: List[VisDataset] = []
    open_files: List = []
    try:
        for p in datasets:
            handles.append(VisDataset(p, "r+", open_file))
        return _run(cfg, list(datasets), handles, open_files, log, nadmm,
                    mdl, global_residual, adaptive_rho, nshards, dev,
                    open_file)
    finally:
        for fh in open_files + handles:
            try:
                fh.close()
            except Exception:
                pass


def _run(cfg, datasets, handles, open_files, log, nadmm, mdl,
         global_residual, adaptive_rho, nshards, dev, open_file):
    rdt = torch.float64 if cfg.use_f64 else torch.float32
    cdtype = torch.complex128 if cfg.use_f64 else torch.complex64
    metas = [h.meta for h in handles]
    ntime = _check_band_consistency(metas, log)
    meta0 = metas[0]
    N = meta0.nstations
    freqs = np.asarray([m.freq0 for m in metas])
    freq0 = float(np.mean(freqs))
    clusters, cdefs, shapelets = load_sky(
        cfg.sky_model, cfg.cluster_file, meta0.ra0, meta0.dec0, dtype=rdt,
        three_term_spectra=None if cfg.sky_format < 0 else bool(cfg.sky_format),
        device=dev)
    M = len(clusters)
    nchunks = [cd.nchunk for cd in cdefs]
    nchunk_max = max(nchunks)
    n8 = 8 * N
    if cfg.rho_file:
        rho_m, _ = read_cluster_rho(cfg.rho_file, cdefs, spatialreg=True)
    else:
        rho_m = np.full((M,), cfg.admm_rho)

    # pad the band count to a multiple of the shards with zero-weight
    # bands
    Nf = len(datasets)
    ndev = min(int(nshards), Nf) if nshards else Nf
    Nf_pad = -(-Nf // ndev) * ndev
    log(f"distributed: {Nf} bands on {ndev} shards"
        + (f" (padded to {Nf_pad})" if Nf_pad != Nf else ""))
    B = consensus.setup_polynomials(freqs, freq0, cfg.npoly,
                                    cfg.poly_type).numpy()
    if Nf_pad != Nf:
        B = np.concatenate([B, np.tile(B[-1:], (Nf_pad - Nf, 1))], axis=0)
    B_dev = torch.as_tensor(B, dtype=rdt).to(dev)

    # per-band trajectories feed the consensus watchdog too, so an
    # abort-enabled run collects them with telemetry off
    collect = telemetry_enabled() or cfg.abort_on_divergence
    cg = max(cfg.consensus_cluster_groups, 1)

    def build_mesh_fn(band_weights=None):
        ccfg = consensus.ConsensusConfig(
            zstep=cfg.consensus_zstep, cluster_groups=cg,
            staleness=(cfg.consensus_staleness
                       if cfg.consensus_staleness > 0 else None),
            staleness_discount=cfg.consensus_staleness_discount)
        if band_weights is not None:
            slot_s, group_s = factor_schedule(
                nadmm, Nf_pad // ndev, cluster_groups=cg,
                band_weights=band_weights, ndev=ndev)
            ccfg = dataclasses.replace(ccfg, slot_schedule=slot_s,
                                       group_schedule=group_s)
        return make_admm_mesh_fn(
            ndev, nadmm=nadmm, max_emiter=cfg.max_emiter,
            plain_emiter=max(cfg.max_emiter, 2),
            lm_config=LMConfig(itmax=cfg.max_iter), bb_rho=adaptive_rho,
            solver_mode=cfg.solver_mode, collect_trace=collect,
            consensus_cfg=ccfg, device=dev)

    # fine-grained rounds rebalance their slot schedule on the first
    # tile's unflagged fractions: the function is built there
    want_rebalance = (cfg.consensus_cluster_groups > 1
                      and cfg.consensus_staleness <= 0
                      and cfg.consensus_staleness_discount == 1.0)
    fn = None if want_rebalance else build_mesh_fn()
    manifest = RunManifest.collect(
        device=dev, x64_enabled=cfg.use_f64, app="distributed", bands=Nf,
        nadmm=nadmm, nshards=ndev, solver_mode=cfg.solver_mode,
        n_clusters=M, n_stations=N, adaptive_rho=adaptive_rho)
    elog = default_event_log(manifest=manifest)
    install_crash_handlers()
    if elog is not None:
        register_event_log(elog)
    get_flight_recorder(run_id=manifest.run_id)
    configure_tracer(run_id=manifest.run_id)
    tracer = get_tracer()

    # solution files: the global Z and one per band
    zfh = open(cfg.out_solutions, "w")
    open_files.append(zfh)
    write_global_z_header(zfh, freq0, cfg.npoly, N, M, M * nchunk_max)
    band_fhs = []
    for i in range(Nf):
        fh = open(f"{cfg.out_solutions}.band{i}", "w")
        open_files.append(fh)
        solio.write_header(fh, metas[i].freq0, metas[i].deltaf,
                           metas[i].deltat * cfg.tilesz / 60.0, N, M,
                           M * nchunk_max)
        band_fhs.append(fh)

    eye = jones_to_params(identity_jones(N, cdtype, device=dev))
    p_bands = eye.expand(Nf_pad, M, nchunk_max, n8).clone()

    traces = []
    pairs = [(i, t0) for i, t0 in enumerate(range(0, ntime, cfg.tilesz))
             if i >= cfg.skip_tiles]
    if cfg.max_tiles:
        pairs = pairs[:cfg.max_tiles]
    # one prefetcher a band reads its next full-size tile while this one
    # solves; the final clamped partial tile loads directly
    spec = dict(average_channels=True, min_uvcut=cfg.min_uvcut,
                max_uvcut=cfg.max_uvcut,
                dtype=np.float64 if cfg.use_f64 else np.float32,
                column=cfg.in_column)
    full_t0s = [t0 for _, t0 in pairs
                if min(cfg.tilesz, ntime - t0) == cfg.tilesz]
    prefetchers = [TilePrefetcher(path, full_t0s, [spec], cfg.tilesz,
                                  depth=1, open_file=open_file)
                   for path in datasets]
    timer = PhaseTimer()
    pf_iters = []

    def prepare_tile(t0):
        """Every band's tile on the device with its coherencies, and the
        unflagged fractions as device scalars (read once a tile)."""
        datas, cdatas, fratios = [], [], []
        # clamp to the common timeslot range: equal rows in every band
        eff_tilesz = min(cfg.tilesz, ntime - t0)
        for bi, h in enumerate(handles):
            if eff_tilesz == cfg.tilesz:
                t0_chk, (d,) = next(pf_iters[bi])
                if t0_chk != t0:
                    raise RuntimeError(f"band {bi} prefetch order mismatch: "
                                       f"{t0_chk} != {t0}")
                d = d.to(dev)
            else:
                d = h.load_tile(t0, eff_tilesz, device=dev, **spec)
            # static fields agree across the stacked bands; each band
            # keeps its own channel ``freqs``
            d = d.replace(freq0=freq0, deltaf=meta0.deltaf)
            datas.append(d)
            cdatas.append(build_cluster_data(d, clusters, nchunks,
                                             shapelets=shapelets))
            fratios.append(d.mask.mean())
        for _ in range(Nf_pad - Nf):  # band 0 with mask 0
            datas.append(datas[0].replace(
                mask=torch.zeros_like(datas[0].mask)))
            cdatas.append(cdatas[0])
            fratios.append(torch.zeros((), dtype=rdt, device=dev))
        return datas, cdatas, fratios

    run_span = tracer.span("distributed", kind="run", bands=Nf, ndev=ndev,
                           nadmm=nadmm)
    run_span.__enter__()
    try:
        pf_iters = [iter(pf.__enter__()) for pf in prefetchers]
        prepared = None
        if pairs:
            with timer.phase("prepare"):
                prepared = prepare_tile(pairs[0][1])
        for pi, (tile_no, t0) in enumerate(pairs):
            tic = time.time()
            tile_span = tracer.span("tile", kind="tile", tile=t0)
            tile_span.__enter__()
            datas, cdatas, fratios_dev = prepared
            fratios = torch.stack([f.to(rdt) for f in fratios_dev]).tolist()
            # rho scaled by each band's unflagged fraction (master :709-723)
            rho = torch.as_tensor(np.asarray(fratios)[:, None]
                                  * rho_m[None, :], dtype=rdt).to(dev)
            if fn is None:
                bw = np.zeros((Nf_pad,))
                bw[:Nf] = np.asarray(fratios[:Nf])
                fn = build_mesh_fn(band_weights=bw)
            admm_start_unix = time.time()
            t_start = time.perf_counter()
            with timer.phase("solve"):
                out = fn(stack_for_mesh(datas), stack_for_mesh(cdatas),
                         p_bands, rho, B_dev)
                synchronize(dev)
            admm_seconds = time.perf_counter() - t_start
            p_bands = out.p  # the next tile's warm start
            if pi + 1 < len(pairs):
                with timer.phase("prepare"):
                    prepared = prepare_tile(pairs[pi + 1][1])
            band_secs, straggler = _emit_admm_attribution(
                tracer, elog, log, t0, admm_seconds, admm_start_unix,
                fratios, Nf, nadmm, Nf_pad // ndev,
                max(cfg.max_emiter, 2), cfg.max_emiter, cluster_groups=cg)
            note_activity("tile", name=f"tile{t0}", seconds=admm_seconds)
            if mdl:
                from sagecal_tpu_torch.parallel.spatial import (
                    minimum_description_length,
                )

                w = np.asarray(fratios[:Nf])
                Jst = (out.p[:Nf].double().cpu().numpy().reshape(Nf, M, -1)
                       * w[:, None, None] * np.asarray(rho_m)[None, :, None])
                aic, mdl_s, k_aic, k_mdl = minimum_description_length(
                    Jst, rho_m, freqs, freq0, weight=w, Kstart=1,
                    Kfinish=max(cfg.npoly, 2))
                log(f"tile {t0} MDL: best order AIC={k_aic} MDL={k_mdl} "
                    f"(aic {np.array2string(aic, precision=2)}, "
                    f"mdl {np.array2string(mdl_s, precision=2)})")
            with timer.phase("write"):
                append_global_z(zfh, out.Z, N, cfg.npoly, nchunk_max)
                jsols = params_to_jones(out.p[:Nf]).reshape(
                    Nf, M * nchunk_max, N, 2, 2).cpu().numpy()
                for i in range(Nf):
                    solio.append_solutions(band_fhs[i], jsols[i])
                    p_res = out.p[i]
                    if global_residual:
                        # -U: residuals of the consensus solution B_f Z
                        # (sagecal_slave.cpp:861-979)
                        p_res = consensus.bz_for_freq(out.Z, B_dev[i]).reshape(
                            M, nchunk_max, n8)
                    res = calculate_residuals(datas[i], cdatas[i], p_res)
                    handles[i].write_tile(t0, _mat_of_flat(res),
                                          column=cfg.out_column)
            dres_h = out.dual_res.cpu().numpy()
            pres_h = out.primal_res.cpu().numpy()
            traces.append((dres_h, pres_h))
            band_h = None
            if out.primal_res_band is not None:
                band_h = (out.primal_res_band.cpu().numpy(),
                          out.dual_res_band.cpu().numpy(),
                          out.rho_trace.cpu().numpy())
            if elog is not None:
                extra = {}
                if band_h is not None:
                    extra = dict(primal_res_band=band_h[0],
                                 dual_res_band=band_h[1],
                                 rho_trace=band_h[2])
                elog.emit("admm_round", tile=t0, nadmm=nadmm,
                          primal_res=pres_h, dual_res=dres_h,
                          seconds=time.time() - tic,
                          admm_seconds=admm_seconds, band_seconds=band_secs,
                          straggler_ratio=straggler["ratio"],
                          phase_seconds=timer.tile_timings(), **extra)
            if band_h is not None:
                # the consensus watchdog on the per-band trajectories
                from sagecal_tpu_torch.obs.quality import (
                    abort_if_diverged, assess_consensus,
                )

                verdict, reasons, health = assess_consensus(band_h[0],
                                                            band_h[1])
                if elog is not None:
                    elog.emit("consensus_health", tile=t0, verdict=verdict,
                              reasons=reasons, ratio=health["ratio"],
                              trend=health["trend"])
                    if verdict == "diverged":
                        elog.emit("solver_diverged", reasons=reasons,
                                  tile=t0, app="distributed")
                if verdict != "ok":
                    log(f"tile {t0}: consensus watchdog {verdict} "
                        f"({', '.join(reasons)})")
                if cfg.abort_on_divergence:
                    abort_if_diverged(elog, verdict, reasons, tile=t0,
                                      app="distributed")
            log(f"tile {t0}: dual {float(dres_h[-1]):.3e} primal "
                f"{float(pres_h[-1]):.3e} ({time.time() - tic:.1f}s) "
                f"[{timer.tile_summary()}]")
            tile_span.__exit__(None, None, None)
        log(timer.run_summary())
        if elog is not None:
            elog.emit("run_done", n_tiles=len(traces),
                      phase_totals=dict(timer.totals))
            elog.close()
            unregister_event_log(elog)
    finally:
        # reap every band's reader thread even when a tile raises
        for pf in prefetchers:
            pf.__exit__(None, None, None)
        run_span.__exit__(None, None, None)
        close_tracer()
    # the success path only: a crash keeps the recorder for its dump
    close_flight_recorder()
    return traces
