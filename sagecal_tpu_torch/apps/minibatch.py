"""Stochastic minibatch calibration (the bandpass mode, ``-N``) with the
in-process band-consensus ADMM (counterpart of
``sagecal_tpu/apps/minibatch.py``).

The channels split into ``bands`` mini-bands, each with its own
solution; ``epochs`` x ``minibatches`` passes over time run one joint
LBFGS a band (``solvers/batchmode.py``), the curvature memory persisting
across minibatches (``run_minibatch_calibration``,
minibatch_mode.cpp:47).  In consensus mode (``-A > 0`` with ``-w > 1``)
the bands couple through the frequency polynomials by ADMM inside each
minibatch (``run_minibatch_consensus_calibration``,
minibatch_consensus_mode.cpp:359-363, 455-606); with
``--consensus-staleness`` the bands refresh on the deterministic periods
of ``parallel/async_consensus.py``.  At the end every band's residuals
are written back minibatch by minibatch (kernel #1 on float32 data,
``ops/residual.py``) and the per-band solutions to one file.

Everything runs on ``device`` (CUDA unless ``device="cpu"``); the host
reads each minibatch's unflagged-row counts once, each round's residual
norms when they are logged, and the residual sums at the end.  Spans
(``minibatch`` run, ``batch``, ``admm.round`` and real-time
``admm.band``), the ``admm_round``, ``consensus_health``,
``minibatch_done`` and ``band_residual`` events, the straggler gauges,
the watchdog and the flight recorder follow the JAX package.
``resume`` / ``checkpoint_every`` need ROADMAP.md's A9.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sagecal_tpu_torch.apps.config import RunConfig
from sagecal_tpu_torch.apps.fullbatch import _mat_of_flat, _refuse
from sagecal_tpu_torch.core.types import (
    identity_jones, jones_to_params, params_to_jones,
)
from sagecal_tpu_torch.device import resolve_device, synchronize
from sagecal_tpu_torch.io import solutions as solio
from sagecal_tpu_torch.io.dataset import VisDataset
from sagecal_tpu_torch.io.skymodel import load_sky, read_cluster_rho
from sagecal_tpu_torch.obs.events import RunManifest, default_event_log
from sagecal_tpu_torch.obs.flight import (
    close_flight_recorder, get_flight_recorder, install_crash_handlers,
    note_activity, register_event_log, unregister_event_log,
)
from sagecal_tpu_torch.obs.quality import abort_if_diverged, assess_consensus
from sagecal_tpu_torch.obs.registry import get_registry
from sagecal_tpu_torch.obs.trace import (
    close_tracer, configure_tracer, get_tracer, straggler_stats,
)
from sagecal_tpu_torch.ops.residual import calculate_residuals
from sagecal_tpu_torch.parallel import consensus
from sagecal_tpu_torch.parallel.async_consensus import (
    StalenessLedger, band_active, refresh_periods,
)
from sagecal_tpu_torch.solvers.batchmode import (
    bfgsfit_minibatch, bfgsfit_minibatch_consensus,
)
from sagecal_tpu_torch.solvers.sage import _ROBUST_MODES, build_cluster_data


def _band_slices(nchan: int, bands: int):
    """Channel ranges per mini-band (minibatch_mode.cpp:355: near-equal
    splits)."""
    edges = np.linspace(0, nchan, bands + 1).astype(int)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(bands)]


def _band_visdata(full, c0, c1):
    """Channels [c0, c1) of a multichannel tile (channel axis leading)."""
    return full.replace(vis=full.vis[c0:c1], mask=full.mask[c0:c1],
                        freqs=full.freqs[c0:c1])


def run_minibatch(cfg: RunConfig, log=print, device=None, open_file=None):
    """Epochs x minibatches over time, one solution per mini-band, on
    ``device`` (CUDA unless ``device="cpu"``); ``open_file``: the dataset
    opener (None: ``h5py.File``).  Returns the per-band final (res_0,
    res_1): the norms of the data and of the residual."""
    _refuse(cfg)
    dev = resolve_device(device)
    rdt = torch.float64 if cfg.use_f64 else torch.float32
    cdtype = torch.complex128 if cfg.use_f64 else torch.complex64
    ds = VisDataset(cfg.dataset, "r+", open_file)
    try:
        return _run(cfg, log, dev, rdt, cdtype, ds)
    finally:
        ds.close()


def _run(cfg, log, dev, rdt, cdtype, ds):
    meta = ds.meta
    clusters, cdefs, shapelets = load_sky(
        cfg.sky_model, cfg.cluster_file, meta.ra0, meta.dec0, dtype=rdt,
        three_term_spectra=None if cfg.sky_format < 0 else bool(cfg.sky_format),
        device=dev)
    M = len(clusters)
    nchunks = [cd.nchunk for cd in cdefs]
    nchunk_max = max(nchunks)
    N = meta.nstations
    n8 = 8 * N
    bands = _band_slices(meta.nchan, cfg.bands)
    nbands = len(bands)
    consensus_mode = cfg.admm_iters > 0 and cfg.bands > 1
    K_stale = max(int(cfg.consensus_staleness), 0)
    sdisc = float(cfg.consensus_staleness_discount)
    async_mode = consensus_mode and (K_stale > 0 or sdisc != 1.0)

    eye = jones_to_params(identity_jones(N, cdtype, device=dev))
    p_bands = [eye.expand(M, nchunk_max, n8).clone() for _ in bands]
    mem_bands = [None] * nbands

    if consensus_mode:
        # consensus over the band centre frequencies
        # (minibatch_consensus_mode.cpp:359-363)
        bfreqs = np.asarray([np.mean(meta.freqs[c0:c1]) for c0, c1 in bands])
        B = consensus.setup_polynomials(bfreqs, meta.freq0, cfg.npoly,
                                        cfg.poly_type).to(dev, rdt)
        if cfg.rho_file:
            rho_m, _ = read_cluster_rho(cfg.rho_file, cdefs)
            rho = torch.as_tensor(rho_m, dtype=rdt).to(dev).expand(
                nbands, M)
        else:
            rho = torch.full((nbands, M), cfg.admm_rho, dtype=rdt,
                             device=dev)
        Bii = consensus.find_prod_inverse_full(B, rho)
        K = nchunk_max * n8
        Z = torch.zeros((M, cfg.npoly, K), dtype=rdt, device=dev)
        Y_bands = [torch.zeros_like(p_bands[0]) for _ in bands]
        # per-band stored Gram terms, ages and the round counter, one
        # deterministic sequence across minibatches
        ledger = StalenessLedger(nbands, (M, cfg.npoly, K),
                                 np.float64 if cfg.use_f64 else np.float32)

    ntime = meta.ntime
    nb = max(cfg.minibatches, 1)
    tedges = np.linspace(0, ntime, nb + 1).astype(int)
    robust_nu = (0.5 * (cfg.nulow + cfg.nuhigh)
                 if cfg.solver_mode in _ROBUST_MODES else None)
    fd = meta.deltaf / max(meta.nchan, 1)

    manifest = RunManifest.collect(
        device=dev, x64_enabled=cfg.use_f64, app="minibatch", bands=nbands,
        epochs=cfg.epochs, minibatches=nb, consensus=consensus_mode,
        solver_mode=cfg.solver_mode, n_clusters=M, n_stations=N)
    elog = default_event_log(manifest=manifest)
    install_crash_handlers()
    if elog is not None:
        register_event_log(elog)
    get_flight_recorder(run_id=manifest.run_id)
    configure_tracer(run_id=manifest.run_id)
    tracer = get_tracer()

    def cdata_of(db):
        return build_cluster_data(db, clusters, nchunks, fdelta=fd,
                                  shapelets=shapelets)

    def target(Z_, bi):
        return consensus.bz_for_freq(Z_, B[bi]).reshape(M, nchunk_max, n8)

    run_span = tracer.span("minibatch", kind="run", bands=nbands,
                           epochs=max(cfg.epochs, 1), minibatches=nb,
                           consensus=consensus_mode)
    run_span.__enter__()
    try:
        for epoch in range(max(cfg.epochs, 1)):
            for mb in range(nb):
                t0, t1 = int(tedges[mb]), int(tedges[mb + 1])
                if t1 <= t0:
                    continue
                tic = time.time()
                mb_span = tracer.span("batch", kind="batch", epoch=epoch,
                                      minibatch=mb)
                mb_span.__enter__()
                full = ds.load_tile(t0, t1 - t0, average_channels=False,
                                    min_uvcut=cfg.min_uvcut,
                                    max_uvcut=cfg.max_uvcut,
                                    dtype=np.float64 if cfg.use_f64
                                    else np.float32,
                                    column=cfg.in_column, device=dev)
                dbs = [_band_visdata(full, c0, c1) for c0, c1 in bands]
                cbs = [cdata_of(db) for db in dbs]
                if not consensus_mode:
                    for bi in range(nbands):
                        p_bands[bi], mem_bands[bi] = bfgsfit_minibatch(
                            dbs[bi], cbs[bi], p_bands[bi],
                            memory=mem_bands[bi], itmax=cfg.max_lbfgs,
                            lbfgs_m=cfg.lbfgs_m, robust_nu=robust_nu)
                else:
                    Z = _consensus_rounds(
                        cfg, log, dev, elog, tracer, epoch, mb, dbs, cbs,
                        p_bands, mem_bands, Y_bands, Z, B, Bii, rho, ledger,
                        K_stale, sdisc, async_mode, robust_nu, target)
                note_activity("minibatch", name=f"e{epoch}mb{mb}",
                              seconds=time.time() - tic)
                mb_span.__exit__(None, None, None)
                if elog is not None:
                    elog.emit("minibatch_done", epoch=epoch, minibatch=mb,
                              t0=t0, t1=t1, seconds=time.time() - tic)
                log(f"epoch {epoch} minibatch {mb}: "
                    f"({time.time() - tic:.1f}s)")

        # every band's residuals, minibatch by minibatch with the
        # training loop's time edges
        acc = torch.zeros((nbands, 2), dtype=torch.float64, device=dev)
        for mb in range(nb):
            t0, t1 = int(tedges[mb]), int(tedges[mb + 1])
            if t1 <= t0:
                continue
            full = ds.load_tile(t0, t1 - t0, average_channels=False,
                                dtype=np.float64 if cfg.use_f64
                                else np.float32,
                                column=cfg.in_column, device=dev)
            res_all = full.vis.clone()
            for bi, (c0, c1) in enumerate(bands):
                db = _band_visdata(full, c0, c1)
                res = calculate_residuals(db, cdata_of(db), p_bands[bi])
                res_all[c0:c1] = res
                acc[bi, 0] += (db.vis.abs() ** 2).sum().double()
                acc[bi, 1] += (res.abs() ** 2).sum().double()
            ds.write_tile(t0, _mat_of_flat(res_all), column=cfg.out_column)
        results = [tuple(r) for r in torch.sqrt(acc).tolist()]
        for bi, (r0, r1) in enumerate(results):
            if elog is not None:
                elog.emit("band_residual", band=bi, res0=r0, res1=r1)
            log(f"band {bi}: residual {r0:.4f} -> {r1:.4f}")
        if elog is not None:
            elog.emit("run_done", n_bands=nbands)
            elog.close()
            unregister_event_log(elog)
    finally:
        run_span.__exit__(None, None, None)
        close_tracer()

    with open(cfg.out_solutions, "w") as fh:
        solio.write_header(fh, meta.freq0, meta.deltaf, meta.deltat / 60.0,
                           N, M, M * nchunk_max)
        for pb in p_bands:
            jsol = params_to_jones(pb).reshape(M * nchunk_max, N, 2, 2)
            solio.append_solutions(fh, jsol.cpu().numpy())
    # the success path only: a crash keeps the recorder for its dump
    close_flight_recorder()
    return results


def _consensus_rounds(cfg, log, dev, elog, tracer, epoch, mb, dbs, cbs,
                      p_bands, mem_bands, Y_bands, Z, B, Bii, rho, ledger,
                      K_stale, sdisc, async_mode, robust_nu, target):
    """The band ADMM of one minibatch (minibatch_consensus_mode.cpp:
    455-606), updating ``p_bands``, ``mem_bands``, ``Y_bands`` and the
    ledger in place.  Returns the new Z."""
    nbands = len(dbs)
    M = Z.shape[0]
    track = cfg.verbose or elog is not None or cfg.abort_on_divergence
    pres_traj, dual_traj = [], []
    # the band x-steps run one after another on the host's clock, so
    # band spans are real wall times (blocking a band only when tracing)
    band_secs = [0.0] * nbands
    # refresh periods from this minibatch's unflagged rows; staleness 0
    # gives all ones, the synchronous loop
    band_rows = torch.stack([db.mask.sum().double() for db in dbs]).tolist()
    periods = refresh_periods(band_rows, K_stale)
    if async_mode and elog is not None:
        elog.emit("async_schedule", epoch=epoch, minibatch=mb,
                  staleness=K_stale, discount=sdisc,
                  periods=[int(x) for x in periods], band_rows=band_rows,
                  round_index=ledger.round_index)
    zdt = Z.dtype
    for admm in range(cfg.admm_iters):
        Z_old = Z
        # a band with no stored term yet must solve (starvation-free)
        active = (band_active(ledger.round_index, periods)
                  | (ledger.ages < 0))
        round_span = tracer.span("admm.round", kind="admm_round",
                                 round=admm, epoch=epoch, minibatch=mb)
        round_span.__enter__()
        for bi in range(nbands):
            if not active[bi]:
                continue
            t_band = time.perf_counter()
            with tracer.span("admm.band", kind="band", band=bi,
                             lane=f"band{bi}", round=admm):
                p1, mem1 = bfgsfit_minibatch_consensus(
                    dbs[bi], cbs[bi], p_bands[bi], Y_bands[bi],
                    target(Z, bi), rho[bi], memory=mem_bands[bi],
                    itmax=cfg.max_lbfgs, lbfgs_m=cfg.lbfgs_m,
                    robust_nu=robust_nu)
                if tracer.enabled:
                    synchronize(dev)
            if tracer.enabled:
                band_secs[bi] += time.perf_counter() - t_band
            p_bands[bi], mem_bands[bi] = p1, mem1
            Yhat = Y_bands[bi] + rho[bi][:, None, None] * p1
            ledger.record(bi, consensus.accumulate_z_term(
                B[bi], Yhat.reshape(M, -1)))
        # Z over every band's freshest stored term, rho-discounted by
        # age; all-fresh weights are exactly 1 and reuse Bii
        ages_eff = np.where(active, 0, ledger.ages)
        w_z = np.where(ages_eff < 0, 0.0, sdisc ** np.maximum(ages_eff, 0))
        if K_stale > 0:
            w_z = np.where(ages_eff > K_stale, 0.0, w_z)
        if not np.any(w_z > 0):
            w_z = np.ones_like(w_z)
        zacc = torch.zeros_like(Z)
        for bi in range(nbands):
            if w_z[bi] == 0.0:
                continue
            term = torch.as_tensor(ledger.zterms[bi], dtype=zdt).to(dev)
            if w_z[bi] != 1.0:
                term = float(w_z[bi]) * term
            zacc = zacc + term
        if np.all(w_z == 1.0):
            Bii_r = Bii
        else:
            Bii_r = consensus.find_prod_inverse_full(
                B, torch.as_tensor(w_z, dtype=zdt).to(dev)[:, None] * rho)
        Z = consensus.update_global_z(zacc, Bii_r)
        for bi in range(nbands):
            if not active[bi]:
                # an idle band keeps its dual: it did not re-solve
                # against this round's Z
                continue
            Y_bands[bi] = (Y_bands[bi] + rho[bi][:, None, None]
                           * (p_bands[bi] - target(Z, bi)))
        ledger.advance()
        round_span.__exit__(None, None, None)
        if track:
            # per-band scaled primal residuals and the dual residual,
            # one host read a round
            vals = torch.stack(
                [consensus.admm_primal_residual(
                    p_bands[bi].reshape(-1), target(Z, bi).reshape(-1))
                 for bi in range(nbands)]
                + [consensus.admm_dual_residual(Z, Z_old)]).tolist()
            pres_band, dres = vals[:-1], vals[-1]
            pres_traj.append(pres_band)
            dual_traj.append(dres)
            if elog is not None:
                elog.emit("admm_round", epoch=epoch, minibatch=mb,
                          admm_iter=admm, primal_res=pres_band,
                          dual_res=dres)
            if cfg.verbose:
                log(f"  admm {admm}: primal {sum(pres_band):.4e} "
                    f"dual {dres:.4e}")
    if tracer.enabled and nbands > 1:
        # straggler gauges on the measured per-band seconds
        stats = straggler_stats(band_secs)
        reg = get_registry()
        for bi, s in enumerate(band_secs):
            reg.gauge_set("admm_band_seconds", s,
                          help="measured per-band seconds of this "
                               "minibatch's band ADMM", band=str(bi))
        reg.gauge_set("admm_straggler_ratio", stats["ratio"],
                      help="slowest/median measured band seconds of the "
                           "band ADMM")
        reg.gauge_set("admm_band_skew", stats["skew"],
                      help="(max-mean)/mean measured band seconds")
        if stats["detected"]:
            if elog is not None:
                elog.emit("straggler_detected", epoch=epoch, minibatch=mb,
                          band=stats["argmax"], ratio=stats["ratio"],
                          skew=stats["skew"], band_seconds=band_secs,
                          threshold=stats["threshold"])
            log(f"epoch {epoch} minibatch {mb}: straggler band "
                f"{stats['argmax']} ({stats['ratio']:.2f}x median)")
    if pres_traj:
        # ADMM watchdog on this minibatch's trajectories
        pr = np.asarray(pres_traj)
        du = np.tile(np.asarray(dual_traj)[:, None], (1, pr.shape[1]))
        verdict, reasons, health = assess_consensus(
            pr, du, ages=np.maximum(ledger.ages, 0) if async_mode else None,
            staleness=K_stale if async_mode else None)
        if elog is not None:
            elog.emit("consensus_health", epoch=epoch, minibatch=mb,
                      verdict=verdict, reasons=reasons,
                      ratio=health["ratio"], trend=health["trend"])
            if verdict == "diverged":
                elog.emit("solver_diverged", reasons=reasons, epoch=epoch,
                          minibatch=mb, app="minibatch")
        if verdict != "ok":
            log(f"consensus watchdog: {verdict} ({', '.join(reasons)})")
        if cfg.abort_on_divergence:
            abort_if_diverged(elog, verdict, reasons, epoch=epoch,
                              minibatch=mb, app="minibatch")
    return Z
