"""Fullbatch calibration driver: the ``sagecal`` main path (counterpart of
``sagecal_tpu/apps/fullbatch.py``).

Per tile: load -> cluster coherencies (beam-aware with ``-B``:
``solvers/sage.py::build_cluster_data_withbeam`` on the dataset's
``/beam`` geometry) -> SAGE solve -> solutions file -> residuals (with
``per_channel``, ``-b``: each channel re-fit by a joint LBFGS from the
averaged solution, then its residuals; with ``influence``, ``-i``: the
influence eigenvalues of ``ops/diagnostics.py`` in an ``influence``
column instead) -> divergence guard, or with ``simulation_mode`` the
model, added to or subtracted from the data.  The reference runs its host
stages under a CPU default device and ships each solve to the
accelerator; here one device (:func:`run_fullbatch`'s ``device``) holds
everything: coherencies of the averaged and the full-channel views, the
solve, the residuals (the fused predict #1 on float32 data), simulation,
and the gains carried from tile to tile.  The host gets a copy only of
what it writes (the solutions and the residual or model column), of the
one ``res_0``/``res_1`` read per tile that the divergence guard needs,
and, when telemetry or ``abort_on_divergence`` asks for it, of the
quality bundle the watchdog assesses.

The tile reader is :class:`io.dataset.TilePrefetcher`: its thread loads
the next tile as CPU tensors while this one is solved; this thread moves
them to the device, so every CUDA operation runs here in a fixed order.
OS-LM subsets come from a ``torch.Generator`` per tile derived from
``(0, tile_no)`` where the reference folds the tile number into a JAX
key chain.

Elastic execution (``elastic/``): with ``checkpoint_every`` or
``resume`` a ``CheckpointManager`` writes the gains ``p``, the per-tile
``results`` and the generators' seed ``rng_seed`` at tile boundaries
(the reference's fingerprint fields, app name and meta keys; the
reference's ``rng_key`` has no counterpart, since each tile's generator
depends only on the seed and the tile number).  ``resume`` restarts
after the newest checkpoint's last tile, truncating a torn trailing
solution interval, and refuses with ``ResumeRefused`` when the solutions
file and the checkpoint disagree.

As in the reference, a run installs the crash handlers
(``obs/flight.py``: excepthook and SIGTERM flush the event log), starts
the flight recorder when ``SAGECAL_FLIGHT=1`` and writes a ``fullbatch``
run span with one ``tile`` span a tile when ``SAGECAL_TRACE=1``
(``obs/trace.py``; the span JSONL and ``*.trace.json``).  Options that
need a module the port does not have yet raise NotImplementedError
naming their ROADMAP.md item (:func:`_refuse`).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from sagecal_tpu_torch.apps.config import RunConfig
from sagecal_tpu_torch.core.types import (
    identity_jones, jones_to_params, params_to_jones,
)
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.elastic.checkpoint import (
    CheckpointManager, ResumeRefused, config_fingerprint,
)
from sagecal_tpu_torch.io import solutions as solio
from sagecal_tpu_torch.io.dataset import TilePrefetcher, VisDataset
from sagecal_tpu_torch.io.skymodel import load_sky
from sagecal_tpu_torch.obs.events import RunManifest, default_event_log
from sagecal_tpu_torch.obs.flight import (
    close_flight_recorder, get_flight_recorder, install_crash_handlers,
    note_activity, register_event_log, unregister_event_log,
)
from sagecal_tpu_torch.obs.quality import abort_if_diverged, check_and_emit
from sagecal_tpu_torch.obs.records import sage_convergence_records
from sagecal_tpu_torch.obs.registry import get_registry, telemetry_enabled
from sagecal_tpu_torch.obs.trace import (
    close_tracer, configure_tracer, get_tracer,
)
from sagecal_tpu_torch.ops.residual import (
    calculate_residuals, simulate_visibilities,
)
from sagecal_tpu_torch.solvers.batched import derive_lane_generators
from sagecal_tpu_torch.solvers.batchmode import bfgsfit_minibatch
from sagecal_tpu_torch.solvers.robust import whiten_uv_weights
from sagecal_tpu_torch.solvers.sage import (
    SageConfig, build_cluster_data, build_cluster_data_withbeam, solve_tile,
)
from sagecal_tpu_torch.utils.profiling import PhaseTimer

_FALSY = ("", "0", "false", "no", "off")


def _refuse(cfg: RunConfig) -> None:
    """NotImplementedError for every option whose module is not ported,
    naming its ROADMAP.md item."""
    for var in ("SAGECAL_PROFILE_DIR", "SAGECAL_TRANSFER_AUDIT",
                "SAGECAL_CHECKIFY"):
        if os.environ.get(var, "").strip().lower() not in _FALSY:
            raise NotImplementedError(
                f"not ported yet: {var} (obs/ profiling, transfer audit "
                f"and contracts, ROADMAP.md, A11)")


def resume_solutions(path: str, done: int, ckpt_path: str) -> dict:
    """Validate the solutions file of a resumed run against a checkpoint
    of ``done`` completed intervals, truncating a torn or later trailing
    interval (``solio.validate_solutions``); ``ResumeRefused`` when the
    file is missing or holds fewer intact intervals."""
    v = None
    if os.path.exists(path):
        v = solio.validate_solutions(path, truncate=True, max_intervals=done)
    if v is None or v["n_intervals"] < done:
        raise ResumeRefused(
            f"checkpoint {ckpt_path} records {done} completed tiles but "
            f"{path} holds {0 if v is None else v['n_intervals']} intact "
            f"intervals; solution file and checkpoint disagree")
    return v


def _load_ignore_list(path: Optional[str], cdefs) -> list:
    if not path:
        return []
    with open(path) as f:
        ids = {int(tok) for line in f for tok in line.split()
               if not line.strip().startswith("#") and tok.strip()}
    return [i for i, cd in enumerate(cdefs) if cd.cluster_id in ids]


def _resolve_ccid(ccid: Optional[int], cdefs) -> Optional[int]:
    """Reference cluster id (-k) -> cluster array index."""
    if ccid is None:
        return None
    for i, cd in enumerate(cdefs):
        if cd.cluster_id == ccid:
            return i
    return None


# the reference's -B codes -> (ops/beam.py mode, wideband)
_REF_BEAM_MODES = {
    0: (0, False), 1: (1, False), 2: (3, False), 3: (2, False),
    4: (1, True), 5: (3, True), 6: (2, True),
}


def _beam_setup(cfg: RunConfig, ds: VisDataset, dev):
    """``-B``: (geometry, pointing, element coefficients, mode, wideband)
    on ``dev``, or None with beams off.  ``--element-coeffs``: 'lba',
    'hba', 'alo' or a table npz, interpolated to the observing
    frequency, else a single-frequency npz (``ElementCoeffs.load``); no
    table: the synthetic dipole."""
    if not cfg.beam_mode:
        return None
    from sagecal_tpu_torch.ops.beam import (
        DOBEAM_ARRAY, ElementCoeffs, synthetic_dipole_coeffs,
    )

    mode, wideband = _REF_BEAM_MODES[cfg.beam_mode]
    bp = ds.load_beam(device=dev)
    if bp is None:
        raise ValueError(
            f"beam mode {cfg.beam_mode} requested but dataset {cfg.dataset} "
            f"has no /beam group (station geometry)")
    geom, pointing = bp
    coeff = None
    if mode != DOBEAM_ARRAY:
        if cfg.element_coeffs:
            try:
                coeff = ElementCoeffs.from_table(cfg.element_coeffs,
                                                 ds.meta.freq0, device=dev)
            except (KeyError, FileNotFoundError):
                coeff = ElementCoeffs.load(cfg.element_coeffs, device=dev)
        else:
            coeff = synthetic_dipole_coeffs(device=dev)
    return geom, pointing, coeff, mode, wideband


def _mat_of_flat(x: torch.Tensor) -> np.ndarray:
    """Flat (F, 4, rows) -> host (rows, F, 2, 2), the on-disk layout."""
    F, _, rows = x.shape
    return x.permute(2, 0, 1).reshape(rows, F, 2, 2).cpu().numpy()


def _params_of(jones_np, M: int, nchunk_max: int, N: int, cdtype, dev):
    """One solution interval (K, N, 2, 2) -> p (M, nchunk_max, 8N)."""
    j = torch.as_tensor(jones_np).to(cdtype).to(dev)
    return jones_to_params(j).reshape(M, nchunk_max, 8 * N)


def _per_channel_residuals(cfg: RunConfig, full, cdata_full, p,
                           ccid_index) -> np.ndarray:
    """``-b``: each channel re-fit by a joint LBFGS from the averaged
    solution ``p`` (``solvers/batchmode.py::bfgsfit_minibatch``), and its
    residuals with its own solution; host (rows, F, 2, 2)."""
    F = full.vis.shape[0]
    res = np.empty((full.vis.shape[-1], F, 2, 2),
                   np.complex128 if cfg.use_f64 else np.complex64)
    for c in range(F):
        dc = full.replace(vis=full.vis[c:c + 1], mask=full.mask[c:c + 1],
                          freqs=full.freqs[c:c + 1])
        cc = cdata_full.replace(coh=cdata_full.coh[:, c:c + 1])
        p_c, _ = bfgsfit_minibatch(dc, cc, p, itmax=cfg.max_lbfgs,
                                   lbfgs_m=cfg.lbfgs_m)
        res[:, c] = _mat_of_flat(calculate_residuals(
            dc, cc, p_c, ccid_index=ccid_index, rho=cfg.correction_rho,
            phase_only=cfg.phase_only_correction))[:, 0]
    return res


def run_fullbatch(cfg: RunConfig, log=print, device=None,
                  open_file=None) -> list:
    """Calibrate (or simulate) every tile of ``cfg.dataset`` on ``device``
    (CUDA unless ``device="cpu"``).  ``open_file``: the dataset opener
    (``io.dataset``; None: ``h5py.File``).  Returns the per-tile
    (res_0, res_1) list."""
    _refuse(cfg)
    dev = resolve_device(device)
    rdt = torch.float64 if cfg.use_f64 else torch.float32
    cdtype = torch.complex128 if cfg.use_f64 else torch.complex64
    ds = VisDataset(cfg.dataset, "r+", open_file)
    meta = ds.meta
    clusters, cdefs, shapelets = load_sky(
        cfg.sky_model, cfg.cluster_file, meta.ra0, meta.dec0, dtype=rdt,
        three_term_spectra=None if cfg.sky_format < 0 else bool(cfg.sky_format),
        device=dev)
    M = len(clusters)
    nchunks = [cd.nchunk for cd in cdefs]
    nchunk_max = max(nchunks)
    N = meta.nstations
    ignore_idx = _load_ignore_list(cfg.ignore_clusters_file, cdefs)
    ccid_index = _resolve_ccid(cfg.ccid, cdefs)
    beam = _beam_setup(cfg, ds, dev)

    # initial solutions: identity, or the warm start (-q); simulation
    # advances through the file's intervals tile by tile
    jones_intervals = None
    if cfg.init_solutions:
        _, jones_intervals = solio.read_solutions(cfg.init_solutions)
        p = _params_of(jones_intervals[0], M, nchunk_max, N, cdtype, dev)
    else:
        eye = jones_to_params(identity_jones(N, cdtype, device=dev))
        p = eye.expand(M, nchunk_max, 8 * N).clone()
    pinit = p

    fused = cfg.use_fused_predict and not cfg.use_f64
    scfg = SageConfig(
        max_emiter=cfg.max_emiter, max_iter=cfg.max_iter,
        max_lbfgs=cfg.max_lbfgs, lbfgs_m=cfg.lbfgs_m,
        solver_mode=cfg.solver_mode, nulow=cfg.nulow, nuhigh=cfg.nuhigh,
        randomize=cfg.randomize, use_fused_predict=fused,
        coh_dtype=cfg.coh_dtype if fused else "f32",
        collect_telemetry=telemetry_enabled(),
        # quality feeds the watchdog: on when telemetry records it or the
        # run must be able to abort
        collect_quality=telemetry_enabled() or cfg.abort_on_divergence,
    )
    manifest = RunManifest.collect(
        kernel_path="fused" if fused else "torch", device=dev,
        x64_enabled=cfg.use_f64, app="fullbatch", dataset=cfg.dataset,
        solver_mode=cfg.solver_mode, tilesz=cfg.tilesz, n_clusters=M,
        n_stations=N, simulation_mode=cfg.simulation_mode,
        coh_dtype=scfg.coh_dtype)
    elog = default_event_log(manifest=manifest)
    # crash forensics and tracing: the excepthook and SIGTERM flush the
    # event log, the flight recorder heartbeats, spans join the event
    # log on the manifest's run_id
    install_crash_handlers()
    if elog is not None:
        register_event_log(elog)
    get_flight_recorder(run_id=manifest.run_id)
    configure_tracer(run_id=manifest.run_id)
    tracer = get_tracer()

    # elastic execution: checkpoints at tile boundaries, resume from the
    # newest valid one
    ckmgr = None
    resume_done = 0  # tiles completed (and intervals on disk) at resume
    results = []
    if cfg.simulation_mode == 0 and (cfg.resume or cfg.checkpoint_every > 0):
        ckmgr = CheckpointManager(
            cfg.checkpoint_dir or f"{cfg.out_solutions}.ckpt",
            config_fingerprint(
                app="fullbatch", dataset=os.path.abspath(cfg.dataset),
                sky_model=os.path.abspath(cfg.sky_model),
                cluster_file=os.path.abspath(cfg.cluster_file),
                nstations=N, ntime=meta.ntime, nchan=meta.nchan,
                freq0=meta.freq0, n_clusters=M, nchunk_max=nchunk_max,
                tilesz=cfg.tilesz, solver_mode=cfg.solver_mode,
                max_emiter=cfg.max_emiter, max_iter=cfg.max_iter,
                max_lbfgs=cfg.max_lbfgs, lbfgs_m=cfg.lbfgs_m,
                nulow=cfg.nulow, nuhigh=cfg.nuhigh, randomize=cfg.randomize,
                use_f64=cfg.use_f64, whiten=cfg.whiten,
                in_column=cfg.in_column, skip_tiles=cfg.skip_tiles,
                max_tiles=cfg.max_tiles, init_solutions=cfg.init_solutions),
            "fullbatch", every=max(cfg.checkpoint_every, 1), elog=elog,
            log=log)
        found = ckmgr.resume() if cfg.resume else None
        if found is not None:
            rmeta, rarr, rpath = found
            resume_done = int(rmeta["tiles_done"])
            p = torch.as_tensor(rarr["p"]).to(dtype=rdt, device=dev)
            results = [tuple(map(float, r))
                       for r in rarr.get("results", np.zeros((0, 2)))]
            v = resume_solutions(cfg.out_solutions, resume_done, rpath)
            log(f"resume: {resume_done} tiles from {rpath}"
                + (" (torn interval truncated)" if v["truncated"] else ""))

    sol_fh = None
    if cfg.simulation_mode == 0:
        if resume_done:
            # validated (a torn interval truncated) above: append
            sol_fh = open(cfg.out_solutions, "a")
        else:
            sol_fh = open(cfg.out_solutions, "w")
            solio.write_header(sol_fh, meta.freq0, meta.deltaf,
                               meta.deltat * cfg.tilesz / 60.0, N, M,
                               M * nchunk_max)

    def _cdata(dat, t0, fdelta=None):
        if beam is None:
            return build_cluster_data(dat, clusters, nchunks, fdelta=fdelta,
                                      shapelets=shapelets)
        geom, pointing, coeff, mode, wideband = beam
        # the lunar ALO element: no terrestrial J2000 precession
        is_alo = (cfg.element_coeffs or "").lower() == "alo"
        return build_cluster_data_withbeam(
            dat, clusters, nchunks, geom, pointing, coeff, mode,
            ds.time_jd(t0, dat.tilesz), meta.ra0, meta.dec0, fdelta=fdelta,
            wideband=wideband, shapelets=shapelets, precess=not is_alo)

    timer = PhaseTimer()
    # -K/-T partial reruns, resolved up front so the prefetcher reads
    # exactly the tiles the loop consumes
    pairs = [(i, t0) for i, t0 in enumerate(ds.tiles(cfg.tilesz))
             if i >= cfg.skip_tiles]
    if cfg.max_tiles:
        pairs = pairs[:cfg.max_tiles]
    pairs = pairs[resume_done:]
    load_kw = dict(min_uvcut=cfg.min_uvcut, max_uvcut=cfg.max_uvcut,
                   dtype=np.float64 if cfg.use_f64 else np.float32,
                   column=cfg.in_column)
    specs = [dict(average_channels=False, **load_kw)]
    if not cfg.simulation_mode:
        specs.append(dict(average_channels=True, **load_kw))
    prefetch_cm = TilePrefetcher(cfg.dataset, [t0 for _, t0 in pairs], specs,
                                 cfg.tilesz, depth=1, open_file=open_file)
    # the run's root span, entered by hand: the finally below exits it
    run_span = tracer.span("fullbatch", kind="run", tiles=len(pairs))
    run_span.__enter__()
    try:
        prefetch = iter(prefetch_cm.__enter__())

        def _prepare(t0):
            """The next tile on the device with its coherencies."""
            t0_chk, tiles = next(prefetch)
            if t0_chk != t0:
                raise RuntimeError(f"prefetch order mismatch: got tile "
                                   f"{t0_chk}, expected {t0}")
            full_ = tiles[0].to(dev)
            data_ = None if cfg.simulation_mode else tiles[1].to(dev)
            cdata_full_ = _cdata(full_, t0, meta.deltaf / max(meta.nchan, 1))
            cdata_ = None if cfg.simulation_mode else _cdata(data_, t0)
            return full_, data_, cdata_full_, cdata_

        def _ckpt_update(pi):
            """End-of-tile checkpoint: the tile's solution interval and
            residuals are written, so (p, results) here is a complete
            resume point."""
            if ckmgr is not None:
                ckmgr.update(
                    resume_done + pi,
                    {"p": p, "rng_seed": np.zeros(1, np.int64),
                     "results": np.asarray(results,
                                           np.float64).reshape(-1, 2)},
                    tiles_done=resume_done + pi + 1,
                    run_id=manifest.run_id)

        prepared = None
        if pairs:
            with timer.phase("load+coh"):
                prepared = _prepare(pairs[0][1])
        for pi, (tile_no, t0) in enumerate(pairs):
            tic = time.time()
            tile_span = tracer.span("tile", kind="tile", tile=t0)
            tile_span.__enter__()
            full, data, cdata_full, cdata = prepared

            if cfg.simulation_mode:
                # the model of the tile's own solution interval
                psim = None
                if jones_intervals is not None:
                    ti = min(tile_no, jones_intervals.shape[0] - 1)
                    psim = _params_of(jones_intervals[ti], M, nchunk_max, N,
                                      cdtype, dev)
                out_vis = simulate_visibilities(
                    full, cdata_full, psim, mode=cfg.simulation_mode,
                    ignore_clusters=ignore_idx, ccid_index=ccid_index,
                    rho=cfg.correction_rho,
                    phase_only=cfg.phase_only_correction)
                if pi + 1 < len(pairs):
                    with timer.phase("load+coh"):
                        prepared = _prepare(pairs[pi + 1][1])
                ds.write_tile(t0, _mat_of_flat(out_vis), column="model")
                if elog is not None:
                    elog.emit("tile_simulated", tile=t0,
                              seconds=time.time() - tic,
                              phase_seconds=timer.tile_timings())
                log(f"tile {t0}: simulated ({time.time() - tic:.1f}s)")
                tile_span.__exit__(None, None, None)
                continue

            if cfg.whiten:
                wts = torch.sqrt(whiten_uv_weights(data.u, data.v,
                                                   meta.freq0))
                data = data.replace(vis=data.vis * wts[None, None, :],
                                    mask=data.mask * (wts[None, :] > 0))
            with timer.phase("solve"):
                out = solve_tile(data, cdata, p, scfg,
                                 derive_lane_generators(0, [tile_no])[0],
                                 device=dev)
            if pi + 1 < len(pairs):
                with timer.phase("load+coh"):
                    prepared = _prepare(pairs[pi + 1][1])
            with timer.phase("solve-wait"):  # one read: res_0, res_1, nu
                res0, res1, mean_nu = torch.stack(
                    [out.res_0, out.res_1,
                     out.mean_nu.to(out.res_0.dtype)]).tolist()
            # divergence guard: reset to the initial gains
            diverged = (not np.isfinite(res1) or res1 == 0.0
                        or res1 > cfg.res_ratio * res0)
            p = pinit if diverged else out.p
            if diverged:
                log(f"tile {t0}: diverged ({res0:.3e} -> {res1:.3e}), reset")

            # quality watchdog, joined by the residual-ratio guard
            q_verdict, q_reasons = "ok", []
            if out.quality is not None:
                q_verdict, q_reasons = check_and_emit(
                    elog, out.quality, log=log, tile=t0, app="fullbatch",
                    coh_dtype=scfg.coh_dtype)
            if diverged:
                why = f"residual_ratio:{res0:.3e}->{res1:.3e}"
                if q_verdict != "diverged" and elog is not None:
                    elog.emit("solver_diverged", reasons=[why], tile=t0,
                              app="fullbatch")
                q_verdict, q_reasons = "diverged", q_reasons + [why]
            if cfg.abort_on_divergence:
                abort_if_diverged(elog, q_verdict, q_reasons, tile=t0,
                                  app="fullbatch")

            jsol = params_to_jones(p).reshape(M * nchunk_max, N, 2, 2)
            solio.append_solutions(sol_fh, jsol.cpu().numpy())

            if cfg.influence:
                # the influence eigenvalues replace the residuals
                from sagecal_tpu_torch.ops.diagnostics import (
                    influence_function,
                )

                infl = influence_function(full, cdata_full, p)  # host
                ds.write_tile(t0, np.moveaxis(infl, -1, 0).reshape(
                    infl.shape[-1], infl.shape[0], 2, 2), column="influence")
                log(f"tile {t0}: influence diagnostics written "
                    f"({time.time() - tic:.1f}s)")
                results.append((res0, res1))
                _ckpt_update(pi)
                tile_span.__exit__(None, None, None)
                continue

            if cfg.per_channel and meta.nchan > 1:
                res = _per_channel_residuals(cfg, full, cdata_full, p,
                                             ccid_index)
            else:
                with timer.phase("residual"):
                    res = _mat_of_flat(calculate_residuals(
                        full, cdata_full, p, ccid_index=ccid_index,
                        rho=cfg.correction_rho,
                        phase_only=cfg.phase_only_correction))
            with timer.phase("write"):
                ds.write_tile(t0, res, column=cfg.out_column)
            # gains carry tile to tile, so iterations-to-converge per
            # tile is the warm start's measured win
            warm_start = bool(pi > 0 or resume_done > 0
                              or cfg.init_solutions)
            iters_tile = None
            conv_recs = sage_convergence_records(out.telemetry)
            if conv_recs:
                iters_tile = int(sum(int(r.get("iterations", 0))
                                     for r in conv_recs))
                get_registry().gauge_set(
                    "tile_iterations_to_converge", iters_tile,
                    help="summed solver iterations of this tile's solve "
                         "(warm starts shrink it)", tile=str(t0),
                    warm_start=str(int(warm_start)))
            if elog is not None:
                for rec in conv_recs:
                    elog.emit("cluster_convergence", tile=t0, **rec)
                elog.emit("tile_done", tile=t0, res0=res0, res1=res1,
                          mean_nu=mean_nu, diverged=bool(diverged),
                          seconds=time.time() - tic, warm_start=warm_start,
                          iterations=iters_tile,
                          phase_seconds=timer.tile_timings())
            log(f"tile {t0}: residual {res0:.6f} -> {res1:.6f} "
                f"nu {mean_nu:.1f} ({time.time() - tic:.1f}s) "
                f"[{timer.tile_summary()}]")
            results.append((res0, res1))
            _ckpt_update(pi)
            note_activity("tile", name=f"tile{t0}", seconds=time.time() - tic)
            tile_span.__exit__(None, None, None)
    finally:
        # reap the reader thread and its handle even when a tile raises;
        # a crashed run still writes a loadable trace
        prefetch_cm.__exit__(None, None, None)
        run_span.__exit__(None, None, None)
        close_tracer()  # writes the Chrome trace beside the span JSONL
    log(timer.run_summary())
    if elog is not None:
        elog.emit("run_done", n_tiles=len(results),
                  phase_totals=dict(timer.totals))
        elog.close()
        unregister_event_log(elog)
    if sol_fh:
        sol_fh.close()
    if ckmgr is not None:
        ckmgr.close()
    ds.close()
    # the success path only: the final "closed" heartbeat; a crash keeps
    # the recorder for the excepthook's dump
    close_flight_recorder()
    return results
