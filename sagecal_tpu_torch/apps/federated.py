"""Federated stochastic calibration, the ``sagecal-mpi -N`` mode
(counterpart of ``sagecal_tpu/apps/federated.py``; the stochastic MPI
pair ``sagecal_stochastic_master.cpp`` / ``sagecal_stochastic_slave.cpp``).

Per solution tile, ``nadmm`` federated rounds, each of ``epochs`` x
``minibatches`` consensus minibatch-LBFGS passes over the tile's
timeslots with persistent curvature memory per band (slave:637-638,
671-855), a per-band local z-step tied to the federated average by
alpha, and the manifold-averaging round trip after each epoch block
(master:347, slave:856-868): ``parallel/federated.py`` on one virtual
shard a band (the JAX package needs a device a band).

Reset protocol (CTRL_RESET, slave:1044-1066 / stochastic_master.cpp:360):
after each round, a band whose data cost is not finite or grew past
``reset_ratio`` times its tile-start cost resets its solutions, duals and
LBFGS memory and rejoins from the identity; when most bands reset in one
round the app logs the master's "most did not converge" warning.
``--consensus-staleness K`` averages every K+1 rounds (and always on the
last).

Everything runs on ``device`` (CUDA unless ``device="cpu"``) with the
torch-op solvers: the JAX package's federated app writes no residual,
so this app launches none of the CUDA kernels.  The host reads each
minibatch round's dual residual and each round's per-band costs.  It
emits the ``async_schedule``, ``fed_round``, ``band_reset``,
``tile_done`` and ``run_done`` events, a ``federated`` run span, ``tile``
and ``fed.round`` spans, and keeps the flight recorder.

Elastic execution (``elastic/``), as in the reference: the whole
``FederatedState`` is the cross-tile carry, so checkpoints at tile
boundaries hold its leaves (``state.<i>``, the band memories stacked
into one ``LBFGSMemory`` so that the names and shapes are the
reference's) and the per-tile results; ``resume`` restarts after the
newest one, truncating every band file to it.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from sagecal_tpu_torch.apps.config import RunConfig
from sagecal_tpu_torch.apps.fullbatch import _refuse
from sagecal_tpu_torch.core.types import (
    complex_dtype_of, identity_jones, jones_to_params, params_to_jones,
)
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.elastic.checkpoint import (
    CheckpointManager, ResumeRefused, config_fingerprint, flatten_state,
    unflatten_state,
)
from sagecal_tpu_torch.io import solutions as solio
from sagecal_tpu_torch.io.dataset import VisDataset
from sagecal_tpu_torch.io.skymodel import load_sky
from sagecal_tpu_torch.obs.events import RunManifest, default_event_log
from sagecal_tpu_torch.obs.flight import (
    close_flight_recorder, get_flight_recorder, install_crash_handlers,
    note_activity, register_event_log, unregister_event_log,
)
from sagecal_tpu_torch.obs.trace import (
    close_tracer, configure_tracer, get_tracer,
)
from sagecal_tpu_torch.parallel import consensus
from sagecal_tpu_torch.parallel.federated import (
    FederatedState, init_federated_state, make_fed_avg_fn,
    make_federated_minibatch_fn,
)
from sagecal_tpu_torch.parallel.mesh import stack_for_mesh
from sagecal_tpu_torch.solvers.lbfgs import LBFGSMemory
from sagecal_tpu_torch.solvers.sage import build_cluster_data


def _reset_band(state: FederatedState, band: int, p_init) -> FederatedState:
    """CTRL_RESET for one band: its p from ``p_init``, zero Y/Z/Zbar/X
    and an empty LBFGS memory (slave:1044-1060, lbfgs_persist_reset)."""
    def zero_band(x):
        x = x.clone()
        x[band] = 0.0
        return x

    p = state.p.clone()
    p[band] = p_init
    m = state.mem[band]
    mem = list(state.mem)
    mem[band] = LBFGSMemory.init(m.s.shape[1], m.s.shape[0], m.s.dtype,
                                 m.s.device)
    return FederatedState(p=p, Y=zero_band(state.Y), Z=zero_band(state.Z),
                          Zbar=zero_band(state.Zbar), X=zero_band(state.X),
                          mem=mem)


def _stacked(state: FederatedState) -> FederatedState:
    """``state`` with its band memories stacked into one ``LBFGSMemory``
    with (Nf,)-leading leaves: the reference's layout, so its checkpoint
    leaves have the reference's names and shapes."""
    def field(name):
        vals = [getattr(m, name) for m in state.mem]
        if isinstance(vals[0], torch.Tensor):
            return torch.stack(vals)
        return torch.as_tensor(vals, dtype=torch.int32)

    return state._replace(mem=LBFGSMemory(**{
        f.name: field(f.name) for f in dataclasses.fields(LBFGSMemory)}))


def _unstacked(state: FederatedState, like: FederatedState) -> FederatedState:
    """Inverse of :func:`_stacked`, with ``like``'s per-band types."""
    mems = []
    for b, m in enumerate(like.mem):
        kw = {}
        for f in dataclasses.fields(LBFGSMemory):
            v, ref = getattr(state.mem, f.name)[b], getattr(m, f.name)
            kw[f.name] = (v if isinstance(ref, torch.Tensor)
                          else type(ref)(v.item()))
        mems.append(LBFGSMemory(**kw))
    return state._replace(mem=mems)


def run_federated(cfg: RunConfig, datasets: Optional[Sequence[str]] = None,
                  log=print, nadmm: int = 4, epochs: int = 2,
                  minibatches: int = 2, alpha: float = 5.0,
                  robust_nu: Optional[float] = None,
                  reset_ratio: float = 5.0, device=None, open_file=None):
    """The federated stochastic mode over per-band datasets on ``device``
    (CUDA unless ``device="cpu"``).  ``datasets``: the band files, or
    None to expand ``cfg.dataset`` as a glob (over ``open_file``'s
    registry when it has a ``glob``).  Per tile of ``cfg.tilesz``
    timeslots: ``nadmm`` rounds of ``epochs`` x ``minibatches`` passes
    (ceil(tilesz / minibatches) timeslots a minibatch, slave:138), then
    the average.  Returns per tile (dual_res trace, resets)."""
    _refuse(cfg)
    dev = resolve_device(device)
    if datasets is None:
        finder = getattr(open_file, "glob", None)
        datasets = (finder(cfg.dataset) if finder is not None
                    else sorted(_glob.glob(cfg.dataset)))
    if not datasets:
        raise ValueError(f"no band datasets match {cfg.dataset!r}")
    handles: List[VisDataset] = []
    open_files: List = []
    try:
        for p in datasets:
            handles.append(VisDataset(p, "r", open_file))
        return _run(cfg, list(datasets), handles, open_files, log, nadmm,
                    epochs, minibatches, alpha, robust_nu, reset_ratio, dev)
    finally:
        for fh in open_files + handles:
            try:
                fh.close()
            except Exception:
                pass


def _run(cfg, datasets, handles, open_files, log, nadmm, epochs,
         minibatches, alpha, robust_nu, reset_ratio, dev):
    rdt = torch.float64 if cfg.use_f64 else torch.float32
    metas = [h.meta for h in handles]
    meta0 = metas[0]
    N = meta0.nstations
    Nf = len(datasets)
    ntime = min(m.ntime for m in metas)
    freqs = np.asarray([m.freq0 for m in metas])
    freq0 = float(np.mean(freqs))

    manifest = RunManifest.collect(
        device=dev, x64_enabled=cfg.use_f64, app="federated", bands=Nf,
        nadmm=nadmm, epochs=epochs, minibatches=minibatches,
        solver_mode=cfg.solver_mode, n_stations=N)
    elog = default_event_log(manifest=manifest)
    install_crash_handlers()
    if elog is not None:
        register_event_log(elog)
    get_flight_recorder(run_id=manifest.run_id)
    configure_tracer(run_id=manifest.run_id)
    tracer = get_tracer()

    clusters, cdefs, shapelets = load_sky(
        cfg.sky_model, cfg.cluster_file, meta0.ra0, meta0.dec0, dtype=rdt,
        three_term_spectra=None if cfg.sky_format < 0 else bool(cfg.sky_format),
        device=dev)
    M = len(clusters)
    nchunks = [cd.nchunk for cd in cdefs]
    nchunk_max = max(nchunks)
    n8 = 8 * N
    B = consensus.setup_polynomials(freqs, freq0, cfg.npoly,
                                    cfg.poly_type).to(dev, rdt)
    rho = torch.full((Nf, M), cfg.admm_rho, dtype=rdt, device=dev)
    step_fn = make_federated_minibatch_fn(
        Nf, itmax=cfg.max_lbfgs or 8, lbfgs_m=cfg.lbfgs_m or 7, alpha=alpha,
        robust_nu=robust_nu, device=dev)
    avg_fn = make_fed_avg_fn(Nf, alpha=alpha, device=dev)
    eye = jones_to_params(identity_jones(N, complex_dtype_of(rdt),
                                         device=dev))
    p_init = eye.expand(M, nchunk_max, n8)

    # elastic execution: the FederatedState is the only cross-tile carry
    ckmgr = None
    resume_state = None
    resume_done = 0  # completed tiles
    if cfg.resume or cfg.checkpoint_every > 0:
        ckmgr = CheckpointManager(
            cfg.checkpoint_dir or f"{cfg.out_solutions}.ckpt",
            config_fingerprint(
                app="federated",
                datasets=[os.path.abspath(p) for p in datasets],
                sky_model=os.path.abspath(cfg.sky_model),
                cluster_file=os.path.abspath(cfg.cluster_file),
                nstations=N, ntime=ntime, nbands=Nf,
                freqs=[float(f) for f in freqs],
                nadmm=nadmm, epochs=epochs, minibatches=minibatches,
                tilesz=cfg.tilesz, npoly=cfg.npoly, poly_type=cfg.poly_type,
                admm_rho=cfg.admm_rho, alpha=alpha, robust_nu=robust_nu,
                reset_ratio=reset_ratio, max_lbfgs=cfg.max_lbfgs,
                lbfgs_m=cfg.lbfgs_m, use_f64=cfg.use_f64,
                in_column=cfg.in_column),
            "federated", every=max(cfg.checkpoint_every, 1), elog=elog,
            log=log)
        found = ckmgr.resume() if cfg.resume else None
        if found is not None:
            rmeta, resume_state, rpath = found
            resume_done = int(rmeta["tiles_done"])
            for i in range(Nf):
                path = f"{cfg.out_solutions}.band{i}"
                if not os.path.exists(path):
                    raise ResumeRefused(
                        f"checkpoint {rpath} expects solution file {path}, "
                        f"which does not exist")
                v = solio.validate_solutions(path, truncate=True,
                                             max_intervals=resume_done)
                if v["n_intervals"] < resume_done:
                    raise ResumeRefused(
                        f"{path} holds {v['n_intervals']} intervals but "
                        f"checkpoint {rpath} expects {resume_done}")

    band_fhs = []
    for i in range(Nf):
        fh = open(f"{cfg.out_solutions}.band{i}",
                  "a" if resume_done else "w")
        open_files.append(fh)
        if not resume_done:
            solio.write_header(fh, metas[i].freq0, metas[i].deltaf,
                               metas[i].deltat * cfg.tilesz / 60.0, N, M,
                               M * nchunk_max)
        band_fhs.append(fh)

    tmb = -(-cfg.tilesz // minibatches)  # timeslots a minibatch (slave:138)
    results = []
    state = init_federated_state(Nf, M, nchunk_max, n8, cfg.npoly,
                                 cfg.lbfgs_m or 7, rdt, device=dev)
    if resume_state is not None:
        # the fresh state is the template; restore the carry and the
        # completed tiles' results
        state = _unstacked(unflatten_state("state", resume_state,
                                           _stacked(state)), state)
        rr = resume_state["results_resets"]
        results = [(np.asarray(resume_state[f"results_dres.{i}"]),
                    int(rr[i])) for i in range(len(rr))]

    def ckpt_update(ti):
        """End-of-tile checkpoint: the state's leaves and the per-tile
        (dual-res trace, resets) results."""
        if ckmgr is None:
            return
        arrs = flatten_state("state", _stacked(state))
        arrs["results_resets"] = np.asarray([r for _, r in results],
                                            np.int64)
        for i, (d, _) in enumerate(results):
            arrs[f"results_dres.{i}"] = np.asarray(d)
        ckmgr.update(resume_done + ti, arrs,
                     tiles_done=resume_done + ti + 1,
                     run_id=manifest.run_id)
    spec = dict(average_channels=True, min_uvcut=cfg.min_uvcut,
                max_uvcut=cfg.max_uvcut,
                dtype=np.float64 if cfg.use_f64 else np.float32,
                column=cfg.in_column, device=dev)
    # bounded staleness (--consensus-staleness K): the average every K+1
    # rounds, and always on the last so the written solutions are coupled
    avg_every = max(int(cfg.consensus_staleness), 0) + 1

    run_span = tracer.span("federated", kind="run", bands=Nf, nadmm=nadmm,
                           epochs=epochs)
    run_span.__enter__()
    try:
        for ti, t0 in enumerate(
                list(range(0, ntime, cfg.tilesz))[resume_done:]):
            tic = time.time()
            tile_span = tracer.span("tile", kind="tile", tile=t0)
            tile_span.__enter__()
            eff = min(cfg.tilesz, ntime - t0)
            mb_data = []
            for s in range(0, eff, tmb):
                ds, cs = [], []
                for h in handles:
                    d = h.load_tile(t0 + s, min(tmb, eff - s), **spec)
                    d = d.replace(freq0=freq0, deltaf=meta0.deltaf)
                    ds.append(d)
                    cs.append(build_cluster_data(d, clusters, nchunks,
                                                 shapelets=shapelets))
                mb_data.append((stack_for_mesh(ds), stack_for_mesh(cs)))

            dres_trace: List[float] = []
            resets_total = 0
            cost0 = None
            if avg_every > 1 and elog is not None and ti == 0:
                elog.emit("async_schedule", staleness=avg_every - 1,
                          avg_every=avg_every, nadmm=nadmm)
            for admm in range(nadmm):
                round_span = tracer.span("fed.round", kind="admm_round",
                                         round=admm, tile=t0)
                round_span.__enter__()
                for _ in range(epochs):
                    for dst, cst in mb_data:
                        state, dres, cost = step_fn(dst, cst, state, rho, B)
                        dres_trace.append(float(dres))
                if (admm + 1) % avg_every == 0 or admm == nadmm - 1:
                    state = avg_fn(state)
                cost_np = cost.double().cpu().numpy()
                if cost0 is None:
                    cost0 = np.where(np.isfinite(cost_np), cost_np, np.inf)
                else:
                    # a reset band re-bases on its next finite cost
                    rebase = np.isinf(cost0) & np.isfinite(cost_np)
                    cost0 = np.where(rebase, cost_np, cost0)
                bad = ~np.isfinite(cost_np) | (cost_np > reset_ratio * cost0)
                for b in np.nonzero(bad)[0]:
                    log(f"tile {t0} round {admm}: band {b} diverged "
                        f"(cost {cost_np[b]:.3e}) - reset")
                    if elog is not None:
                        elog.emit("band_reset", tile=t0, round=admm,
                                  band=int(b), cost=float(cost_np[b]))
                    state = _reset_band(state, int(b), p_init)
                    cost0[b] = np.inf
                    resets_total += 1
                if bad.sum() * 2 > Nf:
                    # stochastic_master.cpp:360
                    log(f"tile {t0} round {admm}: Most bands did not "
                        f"converge ({int(bad.sum())}/{Nf} reset)")
                round_span.__exit__(None, None, None)
                if elog is not None:
                    elog.emit("fed_round", tile=t0, round=admm,
                              dual_res=dres_trace[-1] if dres_trace else None,
                              resets=int(bad.sum()))
            jsols = params_to_jones(state.p).reshape(
                Nf, M * nchunk_max, N, 2, 2).cpu().numpy()
            for i in range(Nf):
                solio.append_solutions(band_fhs[i], jsols[i])
                band_fhs[i].flush()
            note_activity("tile", name=f"tile{t0}", seconds=time.time() - tic)
            tile_span.__exit__(None, None, None)
            if elog is not None:
                elog.emit("tile_done", tile=t0, resets=resets_total,
                          dual_res=dres_trace[-1] if dres_trace else None,
                          seconds=time.time() - tic)
            log(f"tile {t0}: dual {dres_trace[-1]:.3e} resets "
                f"{resets_total} ({time.time() - tic:.1f}s)")
            results.append((np.asarray(dres_trace), resets_total))
            ckpt_update(ti)
        if ckmgr is not None:
            ckmgr.flush()
            ckmgr.close()
        if elog is not None:
            elog.emit("run_done", n_tiles=len(results))
            elog.close()
            unregister_event_log(elog)
    finally:
        run_span.__exit__(None, None, None)
        close_tracer()
    # the success path only: a crash keeps the recorder for its dump
    close_flight_recorder()
    return results
