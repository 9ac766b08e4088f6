"""Streaming calibration: sliding-window solves on a live time stream
(counterpart of ``sagecal_tpu/fleet/stream.py``).

The ``stream`` workload treats a dataset as an arriving time series:
each window of ``window`` time samples (advanced by ``hop``) is solved
as soon as its data is available, and the figure of merit is
**latency-to-first-solution** — how long after a window's data lands
does a usable gain solution exist.

Two mechanisms keep that latency low:

1. **the elastic warm-start chain** — window ``w`` starts from window
   ``w-1``'s converged gains.  Sky and instrument drift slowly across
   one hop, so the warm start is near-converged and a reduced budget
   (``warm_emiter``/``warm_lbfgs``) suffices; only the cold window 0
   pays full iteration budgets.  The chain is exactly the temporal
   warm start the fullbatch tile loop exploits, made load-bearing: the
   reduced warm budgets are only sound BECAUSE the chain exists, and
   the quality watchdog verdicts every window so a chain gone stale
   (divergence) is detected and reset to identity.
2. **one warm configuration** — all warm windows share one
   SageConfig, so steady state repeats one solve shape (the reference's
   executable reuse; the port compiles nothing per window).

The chain itself is checkpointed through the elastic layer with an
*owner lease* stamped into the checkpoint meta (renewed by the
checkpoint cadence): a second stream process pointed at the same
checkpoint directory refuses to adopt a chain whose owner's lease is
still live (``check_owner_lease``) and only takes over once the lease
expires — the same dead-worker-takeover contract as the fleet queue,
applied to stream state.

Random draws: where the reference folds each window into a
``jax.random`` key chain and checkpoints ``rng_key``, window ``w`` draws
its OS-LM subsets from a ``torch.Generator`` derived from ``(seed, w)``
(``solvers/batched.py::derive_lane_generators``), as the port's apps do
per tile; the checkpoint records ``rng_seed``.  An adopting run reads
``p`` and ``windows_done`` only, and first cuts the solutions file back
to ``windows_done`` intervals (``io/solutions.py::validate_solutions``,
the fullbatch app's resume rule): a run killed between a window's
append and its checkpoint leaves one interval more than its checkpoint
records, which the reference's plain append would keep twice.

Every window writes a serve-style result manifest
(``<request_id>-wNNNN.result.json``) carrying ``latency_s`` (window
data ready -> solution on disk, ending in a device synchronize) and the
``warm`` flag, so the SLO evaluator and the fleet's aggregation read
stream runs with no new plumbing.  The solves run on ``device`` (CUDA
unless ``device="cpu"``) on the torch-op joint cost: ``StreamConfig``
has no fused switch, as the reference's, so no hand kernel runs here.
The dataset is opened with ``open_file`` (``io/dataset.py``).
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List

import numpy as np


def stream_windows(ntime: int, window: int, hop: int,
                   max_windows: int = 0) -> List[int]:
    """Start indices of the sliding windows: ``t0 = w * hop`` while a
    full window of data exists.  A degenerate stream (window > ntime)
    yields nothing rather than a short read."""
    window = max(int(window), 1)
    hop = max(int(hop), 1)
    out = [t0 for t0 in range(0, int(ntime) - window + 1, hop)]
    if max_windows:
        out = out[: int(max_windows)]
    return out


def steady_state_latency(latencies: List[float]) -> float:
    """The banked ``latency_to_first_solution_s``: median per-window
    latency over the steady state.  Windows 0 and 1 are excluded when
    the stream is long enough — they carry the first cold and warm
    solves' one-time costs (the reference's two compiles; the port's
    first calls of each shape), not the per-window latency a streaming
    consumer sees."""
    if not latencies:
        return 0.0
    steady = latencies[2:] if len(latencies) > 2 else latencies[-1:]
    s = sorted(steady)
    return float(s[len(s) // 2])


def make_synthetic_stream(workdir: str, nstations: int = 7,
                          ntime: int = 6, nchan: int = 2,
                          noise_sigma: float = 0.0, seed: int = 7,
                          open_file=None, device=None):
    """Simulate one stream fixture (dataset + sky/cluster files) in
    ``workdir``; returns ``(dataset, sky, cluster)`` paths.  Same
    two-source sky as the serve synthetic workload so stream and serve
    runs exercise identical model complexity.  ``open_file``: the
    dataset opener (``io.dataset``; ``io.memh5.MemFile`` where h5py is
    absent); the model is predicted on ``device`` (CUDA unless
    ``device="cpu"``).  Equal arguments give the reference's dataset to
    the predict's rounding."""
    import torch

    from sagecal_tpu_torch.io.dataset import _opener, simulate_dataset
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.serve.synthetic import _CLUSTER, _SKY

    os.makedirs(workdir, exist_ok=True)
    sky = os.path.join(workdir, "stream_sky.txt")
    with open(sky, "w") as f:
        f.write(_SKY)
    cluster = sky + ".cluster"
    with open(cluster, "w") as f:
        f.write(_CLUSTER)
    dec0 = math.radians(51.0)
    path = os.path.join(workdir, f"stream_N{nstations}.vis.h5")
    clusters, _, _ = load_sky(sky, cluster, 0.0, dec0, dtype=torch.float64,
                              device=device)
    simulate_dataset(
        path, nstations=nstations, ntime=ntime, nchan=nchan,
        clusters=clusters,
        jones=random_jones(len(clusters), nstations, seed=seed,
                           amp=0.1, dtype=np.complex128, device=device),
        noise_sigma=noise_sigma, seed=seed, dec0=dec0,
        open_file=open_file, device=device)
    with _opener(open_file)(path, "r+") as f:
        f.attrs["ra0"] = 0.0
        f.attrs["dec0"] = dec0
    return path, sky, cluster


class StreamCalibrator:
    """One stream process: window loop + warm-start chain + lease-aware
    checkpoints + per-window result manifests, on ``device`` (CUDA
    unless ``device="cpu"``) over a dataset opened with ``open_file``."""

    def __init__(self, cfg, log=print, device=None, clock=time.time,
                 open_file=None):
        from sagecal_tpu_torch.obs.aggregate import worker_id

        self.cfg = cfg
        self.log = log
        self.device = device
        self.clock = clock  # injectable so lease logic is checkable
        self.open_file = open_file
        self.owner = worker_id()

    # -- config plumbing ----------------------------------------------

    def _sage_configs(self):
        """(cold, warm) solver configs.  Warm budgets only shrink the
        cold ones — a degenerate config (warm > cold) silently clamps
        so the warm window never does MORE work than the cold one."""
        from sagecal_tpu_torch.obs.registry import telemetry_enabled
        from sagecal_tpu_torch.solvers.sage import SageConfig

        cfg = self.cfg
        common = dict(
            max_iter=cfg.max_iter, lbfgs_m=cfg.lbfgs_m,
            solver_mode=cfg.solver_mode,
            nulow=cfg.nulow, nuhigh=cfg.nuhigh,
            randomize=cfg.randomize,
            collect_telemetry=telemetry_enabled(),
            collect_quality=True,
        )
        cold = SageConfig(max_emiter=cfg.max_emiter,
                          max_lbfgs=cfg.max_lbfgs, **common)
        warm = SageConfig(
            max_emiter=min(max(cfg.warm_emiter, 1), cfg.max_emiter),
            max_lbfgs=min(cfg.warm_lbfgs or cfg.max_lbfgs,
                          cfg.max_lbfgs),
            **common)
        return cold, warm

    def _fingerprint(self, meta, M: int, nchunk_max: int) -> str:
        from sagecal_tpu_torch.elastic.checkpoint import config_fingerprint

        cfg = self.cfg
        return config_fingerprint(
            app="stream", dataset=os.path.abspath(cfg.dataset),
            sky_model=os.path.abspath(cfg.sky_model),
            cluster_file=os.path.abspath(cfg.cluster_file),
            nstations=meta.nstations, ntime=meta.ntime,
            nchan=meta.nchan, freq0=meta.freq0,
            n_clusters=M, nchunk_max=nchunk_max,
            window=cfg.window, hop=cfg.hop,
            warm_start=cfg.warm_start, warm_emiter=cfg.warm_emiter,
            warm_lbfgs=cfg.warm_lbfgs, solver_mode=cfg.solver_mode,
            max_emiter=cfg.max_emiter, max_iter=cfg.max_iter,
            max_lbfgs=cfg.max_lbfgs, lbfgs_m=cfg.lbfgs_m,
            nulow=cfg.nulow, nuhigh=cfg.nuhigh,
            randomize=cfg.randomize, use_f64=cfg.use_f64,
            in_column=cfg.in_column,
        )

    # -- the stream loop ----------------------------------------------

    def run(self, elog=None) -> Dict[str, Any]:
        import torch

        from sagecal_tpu_torch.core.types import (
            complex_dtype_of, identity_jones, jones_to_params,
            params_to_jones,
        )
        from sagecal_tpu_torch.device import resolve_device, synchronize
        from sagecal_tpu_torch.io import solutions as solio
        from sagecal_tpu_torch.io.dataset import VisDataset
        from sagecal_tpu_torch.io.skymodel import load_sky
        from sagecal_tpu_torch.obs.quality import check_and_emit
        from sagecal_tpu_torch.serve.request import write_result_manifest
        from sagecal_tpu_torch.solvers.batched import derive_lane_generators
        from sagecal_tpu_torch.solvers.sage import (
            build_cluster_data, solve_tile,
        )

        cfg = self.cfg
        dev = resolve_device(self.device)
        t_start = self.clock()
        dtype = np.float64 if cfg.use_f64 else np.float32
        rdt = torch.float64 if cfg.use_f64 else torch.float32
        os.makedirs(cfg.out_dir, exist_ok=True)

        ds = VisDataset(cfg.dataset, "r", self.open_file)
        meta = ds.meta
        clusters, cdefs, shapelets = load_sky(
            cfg.sky_model, cfg.cluster_file, meta.ra0, meta.dec0,
            dtype=rdt, device=dev)
        M = len(clusters)
        nchunks = [cd.nchunk for cd in cdefs]
        nchunk_max = max(nchunks)
        N = meta.nstations
        windows = stream_windows(meta.ntime, cfg.window, cfg.hop,
                                 cfg.max_windows)
        stem = os.path.splitext(
            os.path.basename(cfg.dataset))[0].replace(".vis", "")

        eye = jones_to_params(identity_jones(N, complex_dtype_of(rdt),
                                             device=dev))
        pinit = eye.expand(M, nchunk_max, 8 * N).to(rdt).clone()
        p = pinit
        rng_seed = np.asarray([cfg.seed], np.int64)
        cold_cfg, warm_cfg = self._sage_configs()
        sol_path = os.path.join(cfg.out_dir, f"{stem}.stream.solutions")

        # lease-aware checkpointing of the warm-start chain
        ckmgr = None
        resume_done = 0
        if cfg.resume or cfg.checkpoint_every > 0:
            from sagecal_tpu_torch.elastic.checkpoint import (
                CheckpointManager, ResumeRefused, check_owner_lease,
            )

            ckmgr = CheckpointManager(
                cfg.checkpoint_dir
                or os.path.join(cfg.out_dir, "stream.ckpt"),
                self._fingerprint(meta, M, nchunk_max), "stream",
                every=max(cfg.checkpoint_every, 1), elog=elog,
                log=self.log)
            if cfg.resume:
                # Three-phase adoption (read -> gate -> confirm), the
                # shape the protocol model checker verifies: gating on
                # a checkpoint that is no longer the newest would let
                # us adopt a window the live owner has already moved
                # past (the stale-read fork).  The confirm re-read
                # detects a chain that advanced between our read and
                # the lease gate and restarts the adoption attempt.
                for _ in range(8):
                    found = ckmgr.resume()
                    if found is None:
                        break
                    rmeta, rarr, rpath = found
                    # refuse a chain another live process still owns
                    check_owner_lease(rmeta, self.owner,
                                      now=self.clock())
                    again = ckmgr.resume()
                    if again is not None and again[2] != rpath:
                        continue
                    resume_done = int(rmeta["windows_done"])
                    p = torch.as_tensor(rarr["p"]).to(dev, rdt)
                    self.log(f"stream: adopted chain at window "
                             f"{resume_done} from {rpath} (previous "
                             f"owner {rmeta.get('owner')!r})")
                    break
                else:
                    # the chain advanced on every attempt: somebody is
                    # actively writing it, whatever their lease file
                    # said at the instants we sampled it
                    raise ResumeRefused(
                        "checkpoint chain kept advancing during "
                        "adoption; a live owner is writing it")
                if resume_done:
                    # the solutions file holds every window the chain
                    # records and, after a kill between a window's
                    # append and its checkpoint, one more: cut it back
                    # to the chain (a torn tail goes too)
                    v = None
                    if os.path.exists(sol_path):
                        v = solio.validate_solutions(
                            sol_path, truncate=True,
                            max_intervals=resume_done)
                    if v is None or v["n_intervals"] < resume_done:
                        raise ResumeRefused(
                            f"checkpoint chain records {resume_done} "
                            f"windows but {sol_path} holds "
                            f"{0 if v is None else v['n_intervals']} "
                            f"intact intervals; solution file and "
                            f"checkpoint disagree")

        # torchlint: disable=JL008 — deliberate append-chain: solutions
        # must grow across resumed runs (tmp+replace cannot express an
        # append); consumed post-hoc by readers that tolerate a torn
        # tail, and no protocol decision reads this file
        if resume_done:
            sol_fh = open(sol_path, "a")  # torchlint: disable=JL008 — see above
        else:
            sol_fh = open(sol_path, "w")  # torchlint: disable=JL008 — see above
            solio.write_header(
                sol_fh, meta.freq0, meta.deltaf,
                meta.deltat * cfg.window / 60.0, N, M, M * nchunk_max)

        latencies: List[float] = []
        results: List[Dict[str, Any]] = []
        warm_count = resets = 0
        # our own lease deadline (0.0 until the first checkpoint is
        # published); once it passes, a successor may have adopted the
        # chain, so we fence off ALL further chain writes.  A TTL of 0
        # disables leasing — every lease is born expired, so there is
        # no ownership to fence and the deadline stays unarmed.
        lease_deadline = 0.0
        fenced = False
        try:
            for w, t0 in enumerate(windows):
                if w < resume_done:
                    continue
                # window data "arrives": everything after this read is
                # the latency a live stream consumer would experience
                data = ds.load_tile(t0, cfg.window,
                                    average_channels=True, dtype=dtype,
                                    column=cfg.in_column, device=dev)
                synchronize(dev)
                data_ready = self.clock()
                cdata = build_cluster_data(data, clusters, nchunks,
                                           shapelets=shapelets)
                warm = bool(cfg.warm_start and w > 0)
                scfg = warm_cfg if warm else cold_cfg
                p0 = p if warm else pinit
                out = solve_tile(
                    data, cdata, p0, scfg,
                    generator=derive_lane_generators(cfg.seed, [w])[0],
                    device=dev)
                res0, res1 = float(out.res_0), float(out.res_1)
                diverged = (not np.isfinite(res1) or res1 == 0.0
                            or res1 > cfg.res_ratio * res0)
                # a diverged window breaks the chain: reset to identity
                # so the NEXT window re-converges cold instead of
                # warm-starting from a bad state
                p = pinit if diverged else out.p.detach().to(rdt)

                q_verdict, q_reasons = "ok", []
                if out.quality is not None:
                    q_verdict, q_reasons = check_and_emit(
                        elog, out.quality, log=self.log, tile=t0,
                        app="stream")
                if diverged:
                    q_verdict = "diverged"
                    q_reasons = q_reasons + [
                        f"residual_ratio:{res0:.3e}->{res1:.3e}"]
                    resets += 1

                jsol = params_to_jones(p).reshape(
                    M * nchunk_max, N, 2, 2).cpu().numpy()
                solio.append_solutions(sol_fh, jsol)
                sol_fh.flush()
                done = self.clock()
                latency = done - data_ready
                latencies.append(latency)
                warm_count += int(warm)

                result = {
                    "request_id": f"{stem}-w{w:04d}",
                    "tenant": "stream",
                    "dataset": cfg.dataset,
                    "t0": t0, "tilesz": cfg.window, "window": w,
                    "warm": warm, "verdict": q_verdict,
                    "reasons": q_reasons,
                    "res0": res0, "res1": res1,
                    "started_at": data_ready, "completed_at": done,
                    "enqueued_at": data_ready,
                    "latency_s": latency,
                    "latency_to_first_solution_s": latency,
                }
                write_result_manifest(cfg.out_dir, result)
                results.append(result)
                if ckmgr is not None and not fenced:
                    now = self.clock()
                    if 0.0 < lease_deadline <= now:
                        # self-fence: our lease expired before this
                        # renewal, so a successor may already own the
                        # chain — republishing would resurrect our
                        # stale state over its writes.  Keep solving
                        # (manifests are deterministic and idempotent)
                        # but never touch the chain again, not even
                        # from the signal-time crash flusher.
                        fenced = True
                        ckmgr.close()
                        self.log(
                            f"stream: owner lease expired "
                            f"{now - lease_deadline:.1f}s ago; fencing "
                            "off checkpoint writes — a successor may "
                            "own the chain")
                        if elog is not None:
                            elog.emit("stream_lease_fenced", window=w,
                                      deadline=lease_deadline, now=now)
                    else:
                        ckmgr.update(
                            w, {"p": p, "rng_seed": rng_seed},
                            windows_done=w + 1, owner=self.owner,
                            lease_expires_at=now + cfg.lease_ttl_s)
                        if cfg.lease_ttl_s > 0:
                            lease_deadline = now + cfg.lease_ttl_s
                if elog is not None:
                    elog.emit("stream_window", window=w, t0=t0,
                              warm=warm, latency_s=latency,
                              res0=res0, res1=res1, verdict=q_verdict)
                self.log(f"window {w} (t0={t0}): "
                         f"{'warm' if warm else 'cold'} "
                         f"residual {res0:.6f} -> {res1:.6f} "
                         f"({latency:.2f}s to solution)")
            if ckmgr is not None and not fenced:
                # clean completion: RELEASE the owner lease so a
                # successor process can adopt the chain immediately
                # (only a crashed run — this line never reached —
                # holds its lease until the TTL runs out).  The same
                # fence applies: an expired lease means the release is
                # no longer ours to publish.
                now = self.clock()
                if 0.0 < lease_deadline <= now:
                    fenced = True
                    ckmgr.close()
                    self.log("stream: owner lease expired before "
                             "release; leaving the chain to its "
                             "successor")
                else:
                    ckmgr.update(len(windows),
                                 {"p": p, "rng_seed": rng_seed},
                                 windows_done=len(windows),
                                 owner=self.owner, lease_expires_at=0.0)
        finally:
            sol_fh.close()
            if ckmgr is not None:
                if not fenced:
                    ckmgr.flush()
                ckmgr.close()
            ds.close()

        summary = {
            "windows": len(windows),
            "solved": len(latencies) + resume_done,
            "resumed_from": resume_done,
            "warm": warm_count,
            "resets": resets,
            "lease_fenced": fenced,
            "first_window_latency_s": latencies[0] if latencies else 0.0,
            "latency_to_first_solution_s":
                steady_state_latency(latencies),
            "latencies_s": latencies,
            "solutions": sol_path,
            "wall_s": self.clock() - t_start,
        }
        if elog is not None:
            elog.emit("stream_done", **{
                k: v for k, v in summary.items() if k != "latencies_s"})
        self.log(
            f"stream: {summary['solved']}/{summary['windows']} windows "
            f"({warm_count} warm, {resets} chain resets), steady-state "
            f"latency {summary['latency_to_first_solution_s']:.2f}s, "
            f"first {summary['first_window_latency_s']:.2f}s")
        return summary
