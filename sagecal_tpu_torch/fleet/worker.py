"""The fleet worker: claim -> admit -> solve -> complete (counterpart of
``sagecal_tpu/fleet/worker.py``).

One worker process runs this loop against the shared
:class:`~sagecal_tpu_torch.fleet.queue.LeaseQueue`:

1. **scan** the shared out_dir so admission control sees every
   worker's completions (burn state converges fleet-wide without a
   central scheduler);
2. **claim** up to ``batch`` requests in EDF + bucket-affinity order,
   restricted to one ``bucket_hint`` per cycle so the claims stack
   into full batch lanes;
3. **admit** each claimed request (accept / degrade / shed per the
   tenant's SLO burn);
4. **solve** — small requests ride the serve scheduler
   (:class:`~sagecal_tpu_torch.serve.service.CalibrationService`) with
   this worker's persistent ``ExecutableCache`` and shadow auditor
   injected, and the fleet's kernel store (``serve/aot_store.py``)
   attached, so only the first worker of the fleet builds a kernel
   library; large requests (``nstations >= large_stations`` with more
   than one local device) are placed on
   :func:`~sagecal_tpu_torch.solvers.sharded.sharded_joint_fit`.  On one
   card every request takes the service, as the reference does on one
   chip; :meth:`FleetWorker._solve_large` takes its row-block count as
   an argument;
5. **complete** — done markers written only after the result
   manifests are on disk.  A lease this worker lost mid-solve (it
   stalled past the TTL and another worker stole the request) is NOT
   completed here; both workers' manifests are deterministic-identical
   and atomic, so the stolen request still yields exactly one
   manifest.

Failed attempts leave durable failure markers; after ``MAX_ATTEMPTS``
the worker writes an error manifest and completes the request, so one
poisoned input can't wedge the fleet.  The worker solves on ``device``
(CUDA unless ``device="cpu"``; it raises without CUDA) and opens the
datasets with ``open_file`` (``io.memh5.MemFile`` on a machine without
h5py: a worker process then builds its datasets into its own registry
first).  SIGTERM ends the loop with exit 143 after its cleanup.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from sagecal_tpu_torch.fleet.admission import build_controller
from sagecal_tpu_torch.fleet.queue import LeaseLost, LeaseQueue, WorkItem

#: solve attempts per request before it is completed as an error
MAX_ATTEMPTS = 3


def _sigterm_to_exit(signum, frame):
    raise SystemExit(143)


def _request_from_item(item: WorkItem):
    from sagecal_tpu_torch.serve.request import SolveRequest

    fields = {f.name for f in dataclasses.fields(SolveRequest)}
    kw = {k: v for k, v in item.request.items() if k in fields}
    if item.enqueued_at:
        # the fleet queue is the tenant-visible queue: manifests must
        # report wait since WorkItem enqueue, not since worker claim
        kw["enqueued_at"] = item.enqueued_at
    return SolveRequest(**kw)


class FleetWorker:
    """One claim-solve-complete loop over the shared queue."""

    def __init__(self, cfg, log=print, device=None, clock=time.time,
                 open_file=None):
        from sagecal_tpu_torch.device import resolve_device
        from sagecal_tpu_torch.obs.aggregate import worker_id
        from sagecal_tpu_torch.serve.aot_store import AOTArtifactStore
        from sagecal_tpu_torch.serve.cache import ExecutableCache

        self.cfg = cfg
        self.log = log
        self.device = resolve_device(device)
        self.open_file = open_file
        self.clock = clock  # injectable so deadline logic is checkable
        self.wid = cfg.worker_id or worker_id()
        self.queue = LeaseQueue(
            cfg.queue_dir or os.path.join(cfg.out_dir, "queue"),
            worker=self.wid, ttl_s=cfg.lease_ttl_s, clock=clock)
        self.store = AOTArtifactStore(
            cfg.aot_store or os.path.join(cfg.out_dir, "aot-store"))
        # ONE executable cache for the worker's whole life (its
        # in-process tier survives across claim cycles); the store
        # shares the kernel libraries' builds across the fleet
        self.cache = ExecutableCache()
        self.admission = build_controller(cfg, cfg.requests)
        self.affinity: Set[str] = set()
        self._held: Set[str] = set()
        self._lost: Set[str] = set()
        self._hold_lock = threading.Lock()
        self.cycles = 0
        self.solved = 0
        # ONE shadow auditor for the worker's whole life (like the
        # executable cache): the wall-clock budget is per WORKER, not
        # per claim cycle, and every cycle's service gets it injected
        self.shadow = None
        if cfg.shadow_rate > 0.0:
            from sagecal_tpu_torch.obs.shadow import ShadowAuditor

            self.shadow = ShadowAuditor(
                cfg.out_dir, rate=cfg.shadow_rate,
                budget_s=cfg.shadow_budget_s, seed=cfg.shadow_seed,
                device=self.device, log=log)

    # -- config plumbing ----------------------------------------------

    def _serve_cfg(self):
        """The ServeConfig one claim cycle's CalibrationService runs
        under.  Elastic checkpointing is OFF on purpose: the queue's
        done markers are the fleet's durable progress record, so a
        restarted worker re-claims instead of resuming."""
        from sagecal_tpu_torch.apps.config import ServeConfig

        c = self.cfg
        return ServeConfig(
            requests="", out_dir=c.out_dir, batch=c.batch,
            max_emiter=c.max_emiter, max_iter=c.max_iter,
            max_lbfgs=c.max_lbfgs, lbfgs_m=c.lbfgs_m,
            solver_mode=c.solver_mode, nulow=c.nulow, nuhigh=c.nuhigh,
            randomize=c.randomize, res_ratio=c.res_ratio,
            abort_on_divergence=False, resume=False,
            checkpoint_every=0, checkpoint_dir=None,
            use_f64=c.use_f64, use_fused_predict=c.use_fused_predict,
            coh_dtype=c.coh_dtype, verbose=c.verbose, slo="",
            max_streams=c.max_streams,
            # shadow auditing rides the per-cycle service: every worker
            # appends to the SHARED <out_dir>/drift.jsonl (O_APPEND
            # single-write rows never interleave); the sampler is a
            # pure function of (seed, request_id) so the fleet agrees
            # on the sample with no coordination
            shadow_rate=c.shadow_rate, shadow_seed=c.shadow_seed,
            shadow_budget_s=c.shadow_budget_s,
            abort_on_drift=c.abort_on_drift)

    # -- lease upkeep --------------------------------------------------

    def _renew_loop(self, stop: threading.Event) -> None:
        period = self.cfg.lease_renew_s or self.cfg.lease_ttl_s / 3.0
        while not stop.wait(max(period, 0.05)):
            with self._hold_lock:
                held = list(self._held)
            for rid in held:
                try:
                    self.queue.renew(rid)
                except LeaseLost:
                    with self._hold_lock:
                        self._held.discard(rid)
                        self._lost.add(rid)
                except OSError:
                    pass

    def _drop(self, rid: str) -> None:
        with self._hold_lock:
            self._held.discard(rid)

    # -- claiming ------------------------------------------------------

    def claim_cycle(self) -> List[WorkItem]:
        """Claim up to ``batch`` requests sharing one bucket hint."""
        cands = self.queue.select(
            self.affinity, limit=max(self.cfg.batch * 4, 8))
        claimed: List[WorkItem] = []
        hint: Optional[str] = None
        for it in cands:
            if hint is not None and it.bucket_hint != hint:
                continue
            if self.queue.claim(it.request_id):
                claimed.append(it)
                hint = it.bucket_hint
                if it.bucket_hint:
                    self.affinity.add(it.bucket_hint)
                if len(claimed) >= self.cfg.batch:
                    break
        return claimed

    # -- solving -------------------------------------------------------

    def _solve_small(self, items: List[Tuple[WorkItem, bool]],
                     elog) -> None:
        from sagecal_tpu_torch.serve.service import CalibrationService

        reqs = [_request_from_item(it) for it, _ in items]
        svc = CalibrationService(self._serve_cfg(), log=self.log,
                                 device=self.device,
                                 open_file=self.open_file,
                                 aot_store=self.store)
        svc.cache = self.cache  # persistent in-process tier
        svc.shadow = self.shadow  # worker-lifetime audit budget
        svc.run(reqs, elog=elog)
        for it, degraded in items:
            if degraded:
                self._annotate_degraded(it.request_id)

    def _annotate_degraded(self, rid: str) -> None:
        """Stamp ``degraded: true`` into an existing result manifest
        (atomic rewrite) so tenants can see which results were
        produced under admission pressure."""
        import json

        from sagecal_tpu_torch.serve.request import (
            result_manifest_path, write_result_manifest,
        )

        path = result_manifest_path(self.cfg.out_dir, rid)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        doc["degraded"] = True
        doc["degrade_emiter"] = self.admission.degrade_emiter
        doc["degrade_lbfgs"] = self.admission.degrade_lbfgs
        write_result_manifest(self.cfg.out_dir, doc)

    def local_devices(self) -> int:
        """Devices of this worker's kind on this host."""
        import torch

        if self.device.type == "cuda":
            return torch.cuda.device_count()
        return 1

    def _can_shard(self) -> bool:
        return self.cfg.large_stations > 0 and self.local_devices() > 1

    def _solve_large(self, item: WorkItem, degraded: bool, elog,
                     nshards: Optional[int] = None) -> None:
        """Place one large solve on the rows-sharded joint LBFGS
        (``solvers/sharded.py``) in ``nshards`` row blocks (default: the
        local device count) instead of a batch lane."""
        import numpy as np
        import torch

        from sagecal_tpu_torch.core.types import (
            identity_jones, jones_to_params, params_to_jones,
        )
        from sagecal_tpu_torch.io import solutions as solio
        from sagecal_tpu_torch.io.dataset import VisDataset
        from sagecal_tpu_torch.io.skymodel import load_sky
        from sagecal_tpu_torch.obs.quality import check_and_emit
        from sagecal_tpu_torch.serve.request import write_result_manifest
        from sagecal_tpu_torch.solvers.sage import build_cluster_data
        from sagecal_tpu_torch.solvers.sharded import (
            pad_rows_to, sharded_joint_fit,
        )

        req = _request_from_item(item)
        cfg, dev = self.cfg, self.device
        nshards = nshards or self.local_devices()
        t_start = self.clock()
        rdt = torch.float64 if cfg.use_f64 else torch.float32
        cdtype = torch.complex128 if cfg.use_f64 else torch.complex64
        with VisDataset(req.dataset, "r", self.open_file) as ds:
            meta = ds.meta
            data = ds.load_tile(req.t0, req.tilesz,
                                dtype=np.float64 if cfg.use_f64
                                else np.float32,
                                column=req.in_column, device=dev)
        clusters, cdefs, shapelets = load_sky(
            req.sky_model, req.cluster_file, meta.ra0, meta.dec0,
            dtype=rdt, device=dev)
        nchunks = [cd.nchunk for cd in cdefs]
        nchunk_max = max(nchunks)
        M, N = len(clusters), meta.nstations
        cdata = build_cluster_data(data, clusters, nchunks,
                                   shapelets=shapelets)
        eye = jones_to_params(identity_jones(N, cdtype, device=dev))
        p0 = eye.expand(M, nchunk_max, 8 * N).to(rdt)
        data, cdata = pad_rows_to(data, cdata, nshards)
        itmax = (self.admission.degrade_lbfgs if degraded
                 else cfg.max_lbfgs)
        p, cost, iterations, quality = sharded_joint_fit(
            data, cdata, p0, nshards, itmax=itmax, lbfgs_m=cfg.lbfgs_m,
            collect_quality=True, device=dev)
        verdict, reasons = check_and_emit(
            elog, quality, log=self.log, tile=req.t0, app="fleet",
            tenant=req.tenant, request_id=req.request_id)
        out_path = req.out_solutions or os.path.join(
            cfg.out_dir, f"{req.request_id}.solutions")
        jsol = params_to_jones(p).reshape(M * nchunk_max, N, 2, 2)
        # tmp + replace: a zombie whose lease was stolen may write the
        # same solutions path concurrently with the stealer — both
        # produce identical bytes, and the atomic rename keeps the
        # published file whole at every instant
        tmp_path = f"{out_path}.tmp.{os.getpid()}"
        with open(tmp_path, "w") as fh:
            solio.write_header(
                fh, meta.freq0, meta.deltaf,
                meta.deltat * req.tilesz / 60.0, N, M, M * nchunk_max)
            solio.append_solutions(fh, jsol.cpu().numpy())
        os.replace(tmp_path, out_path)
        now = self.clock()
        result = {
            "request_id": req.request_id, "tenant": req.tenant,
            "dataset": req.dataset, "t0": req.t0,
            "tilesz": req.tilesz, "verdict": verdict,
            "reasons": reasons, "res_0": float(cost),
            "res_1": float(cost), "mean_nu": 0.0,
            "bucket": f"sharded:{nshards}blk", "batch": 1, "lane": 0,
            "placed": "sharded_joint_fit",
            "kernel_path": "sharded",
            "kernel_path_reason": (
                f"nstations={N} >= large_stations="
                f"{cfg.large_stations}: rows-sharded joint fit in "
                f"{nshards} row blocks"),
            "iterations": int(iterations),
            "solutions": out_path,
            "enqueued_at": item.enqueued_at, "started_at": t_start,
            "completed_at": now,
            "queue_wait_s": max(t_start - item.enqueued_at, 0.0),
            "latency_s": now - item.enqueued_at,
            "trace_id": req.trace_id,
        }
        if degraded:
            result["degraded"] = True
        write_result_manifest(cfg.out_dir, result)
        if elog is not None:
            elog.emit("request_done", **result)

    # -- one cycle -----------------------------------------------------

    def process(self, claimed: List[WorkItem], elog=None) -> int:
        """Admit + solve + complete one batch of claimed requests.
        Returns how many completed."""
        from sagecal_tpu_torch.serve.request import (
            result_manifest_path, write_result_manifest,
        )

        with self._hold_lock:
            self._held = {it.request_id for it in claimed}
            self._lost = set()
        stop = threading.Event()
        renewer = threading.Thread(
            target=self._renew_loop, args=(stop,), daemon=True,
            name=f"lease-renew-{self.wid}")
        renewer.start()
        done = 0
        try:
            self.admission.ingest_dir(self.cfg.out_dir)
            to_solve: List[Tuple[WorkItem, bool]] = []
            for it in claimed:
                decision, detail = self.admission.decide(it.tenant)
                if decision == "shed":
                    self.admission.shed_result(
                        it, self.cfg.out_dir, detail)
                    if elog is not None:
                        elog.emit("request_shed",
                                  request_id=it.request_id,
                                  tenant=it.tenant, worker=self.wid,
                                  **detail)
                    self.queue.complete(it.request_id, verdict="shed")
                    self._drop(it.request_id)
                    done += 1
                    continue
                if decision == "degrade":
                    it.request = self.admission.degrade_request(
                        it.request)
                    if elog is not None:
                        elog.emit("request_degraded",
                                  request_id=it.request_id,
                                  tenant=it.tenant, worker=self.wid,
                                  **detail)
                to_solve.append((it, decision == "degrade"))

            small = [(it, d) for it, d in to_solve
                     if not (it.large and self._can_shard())]
            large = [(it, d) for it, d in to_solve
                     if it.large and self._can_shard()]
            try:
                if small:
                    self._solve_small(small, elog)
                for it, d in large:
                    self._solve_large(it, d, elog)
            except Exception as e:  # noqa: BLE001 — fleet must survive
                self.log(f"worker {self.wid}: solve cycle failed: "
                         f"{e!r}")
                for it, _ in to_solve:
                    rid = it.request_id
                    if rid in self._lost:
                        continue
                    attempts = self.queue.record_failure(rid, repr(e))
                    if attempts >= MAX_ATTEMPTS:
                        now = self.clock()
                        write_result_manifest(self.cfg.out_dir, {
                            "request_id": rid, "tenant": it.tenant,
                            "verdict": "error",
                            "reasons": [f"attempts={attempts}",
                                        repr(e)[:500]],
                            "enqueued_at": it.enqueued_at,
                            "started_at": now, "completed_at": now,
                            "queue_wait_s": 0.0,
                            "latency_s": max(now - it.enqueued_at,
                                             0.0),
                        })
                        self.queue.complete(rid, verdict="error")
                        done += 1
                    else:
                        self.queue.release(rid)
                    self._drop(rid)
                return done

            for it, _ in to_solve:
                rid = it.request_id
                if rid in self._lost:
                    # stolen mid-solve: the stealer owns completion
                    continue
                manifest = result_manifest_path(self.cfg.out_dir, rid)
                if os.path.exists(manifest):
                    self.queue.complete(rid, manifest=manifest)
                    self.solved += 1
                    done += 1
                else:
                    self.queue.release(rid)
                self._drop(rid)
        finally:
            stop.set()
            renewer.join(timeout=5.0)
            with self._hold_lock:
                for rid in list(self._held):
                    self.queue.release(rid)
                self._held = set()
        return done

    # -- the loop ------------------------------------------------------

    def run(self, elog=None) -> Dict[str, Any]:
        from sagecal_tpu_torch.obs.registry import get_registry

        # Coordinator shutdown sends SIGTERM the moment the queue
        # drains; the default action kills the process without running
        # finally blocks.  Convert to SystemExit(143) so cleanup (lease
        # release, snapshots) runs.  Only possible from the main thread
        # — in-process harnesses driving run() from a worker thread keep
        # default handling.
        if threading.current_thread() is threading.main_thread():
            try:
                signal.signal(signal.SIGTERM, _sigterm_to_exit)
            except (ValueError, OSError):
                pass

        cfg, reg = self.cfg, get_registry()
        os.makedirs(cfg.out_dir, exist_ok=True)
        t0 = self.clock()
        idle_since: Optional[float] = None
        while True:
            claimed = self.claim_cycle()
            if claimed:
                idle_since = None
                self.cycles += 1
                if elog is not None:
                    elog.emit("fleet_claimed", worker=self.wid,
                              n=len(claimed),
                              hint=claimed[0].bucket_hint,
                              ids=[it.request_id for it in claimed])
                self.process(claimed, elog=elog)
                continue
            if not cfg.open_loop and self.queue.all_done(empty=False):
                # under open-loop load the queue repeatedly LOOKS
                # drained between arrivals; only idle timeout or the
                # coordinator's SIGTERM ends an open-loop worker
                break
            now = self.clock()
            if idle_since is None:
                idle_since = now
            elif now - idle_since > cfg.max_idle_s:
                # nothing claimable for a while (live leases held by
                # peers): let the coordinator's view decide the end
                break
            time.sleep(cfg.poll_s)
        from sagecal_tpu_torch.kernels import build

        wall = self.clock() - t0
        summary = {
            "worker": self.wid, "cycles": self.cycles,
            "solved": self.solved, "wall_s": wall,
            "cache": self.cache.stats(),
            "store": self.store.stats(), "builds": build.builds,
            "admission": dict(self.admission.decisions),
        }
        if self.shadow is not None:
            summary["shadow"] = self.shadow.stats()
            self.shadow.close()
        if reg.enabled:
            from sagecal_tpu_torch.obs.aggregate import (
                metrics_snapshot_path, write_metrics_snapshot,
            )

            try:
                write_metrics_snapshot(
                    metrics_snapshot_path(cfg.out_dir, self.wid),
                    registry=reg)
            except OSError:
                pass
        if elog is not None:
            elog.emit("fleet_worker_done", **summary)
        self.log(f"worker {self.wid}: {self.solved} solved in "
                 f"{self.cycles} cycles ({wall:.1f}s), "
                 f"cache {self.cache.stats()}, "
                 f"kernel store {self.store.stats()}, "
                 f"admission {self.admission.decisions}")
        return summary
