"""Multi-tenant calibration service: the batch scheduler (counterpart of
``sagecal_tpu/serve/service.py``).

One process serves many independent (tenant, dataset, tile) solve
requests.  Three mechanisms turn that request mix into full device work
instead of a one-at-a-time dispatch loop:

1. **batch solves** — same-bucket requests stack into one batched solve
   (``solvers/batched.py``): the joint LBFGS of all lanes on the batched
   fused kernels when the bucket passes ``choose_batched_path``, lane by
   lane otherwise (the reference's vmap);
2. **bucketed executable cache** — requests bucket by shape
   (``serve/bucket.py``) and numerics fingerprint; each bucket's route
   is decided once and every later batch of that shape reuses its entry
   (``serve/cache.py``);
3. **double-buffered prefetch** — every (tenant, dataset) stream gets its
   own ``io/dataset.py`` :class:`TilePrefetcher` with ``depth=2``, so the
   dataset read of the next requests overlaps the solve of the current
   batch; prefetchers are closed (threads reaped) as each stream drains.

Scheduling is round-robin across tenants: each turn pops one request
from one tenant's queue, so a tenant with a deep queue cannot starve the
others; batches interleave tenants whenever their requests share a
bucket.

Device split (the fullbatch app's rule): the prefetch threads build CPU
tensors only; this thread moves each tile to the device, builds its
coherencies there, and ``stack_lanes`` stacks a batch's lanes on the
device, so no coherency stack crosses to the host.  The host reads back
a batch's gains and four numbers a lane at once, then each real lane's
quality bundle for its verdict.

Generators are stateful where JAX keys are values: each lane gets a
fresh OS-LM generator derived from ``(0, crc32(request_id))`` at
dispatch (``derive_lane_generators``), replicated pad lanes included,
and the shadow re-solve derives its own again, so the same request
draws the same subsets wherever it runs.

With ``SAGECAL_TRACE=1`` every request writes its own trace: a
``serve.request`` root span from enqueue to its result manifest, with
the phase chain (enqueue, schedule, pack, cache_hit or compile, execute,
unpack, write_manifest) as children (``_emit_lifecycle``, the
reference's); the root's id is in the result manifest.

Elastic state is per tenant, as in the reference: with
``checkpoint_every`` or ``resume`` each tenant gets a
``CheckpointManager`` under ``<checkpoint_dir>/tenants/<tenant>`` whose
checkpoints hold the tenant's ``done`` flags (and, with telemetry on,
the registry's state, restored on resume so counters stay monotonic);
a resumed run skips the requests already served.  ``aot_store``: a
``serve/aot_store.py::AOTArtifactStore`` the kernel build module loads its
libraries from (a fleet's workers share one).
"""

from __future__ import annotations

import collections
import os
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.obs.trace import get_tracer
from sagecal_tpu_torch.serve.bucket import BucketSpec, bucket_of, pad_indices
from sagecal_tpu_torch.serve.cache import ExecutableCache
from sagecal_tpu_torch.serve.request import SolveRequest, write_result_manifest


def _merge_sage_config(cfg, req: SolveRequest):
    """Request solver knobs (None = inherit) over the service-wide
    ServeConfig defaults -> (SageConfig, numerics fingerprint)."""
    from sagecal_tpu_torch.elastic.checkpoint import config_fingerprint
    from sagecal_tpu_torch.obs.registry import telemetry_enabled
    from sagecal_tpu_torch.solvers.sage import SageConfig

    knobs = dict(
        solver_mode=(cfg.solver_mode if req.solver_mode is None
                     else req.solver_mode),
        max_emiter=(cfg.max_emiter if req.max_emiter is None
                    else req.max_emiter),
        max_iter=cfg.max_iter if req.max_iter is None else req.max_iter,
        max_lbfgs=(cfg.max_lbfgs if req.max_lbfgs is None
                   else req.max_lbfgs),
        lbfgs_m=cfg.lbfgs_m if req.lbfgs_m is None else req.lbfgs_m,
        nulow=cfg.nulow if req.nulow is None else req.nulow,
        nuhigh=cfg.nuhigh if req.nuhigh is None else req.nuhigh,
        randomize=(cfg.randomize if req.randomize is None
                   else req.randomize),
    )
    # fused-kernel routing is service-wide, f32-only (the fullbatch
    # precedent: a fused request under use_f64 stays on the torch-op
    # cost)
    use_fused = cfg.use_fused_predict and not cfg.use_f64
    coh_dtype = cfg.coh_dtype
    scfg = SageConfig(
        collect_telemetry=False,  # batched lanes report via quality
        collect_quality=True,     # per-request verdicts are the product
        use_fused_predict=use_fused,
        coh_dtype=coh_dtype,
        **knobs,
    )
    fp = config_fingerprint(use_f64=cfg.use_f64,
                            use_fused_predict=use_fused,
                            coh_dtype=coh_dtype,
                            collect=telemetry_enabled(), **knobs)
    return scfg, fp


class _StreamPool:
    """Bounded pool of double-buffered prefetch streams.

    One stream per (tenant, dataset, tilesz, column) request sequence,
    opened lazily on first touch and capped at ``cap`` concurrently open
    :class:`TilePrefetcher` instances (``cap <= 0`` = unbounded).  Above
    the cap the least recently used stream is CLOSED (its reader thread
    reaped and its file handle released) and reopened from its remaining
    tiles when next touched; each close-for-capacity is counted in
    ``serve_prefetch_evictions_total``.  ``open_file``: the datasets'
    opener (``io.dataset``)."""

    def __init__(self, cap: int, open_file=None):
        self.cap = int(cap)
        self.open_file = open_file
        self.evictions = 0
        self._specs: Dict[tuple, dict] = {}
        self._open_streams: "collections.OrderedDict[tuple, dict]" = \
            collections.OrderedDict()

    def register(self, skey: tuple, t0s: List[int], dtype) -> None:
        from sagecal_tpu_torch.io.dataset import VisDataset

        _, dpath, _tilesz, _column = skey
        with VisDataset(dpath, "r", self.open_file) as ds:
            meta = ds.meta
        self._specs[skey] = {"t0s": list(t0s), "pos": 0, "meta": meta,
                             "dtype": dtype}

    def meta(self, skey: tuple):
        return self._specs[skey]["meta"]

    def next_tile(self, skey: tuple):
        """The next (t0, (data,)) of this stream, opening/reopening its
        prefetcher as needed and closing it when the stream drains."""
        st = self._open_streams.get(skey)
        if st is None:
            st = self._open(skey)
        else:
            self._open_streams.move_to_end(skey)
        spec = self._specs[skey]
        got = next(st["it"])
        spec["pos"] += 1
        if spec["pos"] >= len(spec["t0s"]):
            # drained: reap the reader thread now instead of at teardown
            st["pf"].close()
            self._open_streams.pop(skey, None)
        return got

    def _open(self, skey: tuple) -> dict:
        from sagecal_tpu_torch.io.dataset import TilePrefetcher
        from sagecal_tpu_torch.obs.registry import get_registry

        while self.cap > 0 and len(self._open_streams) >= self.cap:
            _vkey, vst = self._open_streams.popitem(last=False)
            vst["pf"].close()
            self.evictions += 1
            get_registry().counter_inc(
                "serve_prefetch_evictions_total",
                help="prefetch streams closed for capacity "
                     "(reopened from remaining tiles on next touch)")
        spec = self._specs[skey]
        _, dpath, tilesz, column = skey
        pf = TilePrefetcher(
            dpath, spec["t0s"][spec["pos"]:],
            [dict(average_channels=True, dtype=spec["dtype"],
                  column=column)],
            tilesz, depth=2, open_file=self.open_file)
        st = {"pf": pf, "it": iter(pf.__enter__())}
        self._open_streams[skey] = st
        return st

    def close(self) -> None:
        for st in self._open_streams.values():
            st["pf"].close()
        self._open_streams.clear()


class _Entry:
    """One loaded, solve-ready request: its tile and coherencies on the
    device, identity initial gains ``p0`` (M, nchunk_max, 8N), and
    ``lane_id`` (crc32 of the request id), from which every solve of the
    request derives its OS-LM generator."""

    __slots__ = ("req", "data", "cdata", "p0", "lane_id", "scfg", "meta",
                 "nclus", "nchunk_max", "enqueued_at", "started_at")

    def __init__(self, req, data, cdata, p0, lane_id, scfg, meta,
                 nclus, nchunk_max):
        self.req = req
        self.data = data
        self.cdata = cdata
        self.p0 = p0
        self.lane_id = lane_id
        self.scfg = scfg
        self.meta = meta
        self.nclus = nclus
        self.nchunk_max = nchunk_max
        # request-lifecycle wall-clock marks (set by the scheduler)
        self.enqueued_at = 0.0
        self.started_at = 0.0


def _lane_quality(quality: Optional[dict], lane: int) -> Optional[dict]:
    """Lane ``lane`` of a batched solve's quality bundle."""
    if quality is None:
        return None
    return {k: None if q is None else type(q)(
                *(None if f is None else f[lane] for f in q))
            for k, q in quality.items()}


class CalibrationService:
    """Drains a request manifest through bucketed batch solves on
    ``device`` (CUDA unless ``device="cpu"``); ``open_file``: the
    datasets' opener (``io.dataset``; None: ``h5py.File``).

    ``run()`` returns a summary dict (per-request results, latency
    percentiles, executable-cache stats) used by the CLI and the
    tests."""

    def __init__(self, cfg, log=print, device=None, open_file=None,
                 aot_store=None):
        self.cfg = cfg
        self.log = log
        self.device = resolve_device(device)
        self.open_file = open_file
        self.cache = ExecutableCache()
        self.aot_store = aot_store
        if aot_store is not None and self.device.type == "cuda":
            from sagecal_tpu_torch.kernels import build

            build.attach_store(aot_store)
        self._sky_cache: Dict[tuple, tuple] = {}
        self._results: List[Dict[str, Any]] = []
        self._latencies: List[float] = []
        self._diverged_abort: Optional[tuple] = None
        self._slo = None  # SLOMonitor, built in run() from cfg.slo
        # shadow-solve auditor (obs/shadow.py), built in run() iff
        # cfg.shadow_rate > 0 — with the rate at 0 no auditor object
        # exists and the dispatch path is the one without the feature
        self.shadow = None

    # -- data loading --------------------------------------------------

    def _sky(self, req: SolveRequest, ra0, dec0, dtype):
        from sagecal_tpu_torch.io.skymodel import load_sky

        key = (os.path.abspath(req.sky_model),
               os.path.abspath(req.cluster_file),
               float(ra0), float(dec0), str(dtype))
        hit = self._sky_cache.get(key)
        if hit is None:
            hit = load_sky(req.sky_model, req.cluster_file, ra0, dec0,
                           dtype=dtype, device=self.device)
            self._sky_cache[key] = hit
        return hit

    def _load_entry(self, req: SolveRequest, data, meta):
        """Tile data (prefetched CPU tensors) -> solve-ready entry on the
        device: coherencies, identity gains, the request's lane id."""
        from sagecal_tpu_torch.core.types import (
            identity_jones, jones_to_params,
        )
        from sagecal_tpu_torch.solvers.sage import build_cluster_data

        dev = self.device
        dtype = torch.float64 if self.cfg.use_f64 else torch.float32
        cdtype = torch.complex128 if self.cfg.use_f64 else torch.complex64
        clusters, cdefs, shapelets = self._sky(
            req, meta.ra0, meta.dec0, dtype)
        nchunks = [cd.nchunk for cd in cdefs]
        nchunk_max = max(nchunks)
        M = len(clusters)
        N = meta.nstations
        data = data.to(dev)
        cdata = build_cluster_data(data, clusters, nchunks,
                                   shapelets=shapelets)
        eye = jones_to_params(identity_jones(N, cdtype, device=dev))
        p0 = eye.expand(M, nchunk_max, 8 * N).clone()
        scfg, fp = _merge_sage_config(self.cfg, req)
        # a pure function of the FULL request identity: the randomized
        # solver stream reproduces across restarts, schedulers and batch
        # slots
        lane_id = zlib.crc32(req.request_id.encode())
        entry = _Entry(req, data, cdata, p0, lane_id, scfg, meta, M,
                       nchunk_max)
        return entry, fp

    # -- batch dispatch ------------------------------------------------

    def _dispatch(self, bucket: BucketSpec, fingerprint: str,
                  entries: List[_Entry], batch: int, elog,
                  padded_flush: bool) -> None:
        """Stack ``entries`` into one batched solve; unpack each real
        lane into its request's solutions file + result manifest."""
        from sagecal_tpu_torch.solvers.batched import (
            choose_batched_path, derive_lane_generators, stack_lanes,
        )

        idx, valid = pad_indices(len(entries), batch)
        k = len(entries)
        t_pack = time.time()
        data_b, cdata_b, p0 = stack_lanes(
            [(entries[i].data, entries[i].cdata, entries[i].p0)
             for i in idx])
        # a fresh generator per lane, replicas included: a consumed
        # generator would give its replica (and the shadow) other draws
        gens = derive_lane_generators(0, [entries[i].lane_id for i in idx])
        scfg = entries[0].scfg

        # kernel-route capability check on the stacked batch;
        # deterministic per (bucket, fingerprint), so the cache entry
        # and the route always agree
        kernel_path, path_reason = choose_batched_path(
            data_b, cdata_b, p0, scfg)
        batched_fused = kernel_path == "fused_batch"
        args = (data_b, cdata_b, data_b.vis.real, data_b.vis.imag,
                cdata_b.coh.real, cdata_b.coh.imag, p0, scfg, gens, valid)
        if self.device.type == "cuda":  # the stacking ran on the device
            torch.cuda.synchronize(self.device)
        pack_s = time.time() - t_pack
        tic = time.time()
        fn, cache_hit = self.cache.get_with_status(
            bucket, fingerprint, batched_fused=batched_fused)
        out = fn(*args, device=self.device)
        # on the host before unpacking lanes (one sync)
        p_host = out.p.cpu()
        lanes_host = torch.stack(
            [out.res_0, out.res_1, out.diverged.to(out.res_0.dtype),
             out.mean_nu.to(out.res_0.dtype)], 1).tolist()
        solve_s = time.time() - tic
        # the request lifecycle's marks (_emit_lifecycle); no bucket
        # compiles anything in the port
        timing = {
            "t_pack": t_pack, "pack_s": pack_s, "t_exec": tic,
            "solve_s": solve_s, "cache_hit": cache_hit, "compile_s": 0.0,
        }
        if elog is not None:
            elog.emit("serve_batch_dispatched", bucket=bucket.short(),
                      fingerprint=fingerprint[:12], size=k,
                      batch=len(idx), padded=padded_flush,
                      seconds=solve_s,
                      kernel_path=kernel_path,
                      kernel_path_reason=path_reason,
                      cache=self.cache.stats())
        # unpack over the FULL batch width with an explicit validity
        # guard: replication-padded lanes carry a copy of some real
        # request's data, so their solve outputs — and in particular
        # their quality structures — must never reach _finish_request,
        # or a padded lane could fire a spurious verdict for a request
        # that already has its real one from its own lane
        lane_quality = {}
        for lane in range(len(idx)):
            if not valid[lane]:
                continue
            res0, res1, div, nu = lanes_host[lane]
            lane_quality[lane] = _lane_quality(out.quality, lane)
            self._finish_request(
                entries[lane], bucket, lane, len(idx), p_host[lane],
                res0, res1, bool(div), nu, lane_quality[lane], elog,
                timing, kernel_path, path_reason)
        if self.shadow is not None:
            # shadow audits run strictly AFTER every manifest of the
            # batch is on disk — the re-solve shares the process but
            # never the latency path of any request in flight
            for lane in range(len(idx)):
                if not valid[lane]:
                    continue
                self.shadow.audit(
                    entries[lane], bucket.short(), kernel_path,
                    path_reason, p_host[lane].double().numpy(),
                    lanes_host[lane][1], lane_quality[lane], elog)

    def _finish_request(self, entry: _Entry, bucket, lane, batch,
                        p, res0, res1, diverged, mean_nu, quality,
                        elog, timing, kernel_path: str = "xla",
                        path_reason: str = "") -> None:
        from sagecal_tpu_torch.core.types import params_to_jones
        from sagecal_tpu_torch.io import solutions as solio
        from sagecal_tpu_torch.obs.quality import check_and_emit
        from sagecal_tpu_torch.obs.registry import get_registry

        req, meta = entry.req, entry.meta
        t_unpack = time.time()
        # divergence guard, same residual-ratio policy as fullbatch
        ratio_blown = (not np.isfinite(res1) or res1 == 0.0
                       or res1 > self.cfg.res_ratio * res0)
        verdict, reasons = "ok", []
        if quality is not None:
            verdict, reasons = check_and_emit(
                elog, quality, log=self.log, tile=req.t0, app="serve",
                tenant=req.tenant, request_id=req.request_id)
        if diverged or ratio_blown:
            if verdict != "diverged" and elog is not None:
                elog.emit("solver_diverged",
                          reasons=[f"residual_ratio:{res0:.3e}->{res1:.3e}"],
                          tile=req.t0, app="serve", tenant=req.tenant,
                          request_id=req.request_id)
            verdict = "diverged"
            reasons = reasons + [f"residual_ratio:{res0:.3e}->{res1:.3e}"]

        out_path = req.out_solutions or os.path.join(
            self.cfg.out_dir, f"{req.request_id}.solutions")
        N, M, nchunk_max = meta.nstations, entry.nclus, entry.nchunk_max
        jsol = params_to_jones(p).reshape(M * nchunk_max, N, 2, 2).numpy()
        # tmp + replace: the published solutions file is whole at every
        # instant (a reader never sees a header without its solutions)
        tmp_path = f"{out_path}.tmp.{os.getpid()}"
        with open(tmp_path, "w") as fh:
            solio.write_header(
                fh, meta.freq0, meta.deltaf,
                meta.deltat * req.tilesz / 60.0, N, M, M * nchunk_max)
            solio.append_solutions(fh, jsol)
        os.replace(tmp_path, out_path)

        tracer = get_tracer()
        t_write = time.time()
        queue_wait = max(entry.started_at - entry.enqueued_at, 0.0)
        result = {
            "request_id": req.request_id, "tenant": req.tenant,
            "dataset": req.dataset, "t0": req.t0, "tilesz": req.tilesz,
            "verdict": verdict, "reasons": reasons,
            "res_0": res0, "res_1": res1, "mean_nu": mean_nu,
            "bucket": bucket.short(), "batch": batch, "lane": lane,
            # which route solved this request, and why the capability
            # check chose it
            "kernel_path": kernel_path,
            "kernel_path_reason": path_reason,
            "solutions": out_path,
            # wall-clock lifecycle: latency reconstructable from the
            # manifest alone
            "enqueued_at": entry.enqueued_at,
            "started_at": entry.started_at,
            "completed_at": t_write,
            "queue_wait_s": queue_wait,
            "latency_s": t_write - entry.enqueued_at,
            "trace_id": req.trace_id,
        }
        if tracer.enabled:
            result["span_id"] = tracer.allocate_span_id()
        write_result_manifest(self.cfg.out_dir, result)
        write_s = time.time() - t_write
        latency = result["latency_s"]
        self._latencies.append(latency)
        if tracer.enabled:
            self._emit_lifecycle(tracer, entry, bucket, lane, batch,
                                 verdict, timing, t_unpack, t_write,
                                 write_s, result["span_id"])
        self._results.append(result)
        reg = get_registry()
        reg.counter_inc("serve_requests_total", tenant=req.tenant,
                        verdict=verdict,
                        help="serve requests completed, by verdict")
        reg.observe("serve_request_latency_seconds",
                    result["latency_s"], tenant=req.tenant,
                    help="submit -> result-manifest latency")
        reg.observe("serve_queue_wait_seconds", queue_wait,
                    tenant=req.tenant,
                    help="enqueue -> scheduler-pop wait")
        if self._slo is not None and self._slo.enabled:
            self._slo.observe(req.tenant, result["completed_at"],
                              latency, verdict)
            self._slo.evaluate(now=result["completed_at"], elog=elog,
                               registry=reg)
        if elog is not None:
            elog.emit("request_done", **result)
        self.log(f"request {req.request_id} [{req.tenant}]: "
                 f"{verdict} residual {res0:.6f} -> {res1:.6f} "
                 f"(bucket {bucket.short()}, lane {lane}/{batch}, "
                 f"{result['latency_s']:.1f}s)")
        if verdict == "diverged" and self.cfg.abort_on_divergence \
                and self._diverged_abort is None:
            # raised after the whole batch's manifests are on disk
            self._diverged_abort = (req.request_id, req.t0, reasons)

    def _emit_lifecycle(self, tracer, entry: _Entry, bucket, lane, batch,
                        verdict, timing, t_unpack, t_write, write_s,
                        root_id) -> None:
        """One trace per request: a ``serve.request`` root from enqueue to
        the manifest write, the phase chain as its children.  Phases the
        batch shares (pack, compile, execute) are billed to every lane,
        marked ``shared`` with the batch width.  The root records under
        ``root_id``, already written into the result manifest, which
        joins manifest and trace."""
        req = entry.req
        tid = req.trace_id
        base = dict(request_id=req.request_id, tenant=req.tenant,
                    bucket=bucket.short(), lane=lane, batch=batch)
        # parent_id "" (not None) puts the root above any open span
        tracer.add_span(
            "serve.request", t_write + write_s - entry.enqueued_at,
            parent_id="", start_unix=entry.enqueued_at, trace_id=tid,
            span_id=root_id, verdict=verdict, **base)

        def child(name, start, dur, **attrs):
            tracer.add_span(name, max(dur, 0.0), parent_id=root_id,
                            start_unix=start, trace_id=tid,
                            **dict(base, **attrs))

        child("enqueue", entry.enqueued_at,
              entry.started_at - entry.enqueued_at)
        child("schedule", entry.started_at,
              timing["t_pack"] - entry.started_at)
        child("pack", timing["t_pack"], timing["pack_s"], shared=True)
        exec_s = timing["solve_s"] - timing["compile_s"]
        if timing["cache_hit"]:
            child("cache_hit", timing["t_pack"] + timing["pack_s"], 0.0)
        else:
            child("compile", timing["t_exec"], timing["compile_s"],
                  shared=True)
        child("execute", timing["t_exec"] + timing["compile_s"], exec_s,
              shared=True)
        child("unpack", t_unpack, t_write - t_unpack)
        child("write_manifest", t_write, write_s)

    def _build_slo_monitor(self):
        """SLO specs from ``cfg.slo`` (a slo.json) or, failing that, a
        top-level ``"slos"`` key inside the request manifest."""
        from sagecal_tpu_torch.obs.slo import SLOMonitor, load_slo_specs

        specs = {}
        if self.cfg.slo:
            specs = load_slo_specs(self.cfg.slo)
        elif self.cfg.requests and os.path.exists(self.cfg.requests):
            specs = load_slo_specs(self.cfg.requests)
        return SLOMonitor(specs)

    # -- the scheduler -------------------------------------------------

    def run(self, requests: List[SolveRequest], elog=None
            ) -> Dict[str, Any]:
        from sagecal_tpu_torch.elastic.checkpoint import (
            CheckpointManager, config_fingerprint,
        )
        from sagecal_tpu_torch.obs.quality import DivergenceAbort
        from sagecal_tpu_torch.obs.registry import get_registry

        cfg, reg = self.cfg, get_registry()
        t_start = time.time()
        os.makedirs(cfg.out_dir, exist_ok=True)
        self._slo = self._build_slo_monitor()
        shadow_owned = False
        if self.shadow is None and cfg.shadow_rate > 0.0:
            # a fleet worker injects its own persistent auditor (its
            # budget is per worker); the standalone service owns one
            from sagecal_tpu_torch.obs.shadow import ShadowAuditor

            self.shadow = ShadowAuditor(
                cfg.out_dir, rate=cfg.shadow_rate,
                budget_s=cfg.shadow_budget_s, seed=cfg.shadow_seed,
                device=self.device, log=self.log)
            shadow_owned = True

        # per-tenant elastic state: which requests already finished
        tenants = list(dict.fromkeys(r.tenant for r in requests))
        by_tenant = {t: [r for r in requests if r.tenant == t]
                     for t in tenants}
        ckmgrs: Dict[str, CheckpointManager] = {}
        done_flags: Dict[str, np.ndarray] = {}
        skipped = 0
        resumed_metrics: List[tuple] = []  # (metrics_ts, state)
        for t in tenants:
            reqs = by_tenant[t]
            flags = np.zeros(len(reqs), np.uint8)
            if cfg.resume or cfg.checkpoint_every > 0:
                fp = config_fingerprint(
                    app="serve", tenant=t,
                    requests=[(r.request_id, os.path.abspath(r.dataset),
                               r.t0, r.tilesz, r.in_column) for r in reqs],
                    use_f64=cfg.use_f64)
                mgr = ckmgrs[t] = CheckpointManager(
                    os.path.join(cfg.checkpoint_dir or os.path.join(
                        cfg.out_dir, "serve.ckpt"), "tenants", t),
                    fp, "serve", every=max(cfg.checkpoint_every, 1),
                    elog=elog, log=self.log)
                found = mgr.resume() if cfg.resume else None
                if found is not None:
                    rmeta, rarr, rpath = found
                    flags = np.asarray(rarr["done"], np.uint8).copy()
                    n = int(flags.sum())
                    skipped += n
                    self.log(f"resume[{t}]: {n}/{len(reqs)} requests "
                             f"already served ({rpath})")
                    if rmeta.get("metrics"):
                        resumed_metrics.append(
                            (float(rmeta.get("metrics_ts", 0.0)),
                             rmeta["metrics"]))
                    if elog is not None:
                        for r, f in zip(reqs, flags):
                            if f:
                                elog.emit("request_skipped_resume",
                                          request_id=r.request_id, tenant=t)
            done_flags[t] = flags
        if resumed_metrics and reg.enabled:
            # every tenant checkpoint holds the whole registry: restore
            # only the newest, so counters stay monotonic without
            # counting twice
            reg.restore_state(max(resumed_metrics, key=lambda x: x[0])[1])

        queues = {
            t: collections.deque(
                r for r, f in zip(by_tenant[t], done_flags[t]) if not f)
            for t in tenants}
        enqueued_at = {
            r.request_id: r.enqueued_at or time.time()
            for t in tenants for r in queues[t]}
        for t in tenants:
            reg.gauge_set("serve_queue_depth", len(queues[t]),
                          tenant=t,
                          help="requests waiting in this tenant's queue")

        # prefetch streams: one per (tenant, dataset, tilesz, column)
        # request sequence, loading tiles in exactly the order the
        # round-robin pops them
        dtype = np.float64 if cfg.use_f64 else np.float32
        stream_t0s: Dict[tuple, List[int]] = {}
        for t in tenants:
            for r in queues[t]:
                skey = (t, os.path.abspath(r.dataset), r.tilesz,
                        r.in_column)
                stream_t0s.setdefault(skey, []).append(r.t0)
        pool = _StreamPool(cfg.max_streams, self.open_file)

        pending: Dict[tuple, List[_Entry]] = collections.defaultdict(list)
        served = 0

        def mark_done(entry: _Entry) -> None:
            t = entry.req.tenant
            i = next(i for i, r in enumerate(by_tenant[t])
                     if r.request_id == entry.req.request_id)
            done_flags[t][i] = 1
            if t in ckmgrs:
                # the registry's state rides the checkpoint, so a resume
                # keeps counters instead of resetting them
                extra = (dict(metrics=reg.export_state(),
                              metrics_ts=time.time())
                         if reg.enabled else {})
                ndone = int(done_flags[t].sum())
                ckmgrs[t].update(ndone - 1, {"done": done_flags[t]},
                                 requests_done=ndone, tenant=t, **extra)

        def dispatch(bkey, padded_flush):
            nonlocal served
            bucket, fp = bkey
            entries = pending.pop(bkey)
            self._dispatch(bucket, fp, entries, cfg.batch, elog,
                           padded_flush)
            served += len(entries)
            for e in entries:
                mark_done(e)

        try:
            for skey, t0s in stream_t0s.items():
                pool.register(skey, t0s, dtype)
            # round-robin drain: one request per tenant per turn
            alive = True
            while alive:
                alive = False
                for t in tenants:
                    if not queues[t]:
                        continue
                    alive = True
                    req = queues[t].popleft()
                    t_pop = time.time()
                    reg.gauge_set("serve_queue_depth", len(queues[t]),
                                  tenant=t)
                    skey = (t, os.path.abspath(req.dataset),
                            req.tilesz, req.in_column)
                    t0, (data,) = pool.next_tile(skey)
                    if t0 != req.t0:
                        raise RuntimeError(
                            f"prefetch order mismatch for "
                            f"{req.request_id}: got tile {t0}, "
                            f"expected {req.t0}")
                    entry, fp = self._load_entry(
                        req, data, pool.meta(skey))
                    entry.enqueued_at = enqueued_at.get(
                        req.request_id, t_start)
                    entry.started_at = t_pop
                    bkey = (bucket_of(entry.data, entry.cdata, entry.p0),
                            fp)
                    pending[bkey].append(entry)
                    if len(pending[bkey]) >= cfg.batch:
                        dispatch(bkey, padded_flush=False)
            # ragged flush: pad the leftovers of each bucket
            for bkey in list(pending):
                dispatch(bkey, padded_flush=True)
        finally:
            # streams drain exactly when their queues do, so on the
            # success path every stream already closed on its sentinel;
            # on an error path pool.close() reaps the still-open ones
            pool.close()
            if self.shadow is not None and shadow_owned:
                self.shadow.close()
            for mgr in ckmgrs.values():
                mgr.flush()
                mgr.close()
            if reg.enabled:
                # one cumulative snapshot per worker (obs/aggregate.py)
                from sagecal_tpu_torch.obs.aggregate import (
                    metrics_snapshot_path, write_metrics_snapshot,
                )

                try:
                    write_metrics_snapshot(
                        metrics_snapshot_path(cfg.out_dir), registry=reg)
                except OSError:
                    pass

        wall = time.time() - t_start
        lat = sorted(self._latencies)
        p50 = lat[len(lat) // 2] if lat else 0.0
        summary = {
            "requests": len(requests), "served": served,
            "skipped_resume": skipped,
            "tenants": len(tenants), "buckets": self.cache.stats(),
            "wall_s": wall,
            "solves_per_sec": served / wall if wall > 0 else 0.0,
            "p50_latency_s": p50,
            "prefetch_evictions": pool.evictions,
            "results": self._results,
        }
        if self.shadow is not None:
            summary["shadow"] = self.shadow.stats()
        if self._slo is not None and self._slo.enabled:
            summary["slo"] = self._slo.evaluate(registry=reg)
        if elog is not None:
            elog.emit("run_done", app="serve",
                      **{k: v for k, v in summary.items()
                         if k != "results"})
        if self._diverged_abort is not None:
            rid, t0, reasons = self._diverged_abort
            raise DivergenceAbort(
                f"request {rid} (tile {t0}) diverged: "
                f"{'; '.join(reasons)}")
        if self.shadow is not None and self.shadow.exceeded \
                and cfg.abort_on_drift:
            # opt-in escalation, after every manifest and the full drift
            # ledger are on disk
            raise DivergenceAbort(
                "shadow drift exceeded tolerance for request(s) "
                + ", ".join(self.shadow.exceeded)
                + "; aborting (abort_on_drift)")
        return summary
