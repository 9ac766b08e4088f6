"""The fleet coordinator: seed the queue, spawn workers, watch leases
(counterpart of ``sagecal_tpu/fleet/coordinator.py``).

The coordinator is deliberately thin — the queue's lease protocol does
the actual scheduling, so the coordinator only has to

1. **seed** the shared queue from a request manifest, stamping each
   item with its scheduling metadata: the absolute deadline (enqueue
   time + the tenant's SLO ``deadline_s``), a ``bucket_hint`` (the
   coarse shape class, read once per dataset so workers can claim by
   affinity without opening the dataset themselves), and the ``large``
   placement flag (``nstations >= large_stations``);
2. **spawn** N worker subprocesses (``python -m
   sagecal_tpu_torch.apps.fleet --role worker``, or the caller's
   ``argv_fn``), each with a stable ``SAGECAL_WORKER_ID`` so metric
   snapshots and lease files carry worker lineage;
3. **watch** — poll queue stats (surfacing expired leases, i.e. dead
   workers, which any live worker will steal), respawn crashed workers
   within a budget, append the live timeline and feed the report-only
   autoscale recommender, and finish when every item has a done marker
   or every worker has exited;
4. **report** the merged fleet view (obs/aggregate.py) plus post-hoc
   SLO evaluation over the result manifests.

Killing a worker (even SIGKILL) loses nothing: its leases expire,
survivors steal and re-solve, and the atomic manifest writes keep the
result set duplicate- and torn-free.  The coordinator touches no CUDA:
each worker resolves its own device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Set

from sagecal_tpu_torch.fleet.queue import LeaseQueue, WorkItem


def bucket_hint_for(meta, tilesz: int, nchan_avg: bool = True) -> str:
    """Coarse shape-affinity key for a request: enough to group
    same-shape work (stations × tile × channels decide the compiled
    program's shape class) without loading any sky model."""
    nchan = 1 if nchan_avg else meta.nchan
    return f"N{meta.nstations}xT{tilesz}xF{nchan}"


def seed_queue(queue: LeaseQueue, requests, specs,
               large_stations: int = 0, log=print,
               now: Optional[float] = None,
               open_file=None) -> List[WorkItem]:
    """One WorkItem per request.  ``specs`` is the tenant SLO map
    (deadline_s -> absolute EDF deadlines); datasets are opened once
    each (with ``open_file``, ``io.dataset``'s opener) for their shape
    metadata."""
    from sagecal_tpu_torch.io.dataset import VisDataset

    metas: Dict[str, Any] = {}
    items: List[WorkItem] = []
    now = queue.clock() if now is None else float(now)
    for r in requests:
        path = os.path.abspath(r.dataset)
        meta = metas.get(path)
        if meta is None:
            ds = VisDataset(path, "r", open_file)
            meta = ds.meta
            ds.close()
            metas[path] = meta
        spec = specs.get(r.tenant)
        item = WorkItem(
            request_id=r.request_id, tenant=r.tenant,
            request={k: v for k, v in r.__dict__.items()},
            deadline=(now + spec.deadline_s) if spec is not None
            else float("inf"),
            bucket_hint=bucket_hint_for(meta, r.tilesz),
            enqueued_at=now,
            large=bool(large_stations
                       and meta.nstations >= large_stations))
        queue.put(item)
        items.append(item)
    log(f"fleet: seeded {len(items)} requests into {queue.root} "
        f"({len(metas)} datasets, "
        f"{sum(1 for i in items if i.large)} large)")
    return items


def worker_argv(cfg, index: int) -> List[str]:
    """The command line for one worker subprocess, reproducing the
    coordinator's config with ``--role worker``."""
    argv = [sys.executable, "-m", "sagecal_tpu_torch.apps.fleet",
            "--role", "worker",
            "--requests", cfg.requests,
            "--out-dir", cfg.out_dir,
            "--queue-dir", cfg.queue_dir or
            os.path.join(cfg.out_dir, "queue"),
            "--aot-store", cfg.aot_store or
            os.path.join(cfg.out_dir, "aot-store"),
            "--worker-id", f"w{index}",
            "--batch", str(cfg.batch),
            "--lease-ttl", str(cfg.lease_ttl_s),
            "--poll", str(cfg.poll_s),
            "--max-idle", str(cfg.max_idle_s),
            "--large-stations", str(cfg.large_stations),
            "--overload-policy", cfg.overload_policy,
            "--degrade-emiter", str(cfg.degrade_emiter),
            "--degrade-lbfgs", str(cfg.degrade_lbfgs),
            "--max-streams", str(cfg.max_streams),
            "-e", str(cfg.max_emiter), "-g", str(cfg.max_iter),
            "-l", str(cfg.max_lbfgs), "-m", str(cfg.lbfgs_m),
            "-j", str(cfg.solver_mode)]
    if cfg.slo:
        argv += ["--slo", cfg.slo]
    if cfg.open_loop:
        argv += ["--open-loop"]
    if not cfg.use_f64:
        argv += ["--f32"]
    if cfg.use_fused_predict:
        argv += ["--fused"]
    if cfg.coh_dtype != "f32":
        argv += ["--coh-dtype", cfg.coh_dtype]
    if cfg.shadow_rate > 0.0:
        argv += ["--shadow-rate", str(cfg.shadow_rate),
                 "--shadow-budget-s", str(cfg.shadow_budget_s),
                 "--shadow-seed", str(cfg.shadow_seed)]
        if cfg.abort_on_drift:
            argv += ["--abort-on-drift"]
    if cfg.verbose:
        argv += ["-V"]
    return argv


class FleetCoordinator:
    """Seed + spawn + watch + report."""

    def __init__(self, cfg, log=print, clock=time.time, argv_fn=worker_argv,
                 open_file=None):
        self.cfg = cfg
        self.log = log
        self.clock = clock  # injectable so watch deadlines are checkable
        # (cfg, slot) -> a worker's command line; the dataset opener of
        # seed_queue
        self.argv_fn = argv_fn
        self.open_file = open_file
        self.queue = LeaseQueue(
            cfg.queue_dir or os.path.join(cfg.out_dir, "queue"),
            worker="coordinator", ttl_s=cfg.lease_ttl_s, clock=clock)
        self.procs: List[subprocess.Popen] = []
        # worker-slot table: slot index -> CURRENT Popen for that
        # SAGECAL_WORKER_ID.  A respawn replaces the slot's proc (same
        # wid, so obs/aggregate.dedupe_snapshots supersedes the dead
        # predecessor's snapshot); retired slots never respawn.
        self._slots: Dict[int, subprocess.Popen] = {}
        self._next_slot = 0
        self._respawns: Dict[int, int] = {}
        self._retired: Set[int] = set()
        self._handled: Set[int] = set()  # dead pids already triaged
        self.elog = None
        self._sampler = None
        self._recommender = None

    # -- observability (live timeline + report-only recommender) -------

    def setup_observability(self, specs=None, elog=None) -> None:
        """Arm the live timeline sampler and the autoscale recommender
        for this run.  Pure observation plus an advisory in-memory
        recommendation — only ``cfg.elastic_workers`` makes
        :meth:`poll_duties` act on it."""
        self.elog = elog
        if not self.cfg.timeline:
            return
        from sagecal_tpu_torch.obs.capacity import (
            AutoscaleRecommender, RecommenderConfig,
        )
        from sagecal_tpu_torch.obs.timeline import TimelineSampler, timeline_path

        os.makedirs(self.cfg.out_dir, exist_ok=True)
        self._sampler = TimelineSampler(
            timeline_path(self.cfg.out_dir), queue=self.queue,
            out_dir=self.cfg.out_dir, slo_specs=specs,
            aot_store=self.cfg.aot_store or
            os.path.join(self.cfg.out_dir, "aot-store"),
            clock=self.clock)
        lo = max(self.cfg.min_workers, 1)
        hi = self.cfg.max_workers or max(self.cfg.workers, lo)
        self._recommender = AutoscaleRecommender(
            RecommenderConfig(min_workers=lo,
                              max_workers=max(hi, lo)),
            self.cfg.workers)

    def close_observability(self) -> None:
        sampler, self._sampler = self._sampler, None
        if sampler is not None:
            sampler.close()
        self._recommender = None

    # -- worker lifecycle ----------------------------------------------

    def _spawn_slot(self, slot: int) -> subprocess.Popen:
        env = dict(os.environ, SAGECAL_WORKER_ID=f"w{slot}")
        # the fleet view (compile/AOT-hit accounting, snapshots) is
        # metrics-registry-driven, and the registry is telemetry-
        # gated — default it ON for workers; an explicit operator
        # setting (even "0") still wins
        env.setdefault("SAGECAL_TELEMETRY", "1")
        # the workers import the package the coordinator runs
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + [x for x in [env.get("PYTHONPATH")] if x])
        p = subprocess.Popen(self.argv_fn(self.cfg, slot), env=env)
        self.procs.append(p)
        self._slots[slot] = p
        return p

    def spawn_workers(self, n: Optional[int] = None) -> None:
        n = self.cfg.workers if n is None else n
        pids = []
        for _ in range(n):
            slot = self._next_slot
            self._next_slot += 1
            pids.append(self._spawn_slot(slot).pid)
        self.log(f"fleet: spawned {n} workers (pids {pids})")

    def _respawn_crashed(self, now: float) -> None:
        """Bounded respawn of crashed workers: a slot whose proc died
        with a nonzero exit while work remains gets a replacement with
        the SAME worker id, up to ``cfg.max_respawns`` times per slot —
        a load measurement must not silently degrade to fewer workers.
        Clean exits (idle drain) and retired slots are not crashes."""
        cap = self.cfg.max_respawns
        for slot, p in list(self._slots.items()):
            rc = p.poll()
            if rc is None or p.pid in self._handled:
                continue
            self._handled.add(p.pid)
            if rc == 0 or slot in self._retired:
                continue
            if self.queue.all_done(empty=False):
                continue
            count = self._respawns.get(slot, 0)
            if count >= cap:
                self.log(f"fleet: worker w{slot} crashed (rc={rc}) "
                         f"with respawn budget exhausted "
                         f"({count}/{cap})")
                continue
            self._respawns[slot] = count + 1
            np_ = self._spawn_slot(slot)
            self.log(f"fleet: respawned crashed worker w{slot} "
                     f"(rc={rc}, attempt {count + 1}/{cap}, "
                     f"pid {np_.pid})")
            if self.elog is not None:
                self.elog.emit("worker_respawned", slot=slot,
                               worker=f"w{slot}", exit_code=rc,
                               attempt=count + 1, max_respawns=cap,
                               pid=np_.pid)

    def _live_slots(self) -> List[int]:
        return sorted(s for s, p in self._slots.items()
                      if p.poll() is None and s not in self._retired)

    def _apply_scale(self, target: int) -> None:
        """Honor the in-memory recommendation (``--elastic-workers``):
        spawn up to ``target`` live workers, or retire down to it by
        SIGTERMing the highest slots — the worker's existing SIGTERM →
        SystemExit path releases its leases in its finally block (the
        stop-claiming-then-clean-exit contract), so retirement adds no
        new coordination file to the lease protocol."""
        lo = max(self.cfg.min_workers, 1)
        hi = self.cfg.max_workers or max(self.cfg.workers, lo)
        target = max(lo, min(int(target), max(hi, lo)))
        live = self._live_slots()
        if len(live) < target:
            for _ in range(target - len(live)):
                slot = self._next_slot
                self._next_slot += 1
                p = self._spawn_slot(slot)
                self.log(f"fleet: elastic scale-up -> w{slot} "
                         f"(pid {p.pid}, {len(self._live_slots())} "
                         f"live)")
                if self.elog is not None:
                    self.elog.emit("worker_scaled_up", slot=slot,
                                   worker=f"w{slot}", pid=p.pid,
                                   target=target)
        elif len(live) > target:
            for slot in reversed(live[target:]):
                self._retired.add(slot)
                self._slots[slot].terminate()
                self.log(f"fleet: elastic retire -> w{slot} "
                         f"(SIGTERM; leases release on exit)")
                if self.elog is not None:
                    self.elog.emit("worker_retired", slot=slot,
                                   worker=f"w{slot}", target=target)

    def poll_duties(self, now: Optional[float] = None) -> None:
        """The coordinator's once-per-poll housekeeping: triage dead
        workers (bounded respawn), append one live timeline row, feed
        the recommender, and — only under ``--elastic-workers`` —
        act on its recommendation."""
        now = self.clock() if now is None else float(now)
        self._respawn_crashed(now)
        if self._sampler is None or self._sampler.closed:
            return
        alive = sum(1 for p in self.procs if p.poll() is None)
        row = self._sampler.sample(now=now, alive_workers=alive)
        if self._recommender is None:
            return
        rec = self._recommender.update(row)
        if rec is not None:
            from sagecal_tpu_torch.obs.capacity import write_recommendation

            write_recommendation(self.cfg.out_dir, rec)
            self.log(
                f"fleet: scale recommendation -> "
                f"{rec['recommended_workers']} workers "
                f"(was {rec['previous_workers']}, {rec['reason']})")
            if self.elog is not None:
                self.elog.emit("scale_recommendation", **{
                    k: v for k, v in rec.items()
                    if k != "schema_version"})
        if self.cfg.elastic_workers:
            self._apply_scale(self._recommender.recommended)

    def watch(self, timeout_s: float = 0.0,
              poll_s: float = 1.0) -> bool:
        """Poll until every item is done or every worker exited.
        Returns True iff the queue fully drained."""
        t0 = self.clock()
        last_stats = ""
        while True:
            if self.queue.all_done():
                return True
            self.poll_duties()
            alive = [p for p in self.procs if p.poll() is None]
            stats = self.queue.stats()
            line = (f"fleet: {stats['done']}/{stats['items']} done, "
                    f"{stats['waiting']} waiting, "
                    f"{stats['leased']} leased, "
                    f"{stats['expired_leases']} expired leases, "
                    f"{len(alive)} workers alive")
            if line != last_stats:
                self.log(line)
                last_stats = line
            if not alive:
                return self.queue.all_done()
            if timeout_s and self.clock() - t0 > timeout_s:
                return self.queue.all_done()
            time.sleep(poll_s)

    def shutdown(self, grace_s: float = 10.0) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = self.clock() + grace_s
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(deadline - self.clock(), 0.1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()

    def summary(self, requests) -> Dict[str, Any]:
        """Merged fleet view + post-hoc SLO evaluation."""
        from sagecal_tpu_torch.obs.aggregate import (
            read_result_manifests, state_counter_total,
        )
        from sagecal_tpu_torch.obs.aggregate import (
            dedupe_snapshots, merge_states, read_metrics_snapshots,
        )
        from sagecal_tpu_torch.obs.slo import evaluate_results, load_slo_specs

        results = read_result_manifests(self.cfg.out_dir)
        snaps = dedupe_snapshots(
            read_metrics_snapshots(self.cfg.out_dir))
        state = merge_states(d["state"] for d in snaps)
        lat = sorted(float(r.get("latency_s", 0.0)) for r in results
                     if r.get("verdict") not in ("shed",))
        specs = {}
        if self.cfg.slo:
            specs = load_slo_specs(self.cfg.slo)
        elif self.cfg.requests and os.path.exists(self.cfg.requests):
            specs = load_slo_specs(self.cfg.requests)
        out = {
            "requests": len(requests),
            "manifests": len(results),
            "done": self.queue.stats()["done"],
            "shed": sum(1 for r in results
                        if r.get("verdict") == "shed"),
            "degraded": sum(1 for r in results if r.get("degraded")),
            "errors": sum(1 for r in results
                          if r.get("verdict") == "error"),
            "workers": len(self.procs),
            "snapshots": len(snaps),
            "fleet_compiles": state_counter_total(
                state, "serve_executable_cache_compiles_total"),
            "fleet_aot_hits": state_counter_total(
                state, "serve_executable_cache_aot_hits_total"),
            "solves_per_sec": 0.0,
            "p50_latency_s": lat[len(lat) // 2] if lat else 0.0,
            "p95_latency_s": lat[int(len(lat) * 0.95)] if lat else 0.0,
        }
        if specs:
            out["slo"] = evaluate_results(specs, results)
        return out

    def run(self, requests, elog=None) -> Dict[str, Any]:
        from sagecal_tpu_torch.obs.slo import load_slo_specs

        t0 = self.clock()
        os.makedirs(self.cfg.out_dir, exist_ok=True)
        specs = {}
        if self.cfg.slo:
            specs = load_slo_specs(self.cfg.slo)
        elif self.cfg.requests and os.path.exists(self.cfg.requests):
            specs = load_slo_specs(self.cfg.requests)
        seed_queue(self.queue, requests, specs,
                   large_stations=self.cfg.large_stations,
                   log=self.log, open_file=self.open_file)
        if elog is not None:
            elog.emit("fleet_seeded", n=len(requests),
                      queue=self.queue.root,
                      workers=self.cfg.workers)
        self.setup_observability(specs=specs, elog=elog)
        try:
            self.spawn_workers()
            drained = self.watch()
        finally:
            self.shutdown()
            self.close_observability()
        summary = self.summary(requests)
        summary["drained"] = drained
        summary["wall_s"] = self.clock() - t0
        solved = summary["manifests"] - summary["shed"] - summary["errors"]
        summary["solves_per_sec"] = solved / max(summary["wall_s"], 1e-9)
        if elog is not None:
            elog.emit("fleet_done", **{
                k: v for k, v in summary.items() if k != "slo"})
        self.log(
            f"fleet: {summary['done']}/{summary['requests']} done "
            f"({summary['shed']} shed, {summary['degraded']} degraded, "
            f"{summary['errors']} errors) in {summary['wall_s']:.1f}s; "
            f"{summary['fleet_compiles']:g} kernel builds / "
            f"{summary['fleet_aot_hits']:g} store hits fleet-wide")
        return summary
