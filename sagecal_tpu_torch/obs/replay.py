"""Deterministic fleet-state replay from production telemetry
(counterpart of ``sagecal_tpu/obs/replay.py``, a copy of its stdlib code).

Reconstructs what a finished (or killed) fleet/load run actually did —
queue contents by state, lease epoch chains, per-worker lifecycle,
per-request dispositions and span trees, SLO attainment — purely from
the on-disk records of the run, read through the validating ledger
(obs/ledger.py).  Nothing here consults live state: the replay is a
pure function of the record files, so two readers of the same out-dir
always reconstruct the same fleet.

Clock model: every writer (coordinator/loadgen process, each worker)
stamps records with its OWN wall clock, and wall clocks step and skew.
Instead of trusting them, the replay estimates a per-clock-domain
offset from happens-before edges that are true by construction:

- enqueue -> first lease claim of the item   (coordinator -> worker)
- seed/spawn -> the worker's first record    (coordinator -> worker)
- a worker's last record -> ``fleet_done``   (worker -> coordinator)

Each edge ``a -> b`` bounds the writer offsets: with true time
``T = t + off(domain)``, ``off(A) - off(B) <= t_b - t_a``.  Folding
every edge against the reference domain (the coordinator) yields a
feasible interval ``[lo, hi]`` per domain; the estimate is the
in-interval value closest to zero.  An empty interval, or an estimate
beyond the audit's skew bound, is evidence of a stepped/forged clock —
the ``clock_skew`` violation in obs/audit.py.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Tuple

from sagecal_tpu_torch.obs import ledger

#: request dispositions the conservation law sums over
SERVED, SHED, FAILED, PENDING = "served", "shed", "failed", "pending"


def domain_of(writer: Optional[str]) -> Optional[str]:
    """A writer identity's clock domain (``w0@1234`` -> ``w0``): one
    wall clock per process; respawns of a worker share its name and,
    on one host, its clock."""
    if not isinstance(writer, str) or not writer:
        return None
    return writer.split("@", 1)[0]


# ----------------------------------------------------------- raw records


@dataclasses.dataclass
class RunRecords:
    """Every validated record of one run, grouped by family."""

    out_dir: str
    scan: ledger.OutDirScan
    events: List[dict]
    spans: List[dict]
    timeline: List[dict]
    drift: List[dict]
    manifests: List[dict]
    items: Dict[str, dict]                       # rid -> item doc
    leases: Dict[str, List[Tuple[int, dict]]]    # rid -> [(epoch, doc)]
    done: Dict[str, dict]                        # rid -> done doc
    fails: Dict[str, List[dict]]                 # rid -> fail docs
    metrics: List[dict]
    load_steps: Optional[dict]
    flight_dumps: List[dict]

    def all_files(self) -> List[ledger.ValidatedFile]:
        return list(self.scan.files)


def _parse_lease_name(base: str) -> Optional[Tuple[str, int]]:
    """``lease-<rid>.e<NNNNNN>.json`` -> (rid, epoch)."""
    if not (base.startswith("lease-") and base.endswith(".json")):
        return None
    stem = base[len("lease-"):-len(".json")]
    rid, sep, ep = stem.rpartition(".e")
    if not sep or not ep.isdigit():
        return None
    return rid, int(ep)


def load_run(out_dir: str, events_path: Optional[str] = None,
             queue_dir: Optional[str] = None) -> RunRecords:
    """Read + classify every record of a run.  ``events_path`` /
    ``queue_dir`` override the defaults (``<out_dir>/sagecal_events.
    jsonl`` + per-process companions, ``<out_dir>/queue``)."""
    from sagecal_tpu_torch.obs.events import expand_event_paths

    queue_dir = queue_dir or os.path.join(out_dir, "queue")
    extra: List[str] = []
    ev_default = events_path or os.path.join(out_dir,
                                             "sagecal_events.jsonl")
    extra.extend(expand_event_paths(ev_default))
    if os.path.isdir(queue_dir) and not os.path.abspath(
            queue_dir).startswith(os.path.abspath(out_dir) + os.sep):
        for n in sorted(os.listdir(queue_dir)):
            extra.append(os.path.join(queue_dir, n))
    scan = ledger.scan_out_dir(out_dir, extra_paths=extra)

    events = scan.ok_records("event")
    events.sort(key=lambda e: (float(e.get("ts", 0.0))))
    spans = scan.ok_records("span")
    timeline = scan.ok_records("timeline")
    timeline.sort(key=lambda r: (r.get("seq", -1), float(r.get("ts", 0.0))))
    drift = scan.ok_records("drift")
    manifests = scan.ok_records("result_manifest")
    metrics = scan.ok_records("metrics_snapshot")
    steps = scan.ok_records("load_steps")
    dumps = scan.ok_records("flight_dump")

    items: Dict[str, dict] = {}
    for doc in scan.ok_records("queue_item"):
        items[str(doc["request_id"])] = doc
    done: Dict[str, dict] = {}
    for doc in scan.ok_records("queue_done"):
        done[str(doc["request_id"])] = doc
    fails: Dict[str, List[dict]] = {}
    for doc in scan.ok_records("queue_fail"):
        fails.setdefault(str(doc["request_id"]), []).append(doc)
    leases: Dict[str, List[Tuple[int, dict]]] = {}
    for vf in scan.by_family("queue_lease"):
        parsed = _parse_lease_name(os.path.basename(vf.path))
        for doc in vf.ok:
            rid = str(doc.get("request_id", ""))
            epoch = parsed[1] if parsed else -1
            if parsed and parsed[0] != rid:
                # keep it, the auditor flags the mismatch
                pass
            leases.setdefault(rid or (parsed[0] if parsed else "?"),
                              []).append((epoch, doc))
    for chain in leases.values():
        chain.sort(key=lambda t: t[0])

    return RunRecords(
        out_dir=out_dir, scan=scan, events=events, spans=spans,
        timeline=timeline, drift=drift, manifests=manifests,
        items=items, leases=leases, done=done, fails=fails,
        metrics=metrics, load_steps=steps[0] if steps else None,
        flight_dumps=dumps)


# ------------------------------------------------------- clock estimation


@dataclasses.dataclass
class ClockEstimate:
    """One clock domain's offset bounds relative to the reference
    domain (add ``est`` to the domain's timestamps to translate them
    into reference time)."""

    domain: str
    lo: float = -math.inf
    hi: float = math.inf
    edges: int = 0
    feasible: bool = True

    @property
    def est(self) -> float:
        if not self.feasible:
            # midpoint of the (inverted) bounds: the least-bad guess
            return 0.5 * (self.lo + self.hi)
        lo = self.lo if self.lo != -math.inf else None
        hi = self.hi if self.hi != math.inf else None
        if lo is not None and lo > 0:
            return lo
        if hi is not None and hi < 0:
            return hi
        return 0.0


def _first_last_event_ts(events: List[dict]) -> Dict[str, Tuple[float, float]]:
    out: Dict[str, Tuple[float, float]] = {}
    for e in events:
        d = domain_of(e.get("writer"))
        ts = e.get("ts")
        if d is None or not isinstance(ts, (int, float)):
            continue
        lo, hi = out.get(d, (math.inf, -math.inf))
        out[d] = (min(lo, float(ts)), max(hi, float(ts)))
    return out


def estimate_clocks(rec: RunRecords) -> Tuple[str, Dict[str, ClockEstimate], List[str]]:
    """Per-domain clock offsets from happens-before edges; returns
    ``(reference_domain, {domain: estimate}, anomalies)`` where
    anomalies are same-domain records observed out of happens-before
    order (a clock stepping backwards inside one writer)."""
    # reference domain: the timeline writer (coordinator samples it),
    # else the coordinator/loadgen run_manifest, else the most common
    # event writer
    ref: Optional[str] = None
    for row in rec.timeline:
        ref = domain_of(row.get("writer")) or ref
        if ref:
            break
    if ref is None:
        for e in rec.events:
            if e.get("type") == "run_manifest":
                role = (e.get("extra") or {}).get("role", "")
                if role in ("coordinator", "loadgen"):
                    ref = domain_of(e.get("writer"))
                    break
    if ref is None:
        counts: Dict[str, int] = {}
        for e in rec.events:
            d = domain_of(e.get("writer"))
            if d:
                counts[d] = counts.get(d, 0) + 1
        ref = max(counts, key=counts.get) if counts else "coordinator"

    clocks: Dict[str, ClockEstimate] = {}
    anomalies: List[str] = []

    def clock(domain: str) -> ClockEstimate:
        if domain not in clocks:
            clocks[domain] = ClockEstimate(domain=domain)
        return clocks[domain]

    def edge(dom_a: Optional[str], t_a, dom_b: Optional[str], t_b,
             label: str) -> None:
        """Happens-before ``a -> b``: off(A) - off(B) <= t_b - t_a."""
        if (dom_a is None or dom_b is None
                or not isinstance(t_a, (int, float))
                or not isinstance(t_b, (int, float))):
            return
        t_a, t_b = float(t_a), float(t_b)
        if dom_a == dom_b:
            if t_a > t_b + 1e-3:
                anomalies.append(
                    f"{label}: same-writer order inverted in domain "
                    f"{dom_a} ({t_a:.3f} > {t_b:.3f})")
            return
        if dom_a == ref:
            c = clock(dom_b)
            c.lo = max(c.lo, t_a - t_b)
            c.edges += 1
        elif dom_b == ref:
            c = clock(dom_a)
            c.hi = min(c.hi, t_b - t_a)
            c.edges += 1

    # enqueue -> first claim / first recorded processing of the item
    for rid, item in rec.items.items():
        enq = item.get("enqueued_at")
        chain = rec.leases.get(rid, [])
        if chain:
            _, first = chain[0]
            edge(ref, enq, domain_of(first.get("worker")),
                 first.get("acquired_at"), f"enqueue->claim {rid}")
        d = rec.done.get(rid)
        if d is not None:
            edge(ref, enq, domain_of(d.get("worker")),
                 d.get("completed_at"), f"enqueue->done {rid}")
    # claim -> manifest commit (same worker: sanity; cross: bound)
    mf_by_rid = {str(m.get("request_id")): m for m in rec.manifests}
    for rid, d in rec.done.items():
        m = mf_by_rid.get(rid)
        if m is not None:
            edge(domain_of(d.get("worker")), m.get("started_at"),
                 domain_of(d.get("worker")), m.get("completed_at"),
                 f"solve->manifest {rid}")
    # seed -> each worker's first record; worker's last -> fleet_done
    seeded_ts = None
    done_ts = None
    for e in rec.events:
        if e.get("type") == "fleet_seeded" and seeded_ts is None:
            seeded_ts = e.get("ts")
        if e.get("type") == "fleet_done":
            done_ts = e.get("ts")
    spans_fl = _first_last_event_ts(rec.events)
    for dom, (first_ts, last_ts) in spans_fl.items():
        if dom == ref:
            continue
        if seeded_ts is not None:
            edge(ref, seeded_ts, dom, first_ts, f"spawn->first {dom}")
        if done_ts is not None:
            edge(dom, last_ts, ref, done_ts, f"last->fleet_done {dom}")
    clock(ref).lo, clock(ref).hi = 0.0, 0.0

    for c in clocks.values():
        if c.lo > c.hi + 1e-3:
            c.feasible = False
    return ref, clocks, anomalies


# --------------------------------------------------------------- replay


@dataclasses.dataclass
class RequestReplay:
    """One request's reconstructed lifecycle."""

    request_id: str
    tenant: str = ""
    state: str = PENDING          # served | shed | failed | pending
    sub_state: str = ""           # pending detail: waiting|leased|expired
    verdict: str = ""
    worker: str = ""
    enqueued_at: float = 0.0
    started_at: Optional[float] = None
    completed_at: Optional[float] = None
    latency_s: Optional[float] = None
    deadline: Optional[float] = None
    trace_id: str = ""
    epochs: int = 0
    manifest_count: int = 0
    has_done_marker: bool = False
    attempts_failed: int = 0


@dataclasses.dataclass
class ReplayState:
    """The reconstructed fleet, plus everything the auditor gates on."""

    out_dir: str
    reference_domain: str
    requests: Dict[str, RequestReplay]
    counts: Dict[str, int]
    queue_counts: Dict[str, int]
    workers: Dict[str, Dict[str, Any]]
    clocks: Dict[str, ClockEstimate]
    clock_anomalies: List[str]
    slo: Dict[str, Any]
    now: float
    records: RunRecords

    def to_doc(self) -> Dict[str, Any]:
        return {
            "out_dir": self.out_dir,
            "reference_domain": self.reference_domain,
            "now": self.now,
            "counts": dict(self.counts),
            "queue_counts": dict(self.queue_counts),
            "requests": {rid: dataclasses.asdict(r)
                         for rid, r in sorted(self.requests.items())},
            "workers": self.workers,
            "clocks": {d: {"lo": None if c.lo == -math.inf else c.lo,
                           "hi": None if c.hi == math.inf else c.hi,
                           "est": c.est, "edges": c.edges,
                           "feasible": c.feasible}
                       for d, c in sorted(self.clocks.items())},
            "clock_anomalies": list(self.clock_anomalies),
            "slo": self.slo,
        }


def _verdict_state(verdict: str) -> str:
    if verdict == "shed":
        return SHED
    if verdict == "error":
        return FAILED
    return SERVED


def replay(rec: RunRecords, now: Optional[float] = None) -> ReplayState:
    """Reconstruct the fleet purely from ``rec``.  ``now`` fixes the
    instant pending leases are judged against (default: the latest
    reference-translated timestamp observed anywhere in the run)."""
    ref, clocks, anomalies = estimate_clocks(rec)

    def translate(dom: Optional[str], t) -> Optional[float]:
        if not isinstance(t, (int, float)):
            return None
        off = clocks[dom].est if dom in clocks else 0.0
        return float(t) + off

    # latest observed instant (reference time) = replay "now"
    latest = 0.0
    for e in rec.events:
        t = translate(domain_of(e.get("writer")), e.get("ts"))
        latest = max(latest, t or 0.0)
    for row in rec.timeline:
        latest = max(latest, float(row.get("ts", 0.0)))
    for m in rec.manifests:
        rid = str(m.get("request_id"))
        dom = domain_of((rec.done.get(rid) or {}).get("worker"))
        t = translate(dom, m.get("completed_at"))
        latest = max(latest, t or 0.0)
    for chain in rec.leases.values():
        for _, doc in chain:
            t = translate(domain_of(doc.get("worker")),
                          doc.get("renewed_at"))
            latest = max(latest, t or 0.0)
    for item in rec.items.values():
        latest = max(latest, float(item.get("enqueued_at") or 0.0))
    if now is None:
        now = latest

    mf_by_rid: Dict[str, List[dict]] = {}
    for m in rec.manifests:
        mf_by_rid.setdefault(str(m.get("request_id")), []).append(m)

    requests: Dict[str, RequestReplay] = {}
    queue_counts = {"items": 0, "done": 0, "waiting": 0, "leased": 0,
                    "expired_leases": 0}
    for rid, item in sorted(rec.items.items()):
        r = RequestReplay(
            request_id=rid, tenant=str(item.get("tenant", "")),
            enqueued_at=float(item.get("enqueued_at") or 0.0),
            deadline=item.get("deadline"))
        chain = rec.leases.get(rid, [])
        r.epochs = len(chain)
        mfs = mf_by_rid.get(rid, [])
        r.manifest_count = len(mfs)
        r.has_done_marker = rid in rec.done
        r.attempts_failed = len(rec.fails.get(rid, []))
        queue_counts["items"] += 1
        if mfs:
            m = mfs[0]
            r.verdict = str(m.get("verdict", ""))
            r.state = _verdict_state(r.verdict)
            r.started_at = m.get("started_at")
            r.completed_at = m.get("completed_at")
            r.latency_s = m.get("latency_s")
            r.trace_id = str(m.get("trace_id", "") or "")
            r.worker = str((rec.done.get(rid) or {}).get("worker", ""))
        elif rid in rec.done:
            # done marker without a manifest: the auditor flags it;
            # replay counts it as served so the disposition total still
            # reflects the queue's view
            d = rec.done[rid]
            r.state = _verdict_state(str(d.get("verdict", "")))
            r.verdict = str(d.get("verdict", ""))
            r.completed_at = d.get("completed_at")
            r.worker = str(d.get("worker", ""))
        else:
            r.state = PENDING
            if chain:
                epoch, head = chain[-1]
                dom = domain_of(head.get("worker"))
                exp = translate(dom, head.get("expires_at"))
                if head.get("expires_at", 0.0) == 0.0:
                    # released: immediately claimable, but the queue's
                    # live stats() buckets a surviving head as expired
                    r.sub_state = "expired"
                elif exp is not None and exp > now:
                    r.sub_state = "leased"
                else:
                    r.sub_state = "expired"
                r.worker = str(head.get("worker", ""))
            else:
                r.sub_state = "waiting"
        requests[rid] = r
        if rid in rec.done:
            queue_counts["done"] += 1
        elif r.sub_state == "leased":
            queue_counts["leased"] += 1
        elif r.sub_state == "expired":
            queue_counts["expired_leases"] += 1
        else:
            queue_counts["waiting"] += 1

    counts = {"enqueued": len(requests), SERVED: 0, SHED: 0,
              FAILED: 0, PENDING: 0}
    for r in requests.values():
        counts[r.state] += 1

    # per-worker lifecycle from events + metrics snapshots
    workers: Dict[str, Dict[str, Any]] = {}

    def worker(name: str) -> Dict[str, Any]:
        return workers.setdefault(name, {
            "pids": [], "claims": 0, "first_ts": None, "last_ts": None,
            "events": 0, "done_summary": None, "respawns": 0})

    for e in rec.events:
        w = e.get("writer")
        dom = domain_of(w)
        role_worker = isinstance(dom, str) and dom != ref
        if role_worker:
            wk = worker(dom)
            wk["events"] += 1
            ts = e.get("ts")
            if isinstance(ts, (int, float)):
                if wk["first_ts"] is None:
                    wk["first_ts"] = float(ts)
                wk["last_ts"] = float(ts)
            if isinstance(w, str) and "@" in w:
                pid = w.rsplit("@", 1)[1]
                if pid not in wk["pids"]:
                    wk["pids"].append(pid)
        t = e.get("type")
        if t == "fleet_claimed":
            worker(str(e.get("worker", dom or "?")))["claims"] += (
                int(e.get("n", 1) or 1))
        elif t == "fleet_worker_done":
            worker(str(e.get("worker", dom or "?")))["done_summary"] = {
                k: e.get(k) for k in ("cycles", "solved", "wall_s")}
        elif t == "worker_respawned":
            worker(str(e.get("worker", "?")))["respawns"] += 1
    for snap in rec.metrics:
        wk = worker(str(snap.get("worker_id", "?")))
        wk["snapshot_ts"] = snap.get("ts")

    # SLO attainment, replayed from the manifests alone (sheds are
    # refusals, not latency samples — the anti-latch rule)
    lat = sorted(float(r.latency_s) for r in requests.values()
                 if r.state == SERVED and isinstance(r.latency_s,
                                                     (int, float)))
    breaches = 0
    judged = 0
    for r in requests.values():
        if r.state != SERVED or r.deadline in (None, 0):
            continue
        dom = domain_of(rec.done.get(r.request_id, {}).get("worker"))
        ct = translate(dom, r.completed_at)
        if ct is None:
            continue
        judged += 1
        if ct > float(r.deadline):
            breaches += 1
    slo = {
        "served": counts[SERVED], "shed": counts[SHED],
        "failed": counts[FAILED],
        "p50_latency_s": lat[len(lat) // 2] if lat else None,
        "p95_latency_s": lat[min(len(lat) - 1,
                                 int(0.95 * len(lat)))] if lat else None,
        "deadline_judged": judged, "deadline_breaches": breaches,
        "deadline_attainment": (1.0 - breaches / judged) if judged
        else None,
    }

    return ReplayState(
        out_dir=rec.out_dir, reference_domain=ref, requests=requests,
        counts=counts, queue_counts=queue_counts, workers=workers,
        clocks=clocks, clock_anomalies=anomalies, slo=slo,
        now=float(now), records=rec)


def format_replay(state: ReplayState, verbose: bool = False) -> str:
    """Human-readable reconstruction (the ``diag replay`` body)."""
    lines: List[str] = []
    c = state.counts
    lines.append(f"replayed fleet state: {state.out_dir}")
    lines.append(
        f"  requests: {c['enqueued']} enqueued = {c[SERVED]} served "
        f"+ {c[SHED]} shed + {c[FAILED]} failed + {c[PENDING]} pending")
    q = state.queue_counts
    lines.append(
        f"  queue:    {q['items']} items, {q['done']} done, "
        f"{q['waiting']} waiting, {q['leased']} leased, "
        f"{q['expired_leases']} expired")
    for name in sorted(state.workers):
        w = state.workers[name]
        pids = ",".join(w["pids"]) or "-"
        summary = w.get("done_summary") or {}
        lines.append(
            f"  worker {name}: pids [{pids}] claims={w['claims']} "
            f"events={w['events']} respawns={w['respawns']}"
            + (f" solved={summary.get('solved')}" if summary else ""))
    lines.append(f"  clock reference: {state.reference_domain}")
    for dom in sorted(state.clocks):
        cl = state.clocks[dom]
        if dom == state.reference_domain:
            continue
        lo = "-inf" if cl.lo == -math.inf else f"{cl.lo:+.3f}"
        hi = "+inf" if cl.hi == math.inf else f"{cl.hi:+.3f}"
        flag = "" if cl.feasible else "  INFEASIBLE"
        lines.append(f"    {dom}: offset in [{lo}, {hi}] s, "
                     f"est {cl.est:+.3f} s ({cl.edges} edges){flag}")
    for a in state.clock_anomalies:
        lines.append(f"    anomaly: {a}")
    s = state.slo
    att = s["deadline_attainment"]
    lines.append(
        "  slo:      p50="
        + (f"{s['p50_latency_s']:.3f}s" if s["p50_latency_s"] is not None
           else "-")
        + " p95="
        + (f"{s['p95_latency_s']:.3f}s" if s["p95_latency_s"] is not None
           else "-")
        + f" deadline attainment "
        + (f"{att:.1%} ({s['deadline_judged']} judged)" if att is not None
           else "- (no deadlines judged)"))
    if verbose:
        for rid in sorted(state.requests):
            r = state.requests[rid]
            lines.append(
                f"    {rid}: {r.state}"
                + (f"/{r.sub_state}" if r.sub_state else "")
                + (f" verdict={r.verdict}" if r.verdict else "")
                + (f" worker={r.worker}" if r.worker else "")
                + f" epochs={r.epochs} manifests={r.manifest_count}")
    return "\n".join(lines)
