"""Conservation-law auditing of a replayed fleet run (counterpart of
``sagecal_tpu/obs/audit.py``, a copy of its stdlib code).

Takes the deterministic reconstruction from obs/replay.py and asserts
the global invariants that MUST hold if the run's telemetry is complete
and truthful:

==========================  ===========================================
violation kind              invariant
==========================  ===========================================
``torn_record``             no unparseable lines in any record file
                            (every shipped emitter writes one line per
                            ``os.write`` on an O_APPEND fd, or stages
                            through tmp+rename — torn lines cannot
                            happen without a writer bug or tampering)
``foreign_record``          every line belongs to its file's family
``out_of_schema``           every record carries its family's required
                            keys and a known schema version
``conservation``            enqueued == served + shed + failed + pending
``forged_manifest``         exactly one result manifest per request,
                            each matching a queued item and its done
                            marker
``lease_epoch``             surviving lease chains strictly monotonic +
                            contiguous, steals only after genuine TTL
                            expiry (in skew-corrected time)
``span_chain``              every manifest trace_id resolves to a
                            complete lifecycle span chain (evaluated
                            when the run traced)
``counter_regression``      cumulative timeline counters never decrease
``timeline_bounds``         sampled depth rows stay inside the bounds
                            the replayed queue admits around each
                            sample instant
``clock_skew``              per-writer clock offsets feasible and
                            within the skew bound
``sequence_hole``           per-writer record sequences have no gaps
``observability_gap``       no unregistered record files, no missing
                            load-bearing event kinds
==========================  ===========================================

Exit codes (``diag audit``): 0 all invariants hold, 1 any violation or
gap, 2 insufficient records to audit (no queue items found — nothing to
conserve).

``SAGECAL_AUDIT_INJECT=drop_event|tear_record|forge_manifest|
skew_clock`` perturbs the loaded records IN MEMORY before checking (the
files are never touched), proving each detector actually detects; the
pinned kinds are in :data:`INJECTION_KINDS`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

from sagecal_tpu_torch.obs import ledger
from sagecal_tpu_torch.obs.replay import (
    FAILED, PENDING, SERVED, SHED, ReplayState, RunRecords, domain_of,
    format_replay, load_run, replay,
)

# pinned violation kinds
KIND_TORN = "torn_record"
KIND_FOREIGN = "foreign_record"
KIND_OUT_OF_SCHEMA = "out_of_schema"
KIND_CONSERVATION = "conservation"
KIND_FORGED_MANIFEST = "forged_manifest"
KIND_LEASE_EPOCH = "lease_epoch"
KIND_SPAN_CHAIN = "span_chain"
KIND_COUNTER_REGRESSION = "counter_regression"
KIND_TIMELINE_BOUNDS = "timeline_bounds"
KIND_CLOCK_SKEW = "clock_skew"
KIND_SEQUENCE_HOLE = "sequence_hole"
KIND_GAP = "observability_gap"

#: fault-injection arm -> the violation kind it must produce
INJECTION_KINDS = {
    "drop_event": KIND_SEQUENCE_HOLE,
    "tear_record": KIND_TORN,
    "forge_manifest": KIND_FORGED_MANIFEST,
    "skew_clock": KIND_CLOCK_SKEW,
}

#: exit codes (diag audit / diag replay)
EXIT_OK = 0
EXIT_VIOLATION = 1
EXIT_INSUFFICIENT = 2


@dataclasses.dataclass
class Violation:
    kind: str
    subject: str
    message: str

    def render(self) -> str:
        return f"VIOLATION [{self.kind}] {self.subject}: {self.message}"


@dataclasses.dataclass
class AuditReport:
    out_dir: str
    state: Optional[ReplayState]
    violations: List[Violation]
    checks: List[Dict[str, Any]]     # {name, status, detail}
    insufficient: bool = False
    insufficient_reason: str = ""
    injected: str = ""

    @property
    def ok(self) -> bool:
        return not self.violations and not self.insufficient

    def exit_code(self) -> int:
        if self.insufficient:
            return EXIT_INSUFFICIENT
        return EXIT_OK if not self.violations else EXIT_VIOLATION

    def kinds(self) -> List[str]:
        return sorted({v.kind for v in self.violations})

    def to_doc(self) -> Dict[str, Any]:
        return {
            "out_dir": self.out_dir,
            "ok": self.ok,
            "exit_code": self.exit_code(),
            "insufficient": self.insufficient,
            "insufficient_reason": self.insufficient_reason,
            "injected": self.injected,
            "violations": [dataclasses.asdict(v)
                           for v in self.violations],
            "checks": self.checks,
            "replay": self.state.to_doc() if self.state else None,
        }


# ----------------------------------------------------------- injection


def apply_injection(rec: RunRecords, mode: str) -> str:
    """Perturb the loaded records in memory (never the files) so the
    auditor can prove its detectors fire.  Returns a note describing
    what was injected."""
    if mode == "drop_event":
        # drop a mid-sequence event from the busiest writer: a lost
        # record in the middle of a stream leaves a sequence hole
        by_writer: Dict[str, List[dict]] = {}
        for e in rec.events:
            w = e.get("writer")
            if isinstance(w, str) and isinstance(e.get("seq"), int):
                by_writer.setdefault(w, []).append(e)
        best = max(by_writer.values(), key=len, default=None)
        if not best or len(best) < 3:
            return "drop_event: no writer with >=3 sequenced events"
        best.sort(key=lambda e: e["seq"])
        victim = best[len(best) // 2]
        rec.events.remove(victim)
        return (f"drop_event: removed seq={victim['seq']} of "
                f"{victim['writer']}")
    if mode == "tear_record":
        # reclassify the tail record of the first event file as torn —
        # exactly what a mid-write crash of a buggy buffered writer
        # would leave behind
        for vf in rec.scan.files:
            if vf.family == "event" and vf.records:
                tail = vf.records[-1]
                tail.status = ledger.TORN
                tail.reason = "injected: line truncated mid-write"
                if tail.record in rec.events:
                    rec.events.remove(tail.record)
                tail.record = None
                return f"tear_record: tore tail line of {vf.path}"
        return "tear_record: no event file to tear"
    if mode == "forge_manifest":
        if not rec.manifests:
            return "forge_manifest: no manifest to forge"
        forged = dict(rec.manifests[0])
        forged["request_id"] = f"{forged.get('request_id')}~forged"
        rec.manifests.append(forged)
        return (f"forge_manifest: duplicated manifest under forged id "
                f"{forged['request_id']}")
    if mode == "skew_clock":
        # step one worker domain's event clock back 3 minutes
        doms = sorted({domain_of(d.get("worker"))
                       for d in rec.done.values()} - {None})
        if not doms:
            doms = sorted({domain_of(e.get("writer"))
                           for e in rec.events} - {None})
        if not doms:
            return "skew_clock: no writer domain to skew"
        victim = doms[0]
        shifted = 0
        for e in rec.events:
            if domain_of(e.get("writer")) == victim and isinstance(
                    e.get("ts"), (int, float)):
                e["ts"] = float(e["ts"]) + 180.0
                shifted += 1
        return (f"skew_clock: stepped {victim} events +180s "
                f"({shifted} records)")
    raise ValueError(
        f"unknown SAGECAL_AUDIT_INJECT mode {mode!r} "
        f"(known: {', '.join(sorted(INJECTION_KINDS))})")


# ------------------------------------------------------------- checks


def _check(checks: List[Dict[str, Any]], name: str, status: str,
           detail: str = "") -> None:
    checks.append({"name": name, "status": status, "detail": detail})


def _monotone_counters(state: ReplayState, vs: List[Violation]) -> str:
    rows = state.records.timeline
    keys = ("items", "done", "results_total", "shed_total",
            "error_total", "aot_store_entries")
    by_writer: Dict[str, List[dict]] = {}
    for r in rows:
        by_writer.setdefault(str(r.get("writer", "")), []).append(r)
    bad = 0
    for w, ws in by_writer.items():
        ws.sort(key=lambda r: (r.get("seq", -1), float(r.get("ts", 0))))
        last: Dict[str, float] = {}
        for i, r in enumerate(ws):
            for k in keys:
                v = r.get(k)
                if not isinstance(v, (int, float)):
                    continue
                if k in last and v < last[k]:
                    bad += 1
                    vs.append(Violation(
                        KIND_COUNTER_REGRESSION, f"timeline[{i}]",
                        f"{k} regressed {last[k]} -> {v} "
                        f"(writer {w or '?'})"))
                last[k] = float(v)
    return f"{len(rows)} rows, {bad} regressions"


def _timeline_bounds(state: ReplayState, slack_s: float,
                     vs: List[Violation]) -> str:
    rec = state.records
    rows = rec.timeline
    if not rows:
        return "no timeline rows"
    enq_ts = sorted(float(i.get("enqueued_at") or 0.0)
                    for i in rec.items.values())
    done_ts = []
    for rid, d in rec.done.items():
        dom = domain_of(d.get("worker"))
        off = state.clocks[dom].est if dom in state.clocks else 0.0
        t = d.get("completed_at")
        if isinstance(t, (int, float)):
            done_ts.append(float(t) + off)
    done_ts.sort()

    import bisect

    def counts_at(ts: float) -> tuple:
        return (bisect.bisect_right(enq_ts, ts),
                bisect.bisect_right(done_ts, ts))

    bad = 0
    for i, row in enumerate(rows):
        ts = float(row.get("ts", 0.0))
        lo_e, lo_d = counts_at(ts - slack_s)
        hi_e, hi_d = counts_at(ts + slack_s)
        items, done = row.get("items"), row.get("done")
        if isinstance(items, int) and not (lo_e <= items <= hi_e):
            bad += 1
            vs.append(Violation(
                KIND_TIMELINE_BOUNDS, f"timeline[{i}]",
                f"items={items} outside replayed [{lo_e}, {hi_e}] "
                f"at ts={ts:.3f}±{slack_s:.1f}s"))
        if isinstance(done, int) and not (lo_d <= done <= hi_d):
            bad += 1
            vs.append(Violation(
                KIND_TIMELINE_BOUNDS, f"timeline[{i}]",
                f"done={done} outside replayed [{lo_d}, {hi_d}] "
                f"at ts={ts:.3f}±{slack_s:.1f}s"))
    return f"{len(rows)} rows within ±{slack_s:.1f}s bounds, {bad} out"


def _lease_epochs(state: ReplayState, slack_s: float,
                  vs: List[Violation]) -> str:
    rec = state.records
    chains = 0
    for rid, chain in sorted(rec.leases.items()):
        if not chain:
            continue
        chains += 1
        epochs = [ep for ep, _ in chain]
        if len(set(epochs)) != len(epochs):
            vs.append(Violation(
                KIND_LEASE_EPOCH, rid,
                f"duplicate lease epochs {epochs}"))
            continue
        if epochs != list(range(epochs[0], epochs[0] + len(epochs))):
            vs.append(Violation(
                KIND_LEASE_EPOCH, rid,
                f"epoch chain not contiguous/monotonic: {epochs}"))
        for (ep_a, a), (ep_b, b) in zip(chain, chain[1:]):
            if str(a.get("request_id")) != rid or str(
                    b.get("request_id")) != rid:
                vs.append(Violation(
                    KIND_LEASE_EPOCH, rid,
                    f"lease doc request_id mismatch in epoch "
                    f"{ep_a}/{ep_b}"))
            if a.get("worker") == b.get("worker"):
                continue
            # a steal: only legitimate after the previous epoch's
            # lease genuinely expired (or was released), judged in
            # skew-corrected time
            exp = a.get("expires_at")
            if exp == 0.0:        # released — handover is free
                continue
            dom_a = domain_of(a.get("worker"))
            dom_b = domain_of(b.get("worker"))
            off_a = state.clocks[dom_a].est if dom_a in state.clocks else 0.0
            off_b = state.clocks[dom_b].est if dom_b in state.clocks else 0.0
            acq = b.get("acquired_at")
            if (isinstance(exp, (int, float))
                    and isinstance(acq, (int, float))
                    and float(exp) + off_a > float(acq) + off_b + slack_s):
                vs.append(Violation(
                    KIND_LEASE_EPOCH, rid,
                    f"epoch {ep_b} stolen by {b.get('worker')} "
                    f"{float(exp) + off_a - float(acq) - off_b:.3f}s "
                    f"before epoch {ep_a} ({a.get('worker')}) expired"))
    return f"{chains} surviving chains"


def _span_chains(state: ReplayState, vs: List[Violation]) -> str:
    rec = state.records
    if not rec.spans:
        return ""
    from sagecal_tpu_torch.obs.aggregate import lifecycle_report

    traced = [m for m in rec.manifests if m.get("trace_id")
              and str(m.get("verdict", "")) not in ("shed", "error")]
    rep = lifecycle_report(rec.spans, traced)
    for problem in rep["manifest_problems"]:
        vs.append(Violation(KIND_SPAN_CHAIN, "manifest", str(problem)))
    return (f"{rep['manifests_matched']}/{len(traced)} manifests with "
            f"complete chains, {rep['traces']} traces")


def run_audit(out_dir: str, events_path: Optional[str] = None,
              queue_dir: Optional[str] = None,
              max_skew_s: float = 30.0, slack_s: float = 3.0,
              inject: Optional[str] = None) -> AuditReport:
    """Load + replay + audit one run directory.  ``inject`` defaults to
    ``SAGECAL_AUDIT_INJECT``."""
    if inject is None:
        inject = os.environ.get("SAGECAL_AUDIT_INJECT", "").strip()
    rec = load_run(out_dir, events_path=events_path,
                   queue_dir=queue_dir)
    injected = apply_injection(rec, inject) if inject else ""

    vs: List[Violation] = []
    checks: List[Dict[str, Any]] = []

    if not rec.items:
        return AuditReport(
            out_dir=out_dir, state=None, violations=[], checks=checks,
            insufficient=True,
            insufficient_reason="no queue items found (nothing to "
            "conserve) — pass --queue if the queue dir lives outside "
            "the out-dir",
            injected=injected)

    state = replay(rec)

    # --- record hygiene: the validating reader's classifications
    counts = rec.scan.counts()
    for vf in rec.scan.files:
        for c in vf.records:
            where = f"{os.path.basename(vf.path)}:{c.line_no}"
            if c.status == ledger.TORN:
                vs.append(Violation(KIND_TORN, where, c.reason))
            elif c.status == ledger.FOREIGN:
                vs.append(Violation(KIND_FOREIGN, where,
                                    f"[{vf.family}] {c.reason}"))
            elif c.status == ledger.OUT_OF_SCHEMA:
                vs.append(Violation(KIND_OUT_OF_SCHEMA, where,
                                    f"[{vf.family}] {c.reason}"))
    _check(checks, "record-hygiene",
           "PASS" if counts[ledger.TORN] == counts[ledger.FOREIGN]
           == counts[ledger.OUT_OF_SCHEMA] == 0 else "FAIL",
           f"{counts[ledger.OK]} ok / {counts[ledger.TORN]} torn / "
           f"{counts[ledger.FOREIGN]} foreign / "
           f"{counts[ledger.OUT_OF_SCHEMA]} out-of-schema")

    # --- conservation: enqueued == served + shed + failed + pending
    c = state.counts
    total = c[SERVED] + c[SHED] + c[FAILED] + c[PENDING]
    if c["enqueued"] != total:
        vs.append(Violation(
            KIND_CONSERVATION, "queue",
            f"enqueued {c['enqueued']} != served {c[SERVED]} + shed "
            f"{c[SHED]} + failed {c[FAILED]} + pending {c[PENDING]}"))
    _check(checks, "conservation",
           "PASS" if c["enqueued"] == total else "FAIL",
           f"{c['enqueued']} = {c[SERVED]}+{c[SHED]}+{c[FAILED]}"
           f"+{c[PENDING]}")

    # --- manifest uniqueness / provenance
    n_mf = len(vs)
    by_rid: Dict[str, int] = {}
    for m in rec.manifests:
        by_rid[str(m.get("request_id"))] = by_rid.get(
            str(m.get("request_id")), 0) + 1
    for rid, n in sorted(by_rid.items()):
        if n > 1:
            vs.append(Violation(
                KIND_FORGED_MANIFEST, rid,
                f"{n} result manifests for one request"))
        if rid not in rec.items:
            vs.append(Violation(
                KIND_FORGED_MANIFEST, rid,
                "manifest has no queued item (forged or cross-run)"))
    for rid, d in sorted(rec.done.items()):
        if rid not in by_rid:
            vs.append(Violation(
                KIND_FORGED_MANIFEST, rid,
                f"done marker (worker {d.get('worker')}) without a "
                f"result manifest"))
    _check(checks, "manifest-uniqueness",
           "PASS" if len(vs) == n_mf else "FAIL",
           f"{len(by_rid)} manifested requests, {len(rec.done)} done "
           f"markers")

    # --- lease epoch chains
    n0 = len(vs)
    detail = _lease_epochs(state, slack_s, vs)
    _check(checks, "lease-epochs", "PASS" if len(vs) == n0 else "FAIL",
           detail)

    # --- span chains (only provable when the run traced)
    n0 = len(vs)
    detail = _span_chains(state, vs)
    if detail:
        _check(checks, "span-chains",
               "PASS" if len(vs) == n0 else "FAIL", detail)
    else:
        _check(checks, "span-chains", "SKIP",
               "no spans recorded (tracing off)")

    # --- counters monotone across resume
    n0 = len(vs)
    detail = _monotone_counters(state, vs)
    _check(checks, "counter-monotonicity",
           "PASS" if len(vs) == n0 else "FAIL", detail)

    # --- timeline depth rows inside replayed bounds
    n0 = len(vs)
    skew_pad = max((abs(cl.est) for cl in state.clocks.values()),
                   default=0.0)
    detail = _timeline_bounds(state, slack_s + skew_pad, vs)
    _check(checks, "timeline-bounds",
           "PASS" if len(vs) == n0 else "FAIL", detail)

    # --- clock skew
    n0 = len(vs)
    worst = 0.0
    for dom, cl in sorted(state.clocks.items()):
        if dom == state.reference_domain:
            continue
        worst = max(worst, abs(cl.est))
        if not cl.feasible:
            vs.append(Violation(
                KIND_CLOCK_SKEW, dom,
                f"happens-before constraints unsatisfiable "
                f"(offset lo {cl.lo:+.3f}s > hi {cl.hi:+.3f}s)"))
        elif abs(cl.est) > max_skew_s:
            vs.append(Violation(
                KIND_CLOCK_SKEW, dom,
                f"estimated clock offset {cl.est:+.3f}s exceeds "
                f"bound ±{max_skew_s:.1f}s"))
    for a in state.clock_anomalies:
        vs.append(Violation(KIND_CLOCK_SKEW, "same-writer", a))
    _check(checks, "clock-skew", "PASS" if len(vs) == n0 else "FAIL",
           f"max |offset| {worst:.3f}s over "
           f"{max(len(state.clocks) - 1, 0)} domains")

    # --- sequence holes
    n0 = len(vs)
    holes = ledger.sequence_holes(rec.events)
    for w, missing in sorted(holes.items()):
        head = ", ".join(str(i) for i in missing[:5])
        vs.append(Violation(
            KIND_SEQUENCE_HOLE, w,
            f"{len(missing)} missing seq number(s): {head}"
            + ("…" if len(missing) > 5 else "")))
    row_holes = ledger.sequence_holes(rec.timeline)
    for w, missing in sorted(row_holes.items()):
        vs.append(Violation(
            KIND_SEQUENCE_HOLE, f"timeline:{w}",
            f"{len(missing)} missing timeline seq number(s)"))
    _check(checks, "sequence-holes",
           "PASS" if len(vs) == n0 else "FAIL",
           f"{len(holes) + len(row_holes)} writers with holes")

    # --- observability gaps
    n0 = len(vs)
    for rel in rec.scan.unregistered:
        vs.append(Violation(
            KIND_GAP, rel,
            "record-looking file owned by no registered family "
            "(register it in obs/ledger.py or add it to "
            "IGNORED_PATTERNS)"))
    if not rec.events:
        vs.append(Violation(
            KIND_GAP, "events",
            "no event log found (run with SAGECAL_TELEMETRY=1, or "
            "pass --events)"))
    else:
        kinds = {e.get("type") for e in rec.events}
        expected = ["run_manifest"]
        if rec.done:
            expected.append("fleet_claimed")
        for k in expected:
            if k not in kinds:
                vs.append(Violation(
                    KIND_GAP, "events",
                    f"expected event kind {k!r} never observed"))
    _check(checks, "observability-gaps",
           "PASS" if len(vs) == n0 else "FAIL",
           f"{len(rec.scan.unregistered)} unregistered files, "
           f"{len(rec.events)} events")

    return AuditReport(out_dir=out_dir, state=state, violations=vs,
                       checks=checks, injected=injected)


def format_audit(report: AuditReport, verbose: bool = False) -> str:
    lines: List[str] = [f"fleet audit: {report.out_dir}"]
    if report.injected:
        lines.append(f"  injected fault: {report.injected}")
    if report.insufficient:
        lines.append(f"AUDIT: INSUFFICIENT RECORDS — "
                     f"{report.insufficient_reason}")
        return "\n".join(lines)
    if report.state is not None:
        lines.append(format_replay(report.state, verbose=verbose))
    lines.append("  invariants:")
    for ch in report.checks:
        lines.append(f"    {ch['name']:<22} {ch['status']:<4} "
                     f"{ch['detail']}")
    for v in report.violations:
        lines.append(v.render())
    if report.ok:
        lines.append("AUDIT: OK (zero conservation-law violations)")
    else:
        kinds = ", ".join(report.kinds())
        lines.append(
            f"AUDIT: {len(report.violations)} violation(s) [{kinds}]")
    return "\n".join(lines)
