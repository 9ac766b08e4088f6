"""The record-family schema registry + validating reader (counterpart of
``sagecal_tpu/obs/ledger.py``, a copy of its stdlib code).

The repo emits a dozen independent JSONL / JSON record families
(events, spans, timeline rows, drift ledger, lease/queue docs, result
manifests, metrics snapshots, load steps, flight dumps, bench history,
heartbeats).  Every ad-hoc reader so far silently SKIPS lines it cannot
parse — the right behaviour on the serving path, but fatal for an
auditor: a silently dropped line is exactly the evidence a post-mortem
needs.  This module is the single place that knows, for every family:

- which file names it lives under (``pattern``),
- the discriminator (``kind`` field) separating it from foreign lines,
- the required keys and the set of known schema versions,
- which field carries the writer identity and which orders records.

:func:`classify_line` / :func:`read_validated` classify every line as
one of

- ``ok``           — parses, right family, schema-complete
- ``torn``         — not valid JSON (truncated tail, interleaved write)
- ``foreign``      — valid JSON but another family's record (or not an
  object at all)
- ``out_of_schema`` — right family but missing required keys or an
  unknown schema version

instead of skipping, and :func:`scan_out_dir` maps every record-looking
file in a run directory to its family, flagging unregistered files for
the observability-gap report.  The replay engine (obs/replay.py) and
the conservation-law auditor (obs/audit.py) are built on these reads.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
from typing import Any, Dict, List, Optional, Tuple

#: registry version (bump when a family is added or re-shaped)
LEDGER_SCHEMA_VERSION = 1

OK = "ok"
TORN = "torn"
FOREIGN = "foreign"
OUT_OF_SCHEMA = "out_of_schema"
STATUSES = (OK, TORN, FOREIGN, OUT_OF_SCHEMA)


@dataclasses.dataclass(frozen=True)
class RecordFamily:
    """One registered record family: where it lives and what a valid
    record must carry."""

    name: str
    container: str               # "jsonl" (line-oriented) | "json"
    pattern: str                 # glob over the path relative to out-dir
    required: Tuple[str, ...]    # keys every valid record carries
    kind_field: str = ""         # discriminator field ("" = none)
    kind_value: str = ""
    version_field: str = ""      # schema-version field ("" = unversioned)
    known_versions: Tuple[int, ...] = ()
    writer_field: str = ""       # writer-identity field ("" = none)
    order_field: str = "ts"      # same-writer ordering key
    seq_field: str = ""          # per-writer sequence field, if stamped
    description: str = ""

    def matches(self, rel_path: str) -> bool:
        return fnmatch.fnmatch(rel_path.replace(os.sep, "/"), self.pattern)


#: every record family the repo emits, in discovery-priority order
#: (first pattern match wins in :func:`match_family`)
REGISTRY: Tuple[RecordFamily, ...] = (
    RecordFamily(
        name="event", container="jsonl",
        pattern="*events*.jsonl*",
        required=("ts", "run_id", "type"),
        writer_field="writer", seq_field="seq",
        description="append-only event log (obs/events.py EventLog); "
        "per-process companions carry a numeric pid suffix"),
    RecordFamily(
        name="span", container="jsonl",
        pattern="*trace*.jsonl*",
        required=("kind", "schema_version", "trace_id", "span_id",
                  "name", "ts", "dur", "pid"),
        kind_field="kind", kind_value="span",
        version_field="schema_version", known_versions=(1, 2),
        writer_field="writer", seq_field="seq",
        description="execution spans (obs/trace.py Tracer); v2 adds "
        "writer/mono/seq stamps"),
    RecordFamily(
        name="timeline", container="jsonl",
        pattern="timeline.jsonl",
        required=("schema_version", "kind", "ts", "items", "done",
                  "waiting", "leased", "expired_leases",
                  "alive_workers"),
        kind_field="kind", kind_value="fleet_timeline",
        version_field="schema_version", known_versions=(1, 2),
        writer_field="writer", seq_field="seq",
        description="live fleet timeline (obs/timeline.py "
        "TimelineSampler); v2 adds writer/mono/seq stamps"),
    RecordFamily(
        name="drift", container="jsonl",
        pattern="drift.jsonl",
        required=("schema_version", "kind", "ts", "request_id",
                  "path_pair", "kernel_path", "verdict", "shadow_s"),
        kind_field="kind", kind_value="shadow_drift",
        version_field="schema_version", known_versions=(1,),
        writer_field="writer", seq_field="seq",
        description="shadow-solve drift ledger (obs/shadow.py)"),
    RecordFamily(
        name="bench_history", container="jsonl",
        pattern="BENCH_HISTORY.jsonl",
        required=("history_schema_version", "ts", "metric"),
        version_field="history_schema_version", known_versions=(1, 2),
        description="bench regression history (obs/perf.py)"),
    RecordFamily(
        name="queue_item", container="json",
        pattern="queue/item-*.json",
        required=("request_id", "tenant", "request", "enqueued_at"),
        order_field="enqueued_at",
        description="queued work item (fleet/queue.py WorkItem); "
        "written once by the enqueuer, never rewritten"),
    RecordFamily(
        name="queue_lease", container="json",
        pattern="queue/lease-*.json",
        required=("worker", "request_id", "acquired_at", "renewed_at",
                  "expires_at"),
        writer_field="worker", order_field="acquired_at",
        description="one lease epoch (fleet/queue.py); epoch number in "
        "the filename (lease-<rid>.e<NNNNNN>.json), published "
        "exclusively, never rewritten; chains are swept on complete()"),
    RecordFamily(
        name="queue_done", container="json",
        pattern="queue/done-*.json",
        required=("request_id", "worker", "completed_at"),
        writer_field="worker", order_field="completed_at",
        description="completion marker (fleet/queue.py complete())"),
    RecordFamily(
        name="queue_fail", container="json",
        pattern="queue/fail-*.json",
        required=("request_id", "worker", "ts", "error"),
        writer_field="worker",
        description="per-attempt failure record (fleet/queue.py "
        "record_failure()); one unique file per attempt"),
    RecordFamily(
        name="result_manifest", container="json",
        pattern="*.result.json",
        required=("request_id", "tenant", "verdict", "enqueued_at",
                  "completed_at", "latency_s"),
        order_field="completed_at",
        description="per-request result manifest (serve/request.py "
        "write_result_manifest); the durable commit record of a solve, "
        "shed refusal, or terminal error"),
    RecordFamily(
        name="metrics_snapshot", container="json",
        pattern="metrics-*.json",
        required=("kind", "schema_version", "ts", "pid", "worker_id",
                  "state"),
        kind_field="kind", kind_value="metrics_snapshot",
        version_field="schema_version", known_versions=(1,),
        writer_field="worker_id",
        description="per-worker registry snapshot (obs/aggregate.py); "
        "atomically rewritten, newest-per-worker wins"),
    RecordFamily(
        name="load_steps", container="json",
        pattern="load_steps.json",
        required=("schema_version", "kind", "seed", "arrival",
                  "t_start", "steps", "submitted"),
        kind_field="kind", kind_value="load_steps",
        version_field="schema_version", known_versions=(1, 2),
        writer_field="writer", order_field="t_start",
        description="offered-load ground truth (fleet/loadgen.py); "
        "v2 adds the writer stamp"),
    RecordFamily(
        name="flight_dump", container="json",
        pattern="flight_dump*.json",
        required=("schema_version", "reason", "ts", "pid", "run_id"),
        version_field="schema_version", known_versions=(1, 2),
        writer_field="writer",
        description="flight-recorder forensic dump (obs/flight.py); "
        "v2 adds the writer stamp"),
    RecordFamily(
        name="heartbeat", container="json",
        pattern=".sagecal_heartbeat",
        required=("pid", "ts"),
        description="liveness heartbeat (obs/flight.py); rewritten in "
        "place, only the newest beat survives"),
)

_BY_NAME = {f.name: f for f in REGISTRY}

#: out-dir artifacts that LOOK like records but are derived reports /
#: opaque payloads, deliberately outside the audit surface.  Anything
#: json-ish in an out-dir matching neither REGISTRY nor this list is an
#: unregistered record file — an observability gap.
IGNORED_PATTERNS: Tuple[str, ...] = (
    "load_report.json",            # derived from timeline+manifests
    "scale_recommendation.json",   # derived recommender output
    "recommended_workers.json",    # derived recommender output
    "quality_report.json",         # derived quality report
    "audit_report.json",           # our own output
    "replay_state.json",           # our own output
    "workload/*.json",             # synthetic workload inputs
    "requests.json",               # fleet request-spec input
    "slo.json",                    # SLO policy input
    "aot-store/*",                 # serialized executables (binary)
    "*.trace.json",                # Chrome-trace exports (derived)
    "trace.json",
    "device_profile*.json*",       # device-profiler artifacts
    "*.tmp.*", "*.tmp",            # atomic-write staging leftovers
)


def family(name: str) -> RecordFamily:
    return _BY_NAME[name]


def match_family(rel_path: str) -> Optional[RecordFamily]:
    """The registered family owning a path (relative to the out-dir),
    or None for unregistered files.  Patterns with a directory part
    (queue/...) also match on basename so explicitly-passed queue dirs
    living outside the out-dir still resolve."""
    path = rel_path.replace(os.sep, "/")
    base = os.path.basename(path)
    for fam in REGISTRY:
        pat_base = fam.pattern.rsplit("/", 1)[-1]
        if (fam.matches(path) or fam.matches(base)
                or fnmatch.fnmatch(base, pat_base)):
            return fam
    return None


def is_ignored(rel_path: str) -> bool:
    base = rel_path.replace(os.sep, "/")
    return any(fnmatch.fnmatch(base, pat)
               or fnmatch.fnmatch(os.path.basename(base), pat)
               for pat in IGNORED_PATTERNS)


# --------------------------------------------------------- classification


@dataclasses.dataclass
class Classified:
    """One classified record (or unparseable fragment)."""

    status: str                  # one of STATUSES
    record: Optional[dict]       # parsed object (None when torn)
    reason: str = ""
    line_no: int = 0             # 1-based; 0 for whole-file documents
    path: str = ""


def _classify_obj(fam: RecordFamily, obj: Any, line_no: int = 0,
                  path: str = "") -> Classified:
    if not isinstance(obj, dict):
        return Classified(FOREIGN, None, "not a JSON object",
                          line_no, path)
    if fam.kind_field:
        kind = obj.get(fam.kind_field)
        if kind != fam.kind_value:
            return Classified(FOREIGN, obj,
                              f"kind {kind!r} != {fam.kind_value!r}",
                              line_no, path)
    elif fam.name == "event" and obj.get("kind") == "span":
        # spans share the JSONL idiom; a span line inside an event log
        # is a mis-routed writer, not an event
        return Classified(FOREIGN, obj, "span record in an event log",
                          line_no, path)
    missing = [k for k in fam.required if k not in obj]
    if missing:
        return Classified(OUT_OF_SCHEMA, obj,
                          f"missing keys: {', '.join(missing)}",
                          line_no, path)
    if fam.version_field and fam.known_versions:
        sv = obj.get(fam.version_field)
        if sv not in fam.known_versions:
            return Classified(OUT_OF_SCHEMA, obj,
                              f"{fam.version_field} {sv!r} not in "
                              f"{fam.known_versions}", line_no, path)
    return Classified(OK, obj, "", line_no, path)


def classify_line(fam: RecordFamily, line: str, line_no: int = 0,
                  path: str = "") -> Optional[Classified]:
    """Classify one JSONL line (None for blank lines)."""
    line = line.strip()
    if not line:
        return None
    try:
        obj = json.loads(line)
    except json.JSONDecodeError as e:
        return Classified(TORN, None, f"unparseable: {e}", line_no, path)
    return _classify_obj(fam, obj, line_no, path)


@dataclasses.dataclass
class ValidatedFile:
    """Every line/document of one file, classified."""

    path: str
    family: str
    records: List[Classified] = dataclasses.field(default_factory=list)

    def by_status(self, status: str) -> List[Classified]:
        return [c for c in self.records if c.status == status]

    @property
    def ok(self) -> List[dict]:
        return [c.record for c in self.records if c.status == OK]

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in STATUSES}
        for c in self.records:
            out[c.status] += 1
        return out


def read_validated(path: str, fam: RecordFamily) -> ValidatedFile:
    """Read one file under a family's schema, classifying every line
    (jsonl) or the whole document (json) instead of skipping."""
    vf = ValidatedFile(path=path, family=fam.name)
    if fam.container == "jsonl":
        try:
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                for i, line in enumerate(f, 1):
                    c = classify_line(fam, line, line_no=i, path=path)
                    if c is not None:
                        vf.records.append(c)
        except OSError as e:
            vf.records.append(Classified(TORN, None, f"unreadable: {e}",
                                         0, path))
        return vf
    # whole-document json
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            text = f.read()
    except OSError as e:
        vf.records.append(Classified(TORN, None, f"unreadable: {e}",
                                     0, path))
        return vf
    if not text.strip():
        vf.records.append(Classified(TORN, None, "empty document",
                                     0, path))
        return vf
    try:
        obj = json.loads(text)
    except json.JSONDecodeError as e:
        vf.records.append(Classified(TORN, None, f"unparseable: {e}",
                                     0, path))
        return vf
    vf.records.append(_classify_obj(fam, obj, 0, path))
    return vf


# --------------------------------------------------------------- discovery


@dataclasses.dataclass
class OutDirScan:
    """Every record file in an out-dir, mapped to its family."""

    out_dir: str
    files: List[ValidatedFile] = dataclasses.field(default_factory=list)
    unregistered: List[str] = dataclasses.field(default_factory=list)
    ignored: List[str] = dataclasses.field(default_factory=list)

    def by_family(self, name: str) -> List[ValidatedFile]:
        return [vf for vf in self.files if vf.family == name]

    def ok_records(self, name: str) -> List[dict]:
        out: List[dict] = []
        for vf in self.by_family(name):
            out.extend(vf.ok)
        return out

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in STATUSES}
        for vf in self.files:
            for s, n in vf.counts().items():
                out[s] += n
        return out


def _record_like(name: str) -> bool:
    base = os.path.basename(name)
    if base == ".sagecal_heartbeat":
        return True
    if ".json" not in base:
        return False
    stem = base.split(".json", 1)[0]
    suffix = base[len(stem):]
    # .json / .jsonl plus optional numeric per-process suffixes
    if suffix in (".json", ".jsonl"):
        return True
    rest = suffix.replace(".jsonl", "").replace(".json", "").strip(".")
    return rest.isdigit()


def scan_out_dir(out_dir: str,
                 extra_paths: Optional[List[str]] = None) -> OutDirScan:
    """Discover + classify every record file under ``out_dir`` (plus
    any explicit ``extra_paths``, e.g. an event log configured outside
    the out-dir).  Record-looking files owned by no registered family
    land in ``unregistered`` — an observability gap."""
    scan = OutDirScan(out_dir=out_dir)
    seen = set()
    candidates: List[Tuple[str, str]] = []  # (abs path, rel path)
    for root, dirs, names in os.walk(out_dir):
        dirs[:] = [d for d in dirs if d not in ("aot-store",)]
        for n in sorted(names):
            p = os.path.join(root, n)
            rel = os.path.relpath(p, out_dir)
            candidates.append((p, rel))
    for p in (extra_paths or []):
        if p and os.path.exists(p) and os.path.abspath(p) not in {
                os.path.abspath(c[0]) for c in candidates}:
            candidates.append((p, os.path.basename(p)))
    for p, rel in candidates:
        ap = os.path.abspath(p)
        if ap in seen:
            continue
        seen.add(ap)
        if not _record_like(rel):
            continue
        if is_ignored(rel):
            scan.ignored.append(rel)
            continue
        fam = match_family(rel)
        if fam is None:
            scan.unregistered.append(rel)
            continue
        scan.files.append(read_validated(p, fam))
    return scan


# ------------------------------------------------------- sequence analysis


def sequence_holes(records: List[dict], seq_field: str = "seq",
                   writer_field: str = "writer") -> Dict[str, List[int]]:
    """Per-writer holes in the stamped sequence numbers: for each
    writer, the missing integers strictly between its observed min and
    max.  A writer that simply stopped (crash, SIGKILL) leaves NO hole;
    a dropped or lost record in the middle does."""
    by_writer: Dict[str, List[int]] = {}
    for r in records:
        w = r.get(writer_field)
        s = r.get(seq_field)
        if isinstance(w, str) and isinstance(s, int):
            by_writer.setdefault(w, []).append(s)
    holes: Dict[str, List[int]] = {}
    for w, seqs in by_writer.items():
        have = set(seqs)
        missing = [i for i in range(min(have), max(have) + 1)
                   if i not in have]
        if missing:
            holes[w] = missing
    return holes


def registry_table() -> List[Dict[str, Any]]:
    """The registry as plain dicts (diag/docs rendering)."""
    return [dataclasses.asdict(f) for f in REGISTRY]
