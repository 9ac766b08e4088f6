"""Live fleet timeline: sampled queue/SLO state during a run.

Everything the fleet layer knew about itself before this module was
post-hoc: queue depth reconstructed from result manifests
(obs/aggregate.queue_depth_timeline), SLO burn evaluated after the
drain, cache behavior read from exit snapshots.  A load run needs the
*live* view — the coordinator calls :meth:`TimelineSampler.sample`
once per watch poll and each call appends ONE schema-versioned JSONL
row capturing, at that instant:

- queue depth by state (``waiting`` / ``leased`` / ``expired_leases``
  / ``done`` out of ``items``) from a single :meth:`LeaseQueue.stats`
  scan (names-only listdir counting — no item bodies are read);
- ``alive_workers`` as reported by the caller (the coordinator owns
  the Popen table);
- merged SLO-burn gauges, computed live by incrementally ingesting
  result manifests into an :class:`obs.slo.SLOMonitor` (only files not
  seen by a previous sample are parsed, so steady-state cost is
  O(new completions), not O(all completions)).  Shed manifests are
  *not* fed as burn samples — the same anti-latch rule admission
  control uses (a shed is the controller's own action, not tenant-
  visible error evidence);
- a live cache gauge: the shared kernel store's artifact count (the
  only build-cache signal visible outside worker processes mid-run).

Rows share the EventLog durability contract: one ``os.write`` on an
``O_APPEND`` fd per sample, so concurrent writers never interleave and
a killed run keeps every row up to the kill.  Import-light (stdlib
only; a copy of ``sagecal_tpu/obs/timeline.py``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Set

# v2: rows carry writer identity + mono/seq audit stamps (appended
# after the v1 keys; v1 rows remain valid)
TIMELINE_SCHEMA_VERSION = 2
_TIMELINE_KNOWN_VERSIONS = (1, 2)
TIMELINE_KIND = "fleet_timeline"

#: default timeline filename inside a fleet/load out-dir
TIMELINE_FILE = "timeline.jsonl"

#: row keys every valid sample must carry
_REQUIRED_ROW_KEYS = (
    "schema_version", "kind", "ts", "items", "done", "waiting",
    "leased", "expired_leases", "alive_workers",
)


def timeline_path(out_dir: str) -> str:
    return os.path.join(out_dir, TIMELINE_FILE)


class TimelineSampler:
    """Append one live fleet-state row per :meth:`sample` call.

    ``queue`` supplies depth-by-state; ``out_dir`` (when given)
    supplies result manifests for live burn/verdict gauges;
    ``slo_specs`` (tenant -> :class:`obs.slo.SLOSpec`) turns those
    manifests into burn rates.  All three are optional — a sampler
    with none of them still records timestamps and caller-provided
    fields, which is what the unit fixtures use."""

    def __init__(self, path: str, queue=None, out_dir: str = "",
                 slo_specs=None, aot_store: str = "",
                 clock=time.time):
        self.path = path
        self.queue = queue
        self.out_dir = out_dir
        self.aot_store = aot_store
        self.clock = clock
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._fd: Optional[int] = os.open(
            path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        self._seen: Set[str] = set()
        self._verdicts: Dict[str, int] = {}
        from sagecal_tpu_torch.obs.events import writer_identity

        self._writer = writer_identity()
        self._row_seq = 0
        self._monitor = None
        if slo_specs:
            from sagecal_tpu_torch.obs.slo import SLOMonitor

            self._monitor = SLOMonitor(slo_specs)

    @property
    def closed(self) -> bool:
        return self._fd is None

    # -- manifest ingestion (incremental) ------------------------------

    def _ingest_new_manifests(self) -> None:
        if not self.out_dir or not os.path.isdir(self.out_dir):
            return
        try:
            names = os.listdir(self.out_dir)
        except OSError:
            return
        for name in sorted(names):
            if not name.endswith(".result.json") or name in self._seen:
                continue
            self._seen.add(name)
            try:
                with open(os.path.join(self.out_dir, name),
                          "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                # torn read of an in-flight manifest: forget it so the
                # next sample retries the (atomic-rename) final file
                self._seen.discard(name)
                continue
            if not isinstance(doc, dict) or not doc.get("request_id"):
                continue
            verdict = str(doc.get("verdict", ""))
            self._verdicts[verdict] = self._verdicts.get(verdict, 0) + 1
            if self._monitor is not None and verdict != "shed":
                # sheds don't burn (admission's anti-latch rule)
                self._monitor.observe(
                    str(doc.get("tenant", "")),
                    float(doc.get("completed_at") or 0.0),
                    float(doc.get("latency_s", 0.0)), verdict)

    def _aot_entries(self) -> Optional[int]:
        if not self.aot_store or not os.path.isdir(self.aot_store):
            return None
        try:
            return sum(1 for n in os.listdir(self.aot_store)
                       if n.endswith(".json"))
        except OSError:
            return None

    # -- sampling ------------------------------------------------------

    def sample(self, now: Optional[float] = None,
               alive_workers: int = 0, **extra) -> Dict[str, Any]:
        """Capture + append one row; returns it (callers feed the same
        dict to the autoscale recommender so both see one snapshot)."""
        now = self.clock() if now is None else float(now)
        row: Dict[str, Any] = {
            "schema_version": TIMELINE_SCHEMA_VERSION,
            "kind": TIMELINE_KIND, "ts": now,
            "items": 0, "done": 0, "waiting": 0,
            "leased": 0, "expired_leases": 0,
            "alive_workers": int(alive_workers),
        }
        if self.queue is not None:
            st = self.queue.stats(now)
            row.update(items=st["items"], done=st["done"],
                       leased=st["leased"],
                       expired_leases=st["expired_leases"],
                       waiting=st.get("waiting",
                                      max(st["items"] - st["done"]
                                          - st["leased"]
                                          - st["expired_leases"], 0)))
        self._ingest_new_manifests()
        if self._verdicts:
            row["results_total"] = sum(self._verdicts.values())
            row["shed_total"] = self._verdicts.get("shed", 0)
            row["error_total"] = self._verdicts.get("error", 0)
        aot = self._aot_entries()
        if aot is not None:
            row["aot_store_entries"] = aot
        if self._monitor is not None and self._monitor.enabled:
            burns: Dict[str, List[float]] = {}
            for status in self._monitor.evaluate(now):
                burns[status["tenant"]] = [
                    round(b, 6) for b in status["burn_rates"]]
            row["slo_burn"] = burns
            row["slo_burn_max_short"] = max(
                (b[0] for b in burns.values() if b), default=0.0)
        for k, v in extra.items():
            if k not in row:
                row[k] = v
        # v2 audit stamps, appended after the v1 layout
        row.setdefault("writer", self._writer)
        row.setdefault("mono", time.monotonic())
        if "seq" not in row:
            row["seq"] = self._row_seq
            self._row_seq += 1
        fd = self._fd
        if fd is not None:
            os.write(fd, (json.dumps(row) + "\n").encode("utf-8"))
        return row

    def close(self) -> None:
        fd, self._fd = self._fd, None
        if fd is not None:
            os.close(fd)

    def __enter__(self) -> "TimelineSampler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_timeline(path: str) -> List[dict]:
    """Load a timeline's rows (skips blank/corrupt/foreign lines — a
    killed run may leave a truncated tail)."""
    out: List[dict] = []
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(row, dict) and row.get("kind") == TIMELINE_KIND:
                out.append(row)
    out.sort(key=lambda r: float(r.get("ts", 0.0)))
    return out


def validate_timeline(rows) -> List[str]:
    """Structural problems of a timeline (empty list = valid): required
    keys present, schema version known, timestamps monotone, counts
    consistent (done+waiting+leased+expired == items)."""
    problems: List[str] = []
    if not rows:
        return ["no timeline rows"]
    last_ts = None
    for i, row in enumerate(rows):
        for k in _REQUIRED_ROW_KEYS:
            if k not in row:
                problems.append(f"row {i}: missing key {k}")
        sv = row.get("schema_version")
        if sv is not None and sv not in _TIMELINE_KNOWN_VERSIONS:
            problems.append(
                f"row {i}: schema_version {sv} not in "
                f"{_TIMELINE_KNOWN_VERSIONS}")
        ts = row.get("ts")
        if isinstance(ts, (int, float)):
            if last_ts is not None and ts < last_ts:
                problems.append(f"row {i}: ts not monotone")
            last_ts = float(ts)
        counts = [row.get(k) for k in
                  ("done", "waiting", "leased", "expired_leases",
                   "items")]
        if all(isinstance(c, int) for c in counts):
            if sum(counts[:4]) != counts[4]:
                problems.append(
                    f"row {i}: state counts {counts[:4]} do not sum "
                    f"to items={counts[4]}")
    return problems
