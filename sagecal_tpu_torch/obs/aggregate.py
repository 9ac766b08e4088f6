"""Metric snapshots: one JSON file per process (the snapshot part of
``sagecal_tpu/obs/aggregate.py``, copied: that module is stdlib-only but
cannot be imported without JAX).

The serve path writes one cumulative snapshot of the process's registry
at the end of a run (``metrics-<worker>.json`` under its out-dir); a
reader loads every snapshot of a directory and keeps the newest per
worker.  The merged fleet view, the lifecycle readers and ``diag serve``
wait for ROADMAP.md's A9 and A11.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import time
from typing import Dict, List, Optional, Sequence

METRICS_SNAPSHOT_SCHEMA_VERSION = 1


def worker_id() -> str:
    """Stable identity of this worker for snapshot lineage:
    ``SAGECAL_WORKER_ID`` when the deployment sets one (so a resumed
    replacement supersedes its predecessor's snapshot), else the pid."""
    return os.environ.get("SAGECAL_WORKER_ID", "").strip() \
        or str(os.getpid())


def metrics_snapshot_path(out_dir: str,
                          worker: Optional[str] = None) -> str:
    """Canonical snapshot path for one worker under a serve output
    directory.  Snapshots are CUMULATIVE (a worker rewrites its own
    file), so the path must be stable per worker identity."""
    return os.path.join(out_dir, f"metrics-{worker or worker_id()}.json")


def write_metrics_snapshot(path: str, registry=None, **extra) -> str:
    """Atomically dump one process's registry state (tmp + replace so a
    concurrent reader never sees a torn file).  Returns the path."""
    if registry is None:
        from sagecal_tpu_torch.obs.registry import get_registry

        registry = get_registry()
    doc = {
        "kind": "metrics_snapshot",
        "schema_version": METRICS_SNAPSHOT_SCHEMA_VERSION,
        "ts": time.time(),
        "pid": os.getpid(),
        "worker_id": worker_id(),
        "state": registry.export_state(),
    }
    for k, v in extra.items():
        doc.setdefault(k, v)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.write("\n")
    os.replace(tmp, path)
    return path


def expand_snapshot_paths(path: str) -> List[str]:
    """Resolve a snapshot argument to the files it names: a directory
    expands to its ``metrics-*.json`` members, a file to itself."""
    if os.path.isdir(path):
        return sorted(_glob.glob(os.path.join(path, "metrics-*.json")))
    return [path] if os.path.exists(path) else []


def read_metrics_snapshots(*paths: str) -> List[dict]:
    """Load every snapshot document the arguments name (skipping
    unreadable/corrupt files rather than failing — a preempted worker
    may never have written one)."""
    out: List[dict] = []
    for p in paths:
        for f in expand_snapshot_paths(p):
            try:
                with open(f, "r", encoding="utf-8") as fh:
                    doc = json.load(fh)
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(doc, dict) and doc.get("state") is not None:
                out.append(doc)
    out.sort(key=lambda d: float(d.get("ts", 0.0)))
    return out


def dedupe_snapshots(docs: Sequence[dict]) -> List[dict]:
    """Keep only the newest snapshot per worker id.  Snapshots are
    cumulative registry dumps — merging two generations of the SAME
    worker would double-count everything the older one already held."""
    latest: Dict[str, dict] = {}
    for d in docs:
        wid = str(d.get("worker_id") or d.get("pid") or id(d))
        prev = latest.get(wid)
        if prev is None or float(d.get("ts", 0.0)) >= float(
                prev.get("ts", 0.0)):
            latest[wid] = d
    return sorted(latest.values(), key=lambda d: float(d.get("ts", 0.0)))
