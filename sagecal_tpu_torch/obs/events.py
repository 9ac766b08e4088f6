"""Run manifests and the JSONL event log (counterpart of
``sagecal_tpu/obs/events.py``).

With ``SAGECAL_TELEMETRY=1`` an app run writes an append-only stream of
JSON objects, one per line: first a :class:`RunManifest` (framework,
device, precision, kernel path), then per-tile events (phase timings,
convergence records, quality verdicts).  The path is
``SAGECAL_EVENT_LOG`` (default ``./sagecal_events.jsonl``).  Every line
carries the reference's audit stamps (writer identity, per-writer
sequence number, monotonic time), so the two packages' logs have the
same layout; the manifest names torch and CUDA where the reference names
jax and jaxlib.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import uuid
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1

# manifest keys that must be present for a manifest to validate
_REQUIRED_MANIFEST_KEYS = (
    "schema_version", "run_id", "platform", "device_kind", "num_devices",
    "torch_version", "cuda_version", "x64_enabled",
)


def writer_identity() -> str:
    """``<worker>@<pid>``: the ``SAGECAL_WORKER_ID`` when set, else a
    pid-derived name, stamped on every record."""
    wid = os.environ.get("SAGECAL_WORKER_ID", "").strip()
    pid = os.getpid()
    return f"{wid or 'p%d' % pid}@{pid}"


def _jsonable(x):
    """Best-effort conversion of numpy and torch scalars and arrays to
    plain JSON types (an event must never fail to serialize)."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "detach"):  # a torch tensor: to the host first
        x = x.detach().cpu().numpy()
    item = getattr(x, "item", None)
    tolist = getattr(x, "tolist", None)
    try:
        if tolist is not None and getattr(x, "ndim", 0) > 0:
            return _jsonable(tolist())
        if item is not None:
            return _jsonable(item())
    except Exception:
        pass
    return repr(x)


@dataclasses.dataclass
class RunManifest:
    """What ran, where and how: the header record of every event log.
    :meth:`collect` records a failed device query (``backend_error``)
    instead of raising."""

    schema_version: int = SCHEMA_VERSION
    run_id: str = ""
    created_unix: float = 0.0
    argv: List[str] = dataclasses.field(default_factory=list)
    pid: int = 0
    platform: str = "unknown"  # "gpu" or "cpu"
    device_kind: str = "unknown"
    num_devices: int = 0
    torch_version: str = "unknown"
    cuda_version: str = "unknown"  # torch.version.cuda, "none" without
    x64_enabled: bool = False  # the run computes in float64
    kernel_path: str = "torch"  # "torch" (torch ops) | "fused" (CUDA kernels)
    backend_error: Optional[str] = None
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def collect(cls, kernel_path: str = "torch", run_id: Optional[str] = None,
                device=None, x64_enabled: bool = False,
                **extra) -> "RunManifest":
        """The manifest of this process running on ``device`` (a
        ``torch.device``; its type names the platform)."""
        m = cls(
            run_id=run_id or uuid.uuid4().hex[:12],
            created_unix=time.time(),
            argv=list(sys.argv),
            pid=os.getpid(),
            kernel_path=kernel_path,
            x64_enabled=bool(x64_enabled),
            env={k: v for k, v in os.environ.items()
                 if k.startswith("SAGECAL_")},
            extra={k: _jsonable(v) for k, v in extra.items()},
        )
        try:
            import torch

            m.torch_version = torch.__version__
            m.cuda_version = torch.version.cuda or "none"
            dev = torch.device("cpu" if device is None else device)
            if dev.type == "cuda":
                m.platform = "gpu"
                m.device_kind = torch.cuda.get_device_name(dev)
                m.num_devices = torch.cuda.device_count()
            else:
                m.platform = dev.type
                m.device_kind = dev.type
                m.num_devices = 1
        except Exception as e:  # a failed device query: record it
            m.backend_error = f"{type(e).__name__}: {e}"
        return m

    def to_dict(self) -> dict:
        return _jsonable(dataclasses.asdict(self))


def validate_manifest(d: dict) -> List[str]:
    """Problems with a manifest dict (empty: valid)."""
    problems = [f"missing key: {k}" for k in _REQUIRED_MANIFEST_KEYS
                if k not in d]
    if d.get("schema_version") not in (None, SCHEMA_VERSION):
        problems.append(
            f"schema_version {d.get('schema_version')} != {SCHEMA_VERSION}")
    if "num_devices" in d and not isinstance(d["num_devices"], int):
        problems.append("num_devices not an int")
    return problems


class EventLog:
    """Append-only JSONL event sink.  Each :meth:`emit` is one
    ``os.write`` of one line on an ``O_APPEND`` descriptor, so writers
    sharing a file never interleave within a line, and nothing is
    buffered: a crashed run keeps every event up to the crash."""

    def __init__(self, path: str, run_id: Optional[str] = None,
                 manifest: Optional[RunManifest] = None):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fd: Optional[int] = os.open(
            path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        if manifest is not None and not manifest.run_id:
            manifest.run_id = uuid.uuid4().hex[:12]
        self.run_id = run_id or (
            manifest.run_id if manifest is not None else uuid.uuid4().hex[:12])
        self.writer = writer_identity()
        self._seq = 0
        if manifest is not None:
            self.emit("run_manifest", **manifest.to_dict())

    def emit(self, type: str, **fields) -> None:
        fd = self._fd
        if fd is None:
            return
        rec = {"ts": time.time(), "run_id": self.run_id, "type": type}
        for k, v in fields.items():
            if k not in rec:
                rec[k] = _jsonable(v)
        # the audit stamps go last, as in the reference
        rec.setdefault("writer", self.writer)
        rec.setdefault("mono", time.monotonic())
        if "seq" not in rec:
            rec["seq"] = self._seq
            self._seq += 1
        os.write(fd, (json.dumps(rec) + "\n").encode("utf-8"))

    def close(self) -> None:
        fd, self._fd = self._fd, None
        if fd is not None:
            os.close(fd)

    @property
    def closed(self) -> bool:
        return self._fd is None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> List[dict]:
    """Every event of a JSONL log; blank and corrupt lines (a killed
    run's truncated last line) are skipped."""
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def expand_event_paths(path: str) -> List[str]:
    """Resolve an event-log argument to the set of JSONL files it names:
    a directory expands to its ``*.jsonl`` files (plus per-process
    ``*.jsonl.<pid>`` siblings); a file expands to itself plus any
    ``<file>.<pid>`` companions written by
    ``SAGECAL_EVENT_LOG_PER_PROCESS=1`` runs."""
    import glob as _glob

    if os.path.isdir(path):
        out = sorted(_glob.glob(os.path.join(path, "*.jsonl")))
        out += sorted(p for p in _glob.glob(os.path.join(path, "*.jsonl.*"))
                      if p.rsplit(".", 1)[-1].isdigit())
        return out
    out = [path] if os.path.exists(path) else []
    out += sorted(p for p in _glob.glob(path + ".*")
                  if p.rsplit(".", 1)[-1].isdigit())
    return out


def read_events_merged(path: str) -> List[dict]:
    """Read + merge events from every file :func:`expand_event_paths`
    resolves, in stable timestamp order (the ``diag``-side merge for
    per-process suffixed logs)."""
    events: List[dict] = []
    for p in expand_event_paths(path):
        events.extend(read_events(p))
    events.sort(key=lambda e: float(e.get("ts", 0.0)))
    return events


def default_event_log(manifest: Optional[RunManifest] = None,
                      path: Optional[str] = None) -> Optional[EventLog]:
    """An :class:`EventLog` at ``path``, ``SAGECAL_EVENT_LOG`` or
    ``./sagecal_events.jsonl`` when telemetry is on, else None.
    ``SAGECAL_EVENT_LOG_PER_PROCESS=1`` suffixes the path with the pid."""
    from sagecal_tpu_torch.obs.registry import _TRUTHY, telemetry_enabled

    if not telemetry_enabled():
        return None
    path = path or os.environ.get("SAGECAL_EVENT_LOG") or "sagecal_events.jsonl"
    if os.environ.get("SAGECAL_EVENT_LOG_PER_PROCESS",
                      "").strip().lower() in _TRUTHY:
        path = f"{path}.{os.getpid()}"
    return EventLog(path, manifest=manifest)
