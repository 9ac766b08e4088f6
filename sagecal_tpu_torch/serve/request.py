"""Serve request/result manifests (a copy of
``sagecal_tpu/serve/request.py``, which is stdlib-only but cannot be
imported without JAX).

A request manifest is one JSON document describing a batch of
independent calibration requests from one or more tenants::

    {
      "requests": [
        {
          "request_id": "fieldA-t0",
          "tenant": "lofar-eor",
          "dataset": "/data/fieldA.vis.h5",
          "sky_model": "/data/fieldA.sky",
          "cluster_file": "/data/fieldA.sky.cluster",   # optional
          "t0": 0,                                      # tile start
          "tilesz": 2,
          "solver_mode": 1,                             # optional knobs
          "max_emiter": 1, "max_iter": 2, "max_lbfgs": 6
        },
        ...
      ]
    }

(a bare JSON list of request objects is accepted too).  Omitted solver
knobs inherit the service defaults (apps/config.py ServeConfig);
``cluster_file`` defaults to ``<sky_model>.cluster``; ``out_solutions``
defaults to ``<out_dir>/<request_id>.solutions``.

Each completed request gets a RESULT manifest
``<out_dir>/<request_id>.result.json`` — verdict, residuals, the
bucket it solved in, latency — so a tenant polls one file per request
instead of parsing the shared event log.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional

_ID_RE = re.compile(r"^[A-Za-z0-9._-]+$")

#: solver knobs a request may override (everything else is service-wide)
SOLVER_KNOBS = ("solver_mode", "max_emiter", "max_iter", "max_lbfgs",
                "lbfgs_m", "nulow", "nuhigh", "randomize")


@dataclasses.dataclass
class SolveRequest:
    request_id: str
    tenant: str
    dataset: str
    sky_model: str
    t0: int
    tilesz: int
    cluster_file: str = ""
    out_solutions: str = ""
    in_column: str = "vis"
    # lifecycle trace id: carried through to the result manifest so one
    # logical trace survives process boundaries and --resume; derived
    # from the request_id when the submitter doesn't pick one
    trace_id: str = ""
    # upstream enqueue wall-clock (unix).  A fronting queue (the fleet's
    # LeaseQueue) sets this so queue_wait_s in the result manifest spans
    # the WHOLE wait, not just the service-internal round-robin; 0 means
    # the service stamps its own submit time
    enqueued_at: float = 0.0
    # None = inherit the ServeConfig default
    solver_mode: Optional[int] = None
    max_emiter: Optional[int] = None
    max_iter: Optional[int] = None
    max_lbfgs: Optional[int] = None
    lbfgs_m: Optional[int] = None
    nulow: Optional[float] = None
    nuhigh: Optional[float] = None
    randomize: Optional[bool] = None

    def __post_init__(self):
        if not _ID_RE.match(self.request_id):
            raise ValueError(
                f"request_id {self.request_id!r} must match "
                f"{_ID_RE.pattern} (it names output files)")
        if not self.cluster_file:
            self.cluster_file = self.sky_model + ".cluster"
        if not self.trace_id:
            self.trace_id = f"req-{self.request_id}"


def load_requests(path: str) -> List[SolveRequest]:
    """Parse a request manifest; raises ``ValueError`` on a malformed
    document, a missing required field, or a duplicate request_id."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        doc = doc.get("requests")
    if not isinstance(doc, list) or not doc:
        raise ValueError(
            f"{path}: expected a JSON list of requests (or an object "
            f"with a non-empty 'requests' list)")
    out: List[SolveRequest] = []
    seen = set()
    fields = {f.name for f in dataclasses.fields(SolveRequest)}
    for i, item in enumerate(doc):
        if not isinstance(item, dict):
            raise ValueError(f"{path}: request #{i} is not an object")
        unknown = set(item) - fields
        if unknown:
            raise ValueError(
                f"{path}: request #{i} has unknown fields "
                f"{sorted(unknown)}")
        missing = {"request_id", "tenant", "dataset", "sky_model",
                   "t0", "tilesz"} - set(item)
        if missing:
            raise ValueError(
                f"{path}: request #{i} missing required fields "
                f"{sorted(missing)}")
        req = SolveRequest(**item)
        if req.request_id in seen:
            raise ValueError(
                f"{path}: duplicate request_id {req.request_id!r}")
        seen.add(req.request_id)
        out.append(req)
    return out


def result_manifest_path(out_dir: str, request_id: str) -> str:
    return os.path.join(out_dir, f"{request_id}.result.json")


def write_result_manifest(out_dir: str, result: Dict[str, Any]) -> str:
    """Atomically write one request's result manifest (tmp + replace,
    same torn-read guarantee as the elastic checkpoints — a polling
    tenant never sees half a verdict)."""
    os.makedirs(out_dir, exist_ok=True)
    path = result_manifest_path(out_dir, result["request_id"])
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1, sort_keys=True, default=str)
        f.write("\n")
    os.replace(tmp, path)
    return path
