"""Shadow-solve differential auditing: numerical truth on live traffic
(counterpart of ``sagecal_tpu/obs/shadow.py``).

A deterministic seeded sampler picks a configurable fraction of serve
requests, and AFTER the production result manifest is on disk (never on
the latency path, wall-clock budget-bounded per process) the same
inputs are re-solved on the reference path — the torch-op joint cost
(``use_fused_predict=False``), f32 coherencies, single lane, no CUDA
kernel — and the disagreement is appended to a schema-versioned
O_APPEND JSONL drift ledger next to the result manifests.

Each record carries: the final-cost relative delta, the gain relative
error (max and per-station), the chi^2 relative delta, the production
``kernel_path`` + ``choose_batched_path`` reason, bucket, dtypes, the
shadow re-solve's own wall time, and a verdict from
:data:`DRIFT_TOLERANCES` — the ONLY place drift tolerances live.  The
reference path keeps the reference's label ``"xla/f32"`` (there it is
XLA's predict; here the torch-op cost), so ledgers of both packages
quote the same policy rows.  Aggregation, gauges, watchdog wiring and
the drift report live in :mod:`sagecal_tpu_torch.obs.drift`.

Off-path guarantee: with ``shadow_rate == 0`` no auditor is ever
constructed and the serve dispatch is exactly what it is without the
feature — the auditor only ever READS production outputs that already
shipped.

Module-level imports are stdlib + numpy only, so the ledger readers
work without torch's device stack; the re-solve imports the solver
lazily.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

DRIFT_SCHEMA_VERSION = 1
DRIFT_KIND = "shadow_drift"

#: default drift-ledger filename inside a serve out-dir
DRIFT_FILE = "drift.jsonl"

#: the reference side of every path pair: the torch-op joint cost (the
#: reference's XLA predict, label kept), f32 coherency stack, single
#: lane.  One fixed reference keeps the ledger a star —
#: every production path compares against the same truth anchor — so
#: distributions with different ``path_pair`` labels stay comparable.
REFERENCE_PATH = "xla/f32"

#: record keys every valid drift row must carry
_REQUIRED_DRIFT_KEYS = (
    "schema_version", "kind", "ts", "request_id", "path_pair",
    "kernel_path", "kernel_path_reason", "bucket", "coh_dtype",
    "solver_dtype", "cost_rel_delta", "gain_rel_err_max",
    "chi2_rel_delta", "verdict", "reasons", "shadow_s",
)

# ------------------------------------------------------ tolerance policy

#: Central per-path-pair drift tolerance policy — the ONLY place drift
#: tolerances live (numeric policy is one audited table, never
#: constants scattered through call sites); the reference's table.
#: Keys are ``"<kernel_path>/<coh_dtype>|xla/f32"``; the value bounds
#: each ledger metric (relative quantities, dimensionless).
#:
#: Rationale per pair:
#: - ``xla/f32`` production differs from the reference only by lane
#:   batching (the reference's vmap may re-associate reductions; the
#:   port solves such lanes one by one, bit-identically), so the bound
#:   sits one decade above the reference's batched-vs-sequential 1e-5.
#: - ``fused*/f32`` additionally swaps the cost math onto the fused
#:   kernels (different accumulation order, f32 accumulators);
#:   kernel parity tests hold ~1e-5..1e-4, bounded at 1e-3 on gains.
#: - ``fused*/bf16`` stores the coherency stack in bfloat16 (~3
#:   significant decimal digits); the EM structure recovers most of it
#:   but per-station gain errors in the few-1e-2 range are expected and
#:   acceptable — the trade a precision schedule wants continuously
#:   measured before flipping.
#: - ``default`` covers pairs not yet characterized (e.g. a future GPU
#:   path): deliberately loose so an uncharacterized path reports
#:   rather than false-alarms, while still catching gross breakage.
DRIFT_TOLERANCES: Dict[str, dict] = {
    "xla/f32|xla/f32": {
        "cost_rel_delta": 1e-4,
        "gain_rel_err_max": 5e-4,
        "chi2_rel_delta": 1e-4,
    },
    "fused/f32|xla/f32": {
        "cost_rel_delta": 5e-4,
        "gain_rel_err_max": 1e-3,
        "chi2_rel_delta": 5e-4,
    },
    "fused_batch/f32|xla/f32": {
        "cost_rel_delta": 5e-4,
        "gain_rel_err_max": 1e-3,
        "chi2_rel_delta": 5e-4,
    },
    "fused/bf16|xla/f32": {
        "cost_rel_delta": 2e-2,
        "gain_rel_err_max": 8e-2,
        "chi2_rel_delta": 5e-2,
    },
    "fused_batch/bf16|xla/f32": {
        "cost_rel_delta": 2e-2,
        "gain_rel_err_max": 8e-2,
        "chi2_rel_delta": 5e-2,
    },
    "default": {
        "cost_rel_delta": 1e-1,
        "gain_rel_err_max": 2e-1,
        "chi2_rel_delta": 1e-1,
    },
}

#: relative-error floor: deltas against a reference value smaller than
#: this are measured against the floor instead (a 1e-30 residual must
#: not turn numeric dust into an infinite relative delta)
_REL_EPS = 1e-12

#: test-only hook: a float in this env var perturbs the REFERENCE gain
#: solution by that relative amount (deterministically seeded per
#: request), so the injected-drift fixture can prove end to end that a
#: real disagreement reaches the drift report as a breach.  Never set
#: in production.
INJECT_DRIFT_ENV = "SAGECAL_SHADOW_INJECT_DRIFT"


def path_pair(kernel_path: str, coh_dtype: str) -> str:
    """The ledger's path-pair label for one production dispatch."""
    return f"{kernel_path}/{coh_dtype}|{REFERENCE_PATH}"


def lookup_tolerances(pair: str) -> dict:
    """The :data:`DRIFT_TOLERANCES` row for a path pair (the
    ``default`` row for pairs not yet characterized)."""
    return DRIFT_TOLERANCES.get(pair, DRIFT_TOLERANCES["default"])


def drift_path(out_dir: str) -> str:
    return os.path.join(out_dir, DRIFT_FILE)


# ------------------------------------------------------------- sampling


def shadow_sampled(request_id: str, rate: float, seed: int = 0) -> bool:
    """Deterministic membership test: does this request fall in the
    shadow sample at ``rate``?

    Pure function of ``(seed, request_id)`` — crc32 of the seeded id
    mapped to [0, 1) — so the same seed always samples the same request
    ids regardless of scheduler, worker or arrival order (the same ids
    as the reference's), and re-runs audit the same traffic slice."""
    rate = float(rate)
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = zlib.crc32(f"{int(seed)}:{request_id}".encode("utf-8"))
    return (h / 2.0 ** 32) < rate


# ------------------------------------------------------- drift metrics


def _rel_delta(prod: float, ref: float) -> float:
    return abs(float(prod) - float(ref)) / max(abs(float(ref)), _REL_EPS)


def compute_drift_metrics(p_prod, p_ref, res1_prod: float,
                          res1_ref: float,
                          chi2_prod: Optional[float],
                          chi2_ref: Optional[float]) -> dict:
    """Differential metrics between a production solve and its shadow
    reference solve (both host numpy; ``p_*`` is the packed real gain
    vector ``(M, nchunk, 8N)``, station-major 8-per-station as in
    ``core.types.params_to_jones``).

    ``gain_rel_err_station[s]`` is the max absolute parameter error of
    station ``s`` over all clusters/chunks, relative to the reference's
    own max magnitude for that station — per-station attribution is
    what turns "bf16 drifted" into "station 43 drifted", the same
    station-resolution discipline as the chi^2 watchdog."""
    p_prod = np.asarray(p_prod, np.float64)
    p_ref = np.asarray(p_ref, np.float64)
    # (..., 8N) -> (..., N, 8): per-station parameter blocks
    sp = p_prod.reshape(p_prod.shape[:-1] + (-1, 8))
    sr = p_ref.reshape(p_ref.shape[:-1] + (-1, 8))
    nsta = sp.shape[-2]
    axes = tuple(i for i in range(sp.ndim) if i != sp.ndim - 2)
    abs_err = np.abs(sp - sr).max(axis=axes) if sp.size else \
        np.zeros(nsta)
    ref_mag = np.abs(sr).max(axis=axes) if sr.size else np.ones(nsta)
    station = abs_err / np.maximum(ref_mag, _REL_EPS)
    if not np.all(np.isfinite(station)):
        station = np.where(np.isfinite(station), station, np.inf)
    metrics = {
        "cost_rel_delta": _rel_delta(res1_prod, res1_ref),
        "gain_rel_err_max": float(station.max()) if station.size else 0.0,
        "gain_rel_err_station": [round(float(s), 12) for s in station],
    }
    if chi2_prod is not None and chi2_ref is not None:
        metrics["chi2_rel_delta"] = _rel_delta(chi2_prod, chi2_ref)
    return metrics


def drift_verdict(metrics: dict, pair: str):
    """Apply the tolerance policy row for ``pair`` to one record's
    metrics.  Returns ``(verdict, reasons)`` — ``"ok"`` or
    ``"drift_exceeded"`` (drift is degraded-not-diverged: the
    production result already shipped and may well be fine; the ledger
    exists so a human — or ``--abort-on-drift`` — decides)."""
    tol = lookup_tolerances(pair)
    reasons: List[str] = []
    for name, bound in tol.items():
        v = metrics.get(name)
        if v is None:
            continue
        v = float(v)
        if not np.isfinite(v):
            reasons.append(f"{name} is non-finite")
        elif v > float(bound):
            reasons.append(f"{name} {v:.3e} exceeds {pair} "
                           f"tolerance {bound:.1e}")
    return ("drift_exceeded", reasons) if reasons else ("ok", reasons)


# ------------------------------------------------------------ the ledger


def _chi2_total(quality) -> Optional[float]:
    from sagecal_tpu_torch.obs.quality import (
        quality_summary, quality_to_host,
    )

    s = quality_summary(quality_to_host(quality))
    tot = s.get("chi2_total")
    return None if tot is None else float(tot)


class ShadowAuditor:
    """Sampled shadow re-solves + the O_APPEND drift ledger.

    One auditor per serve process.  The service calls
    :meth:`audit` once per completed (manifest-written) request; the
    auditor decides membership via :func:`shadow_sampled`, enforces the
    per-process wall-clock budget, re-solves the SAME packed inputs on
    the reference path and appends one drift record.  Rows share the
    EventLog durability contract — one ``os.write`` on an ``O_APPEND``
    fd per record, so processes appending to a shared out-dir never
    interleave and a killed run keeps every record up to the kill."""

    def __init__(self, out_dir: str, rate: float, budget_s: float = 60.0,
                 seed: int = 0, device=None, log=print):
        self.rate = float(rate)
        self.budget_s = float(budget_s)
        self.seed = int(seed)
        self.device = device
        self.log = log
        os.makedirs(out_dir, exist_ok=True)
        self.path = drift_path(out_dir)
        self._fd: Optional[int] = os.open(
            self.path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        self.spent_s = 0.0
        self.sampled = 0
        self.audited = 0
        self.budget_skipped = 0
        self.exceeded: List[str] = []  # request ids over tolerance
        from sagecal_tpu_torch.obs.events import writer_identity

        self._writer = writer_identity()
        self._seq = 0

    # -- membership / budget -------------------------------------------

    def wants(self, request_id: str) -> bool:
        if not shadow_sampled(request_id, self.rate, self.seed):
            return False
        self.sampled += 1
        if self.spent_s >= self.budget_s:
            # budget exhaustion is counted, never queued: the ledger's
            # sampling story stays honest (the report carries the skip
            # count so a starved budget can't masquerade as clean)
            self.budget_skipped += 1
            return False
        return True

    # -- the shadow re-solve -------------------------------------------

    def _reference_solve(self, entry):
        """Re-solve ``entry``'s inputs on the reference path: torch-op
        joint cost, f32 coherency stack, single lane.  The OS-LM
        generator is derived afresh from the request identity
        (``derive_lane_generators(0, [lane_id])``, as the dispatch
        derives it), so the randomized solver stream replays exactly and
        the differential isolates the KERNEL PATH, not the RNG."""
        from sagecal_tpu_torch.solvers.batched import derive_lane_generators
        from sagecal_tpu_torch.solvers.sage import solve_tile

        ref_cfg = entry.scfg.replace(use_fused_predict=False,
                                     coh_dtype="f32")
        # a fresh p0: entry.p0 must stay intact for diagnostics
        return solve_tile(entry.data, entry.cdata, entry.p0.clone(), ref_cfg,
                          derive_lane_generators(0, [entry.lane_id])[0],
                          device=self.device)

    def audit(self, entry, bucket: str, kernel_path: str,
              path_reason: str, p_prod, res1_prod: float,
              quality_prod, elog=None) -> Optional[dict]:
        """Shadow-audit one completed request (AFTER its result
        manifest is written).  Returns the appended drift record, or
        None when the request is unsampled / over budget."""
        if not self.wants(entry.req.request_id):
            return None
        t0 = time.time()
        ref = self._reference_solve(entry)
        p_ref = ref.p.detach().cpu().double().numpy()
        res1_ref = float(ref.res_1)
        chi2_ref = None if ref.quality is None else _chi2_total(ref.quality)

        inject = float(os.environ.get(INJECT_DRIFT_ENV, "0") or "0")
        if inject != 0.0:
            # deterministic per-request perturbation of the REFERENCE:
            # the production result is untouched, so the fixture proves
            # the full detect path without shipping a wrong solution
            rng = np.random.default_rng(
                zlib.crc32(entry.req.request_id.encode("utf-8")))
            p_ref = p_ref * (1.0 + inject) \
                + inject * rng.standard_normal(p_ref.shape)

        pair = path_pair(kernel_path, entry.scfg.coh_dtype)
        metrics = compute_drift_metrics(
            np.asarray(p_prod, np.float64), p_ref,
            float(res1_prod), res1_ref,
            _chi2_total(quality_prod), chi2_ref)
        verdict, reasons = drift_verdict(metrics, pair)
        shadow_s = time.time() - t0
        self.spent_s += shadow_s
        self.audited += 1
        if verdict != "ok":
            self.exceeded.append(entry.req.request_id)

        record = {
            "schema_version": DRIFT_SCHEMA_VERSION,
            "kind": DRIFT_KIND, "ts": t0,
            "request_id": entry.req.request_id,
            "tenant": entry.req.tenant,
            "path_pair": pair,
            "kernel_path": kernel_path,
            "kernel_path_reason": path_reason,
            "bucket": bucket,
            "coh_dtype": entry.scfg.coh_dtype,
            "solver_dtype": str(entry.p0.dtype).replace("torch.", ""),
            "verdict": verdict, "reasons": reasons,
            "shadow_s": shadow_s,
            "res_1_ref": res1_ref,
        }
        record.update(metrics)
        # audit stamps, appended after the v1 layout (obs/ledger.py)
        record["writer"] = self._writer
        record["mono"] = time.monotonic()
        record["seq"] = self._seq
        self._seq += 1
        fd = self._fd
        if fd is not None:
            os.write(fd, (json.dumps(record) + "\n").encode("utf-8"))

        from sagecal_tpu_torch.obs.drift import check_drift

        check_drift(elog, record, log=self.log)
        return record

    # -- lifecycle -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "rate": self.rate, "sampled": self.sampled,
            "audited": self.audited,
            "budget_skipped": self.budget_skipped,
            "budget_s": self.budget_s,
            "spent_s": self.spent_s,
            "exceeded": list(self.exceeded),
        }

    def close(self) -> None:
        fd, self._fd = self._fd, None
        if fd is not None:
            os.close(fd)

    def __enter__(self) -> "ShadowAuditor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------- readers


def read_drift(path: str) -> List[dict]:
    """Load a drift ledger's records (skips blank/corrupt/foreign lines
    — a killed worker may leave a truncated tail)."""
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
            if isinstance(row, dict) and row.get("kind") == DRIFT_KIND:
                out.append(row)
    out.sort(key=lambda r: float(r.get("ts", 0.0)))
    return out


def validate_drift(rows) -> List[str]:
    """Structural problems of a drift ledger (empty list = valid):
    required keys present, schema version known, metrics finite and
    non-negative, verdict consistent with the tolerance table."""
    problems: List[str] = []
    if not rows:
        return ["no drift records"]
    for i, row in enumerate(rows):
        for k in _REQUIRED_DRIFT_KEYS:
            if k not in row:
                problems.append(f"record {i}: missing key {k}")
        sv = row.get("schema_version")
        if sv is not None and sv != DRIFT_SCHEMA_VERSION:
            problems.append(f"record {i}: schema_version {sv} != "
                            f"{DRIFT_SCHEMA_VERSION}")
        for k in ("cost_rel_delta", "gain_rel_err_max", "chi2_rel_delta",
                  "shadow_s"):
            v = row.get(k)
            if v is None:
                continue
            if not isinstance(v, (int, float)) or v < 0:
                problems.append(f"record {i}: {k}={v!r} not a "
                                f"non-negative number")
        verdict = row.get("verdict")
        if verdict not in (None, "ok", "drift_exceeded"):
            problems.append(f"record {i}: unknown verdict {verdict!r}")
        pair = row.get("path_pair")
        if verdict in ("ok", "drift_exceeded") and isinstance(pair, str):
            want, _ = drift_verdict(row, pair)
            if want != verdict:
                problems.append(
                    f"record {i}: verdict {verdict} disagrees with the "
                    f"tolerance policy for {pair} (expected {want})")
    return problems
