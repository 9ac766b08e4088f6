"""Fixed-shape per-iteration solver trace records (counterpart of
``sagecal_tpu/obs/records.py``).

A solver asked for a trace (``collect_trace=True``, or
``SageConfig.collect_telemetry``) preallocates an :class:`IterTrace` of
``(itmax, ...)`` device tensors and writes iteration ``i``'s row in
place.  Rows of iterations never run keep their fill (NaN; ``ls_evals``
0), exactly where the reference's ``while_loop`` leaves them.  Solvers
whose chunk lanes run in lock-step write a row with ``torch.where`` on
the lanes' live mask (:func:`write_trace`'s ``live``), so collecting a
trace reads nothing back to the host.  With the flag off no trace is
allocated and the solve is unchanged.

The host-side consumers (:func:`sage_convergence_records`,
:func:`trace_to_host`) take the port's tensors and return plain Python
values for the JSONL event log.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from sagecal_tpu_torch.device import resolve_device


class IterTrace(NamedTuple):
    """One solver run's per-iteration telemetry.

    Leading axis of every field is the iteration index (``itmax``);
    trailing axes are solver-specific (the hybrid-chunk axis for LM, RTR
    and NSD, none for the joint LBFGS).  Wrappers (robust EM, SAGE's
    cluster loop) stack further axes in front.

    cost: objective after the iteration; grad_norm: the solver's own
    termination gradient norm (inf-norm for LM, 2-norm for LBFGS/RTR);
    step: ||dp|| (LM), accepted alpha (LBFGS), ||eta|| (RTR) or the
    step size t (NSD); ls_evals: cost evaluations of the iteration's
    line search or trial acceptance (truncated-CG steps for RTR); nu:
    the Student's-t nu in effect (NaN for non-robust solvers)."""

    cost: Any
    grad_norm: Any
    step: Any
    ls_evals: Any
    nu: Any


def init_trace(itmax: int, shape=(), dtype=torch.float32,
               device=None) -> IterTrace:
    """NaN-filled trace of ``(itmax,) + shape`` per field (``ls_evals``
    zero-filled, ``nu`` of shape ``(itmax,)``) on ``device`` (None:
    CUDA; raises without it)."""
    dev = resolve_device(device)
    full = (itmax,) + tuple(shape)
    nan = lambda s: torch.full(s, float("nan"), dtype=dtype, device=dev)
    return IterTrace(cost=nan(full), grad_norm=nan(full), step=nan(full),
                     ls_evals=torch.zeros(full, dtype=dtype, device=dev),
                     nu=nan((itmax,)))


def write_trace(trace: IterTrace, i: int, *, live=None, cost=None,
                grad_norm=None, step=None, ls_evals=None,
                nu=None) -> IterTrace:
    """Write iteration ``i``'s row in place (``None`` fields keep theirs).
    ``live``: optional per-lane bool mask; lanes outside it keep their
    row.  A Python number is written with ``fill_``, which passes it to
    the kernel as an argument: assigning it (``field[i] = x``) copies it
    from the host and synchronizes the stream on CUDA.  Returns
    ``trace``."""
    for name, val in (("cost", cost), ("grad_norm", grad_norm),
                      ("step", step), ("ls_evals", ls_evals), ("nu", nu)):
        if val is None:
            continue
        row = getattr(trace, name)[i]
        if not isinstance(val, torch.Tensor):
            row.fill_(val)
            continue
        if live is not None:
            val = torch.where(live, val.to(row.dtype), row)
        row.copy_(val)
    return trace


def stack_traces(traces, dim: int = 0) -> IterTrace:
    """Stack same-shape traces field by field on a new axis ``dim``."""
    return IterTrace(*(torch.stack(f, dim) for f in zip(*traces)))


def with_nu(trace: IterTrace, nu) -> IterTrace:
    """``trace`` with every entry of its ``nu`` field set to ``nu`` (a
    robust EM stage records the nu its weights were built with)."""
    return trace._replace(nu=torch.broadcast_to(
        nu.to(trace.nu.dtype), trace.nu.shape).clone())


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _reduce_chunk_axis(name, a):
    """Collapse the trailing hybrid-chunk axis NaN-awarely: total cost /
    line-search evals across chunks, worst-case grad norm / step.  Rows
    where every chunk is NaN (never executed) stay NaN."""
    finite = np.isfinite(a)
    anyf = finite.any(-1)
    if name in ("cost", "ls_evals"):
        red = np.where(finite, a, 0.0).sum(-1)
    else:
        red = np.where(finite, a, -np.inf).max(-1)
    return np.where(anyf, red, np.nan)


def _finite_list(vals):
    return [float(v) if np.isfinite(v) else None for v in vals]


def sage_convergence_records(telemetry) -> list:
    """``SageResult.telemetry`` -> per-cluster convergence records for
    the JSONL event log: one dict per cluster with the finite-filtered
    per-iteration cost/grad_norm/step/ls_evals/nu (EM passes
    concatenated in execution order), plus one record for the joint
    LBFGS (``cluster=None``).  Passes of different solver modes flatten
    independently, so their trace shapes need not agree."""
    if not telemetry:
        return []
    out = []
    per_pass = []
    for tr in telemetry.get("em") or ():
        cost = _host(tr.cost)  # leading axis = cluster
        M = cost.shape[0]
        flat = {}
        for name in tr._fields:
            a = _host(getattr(tr, name))
            if a.ndim == cost.ndim:  # the field carries the chunk axis
                a = _reduce_chunk_axis(name, a)
            flat[name] = a.reshape(M, -1)
        per_pass.append(flat)
    if per_pass:
        for m in range(per_pass[0]["cost"].shape[0]):
            cost = np.concatenate([p["cost"][m] for p in per_pass])
            keep = np.isfinite(cost)
            rec = {"cluster": m, "iterations": int(keep.sum())}
            for name in IterTrace._fields:
                vals = np.concatenate([p[name][m] for p in per_pass])[keep]
                rec[name] = _finite_list(vals)
            out.append(rec)
    lb = telemetry.get("lbfgs")
    if lb is not None:
        cost = _host(lb.cost).reshape(-1)
        keep = np.isfinite(cost)
        rec = {"cluster": None, "solver": "lbfgs",
               "iterations": int(keep.sum())}
        for name in IterTrace._fields:
            vals = _host(getattr(lb, name)).reshape(-1)[keep]
            rec[name] = _finite_list(vals)
        out.append(rec)
    return out


def trace_to_host(trace) -> dict:
    """A (possibly stacked) trace -> plain nested lists for the JSONL
    event log; NaN rows are kept (they mark iterations never run)."""
    if trace is None:
        return {}
    return {name: _host(getattr(trace, name)).tolist()
            for name in trace._fields}
