"""The comparison that decides ``correct``: the program's outputs against
the plain reference (:mod:`benchmark.reference.rime`), at the sizes the
window ran.

The reference forms its own coherencies from the sky the benchmark made,
in float64, and reads of the program only what it judges: the
solutions files and the residual or subtracted column the app wrote,
and the (res_0, res_1) it returned for each tile.

- ``resid_gap``: the column the app wrote (the residual through #1, or
  the sky subtracted with known gains) against the data less the
  reference's model for the gains the app wrote, ``|out - ref| /
  |ref|`` over a tile's compared rows (the residual's own scale, so a
  residual changed by 2% reads 0.02), the largest over tiles and runs.
  It covers the full-channel coherencies, the written gains and #1.
- ``cost_gap``: the residual norms the app returned for each tile (the
  start and the solution, on the channel-averaged data the solve sees)
  against the reference's from the same gains, the larger relative gap,
  the largest over tiles and runs.  It covers the averaged coherencies
  and the solve's own account of its cost.
- ``tile_res_ratio``: the reference's residual norm of the written
  gains over that of the gains the tile started from (identity for a
  run's first tile, the previous tile's solution after it), the largest
  over tiles and runs.  Its limit is the configurations' guarantee that
  every tile's solve lowers the residual (SAGECal's LM reports a
  regression as a failure), so it must stay below 1: a solve that
  returns its state unchanged reads exactly 1.
- ``fit_cost_gap`` and ``fit_grad_gap``: the joint LBFGS's cost and
  gradient (#3 and #4 on the card) as the program returned them for the
  calls that :class:`benchmark.harness.fullbatch.FitRecorder` sampled
  on the timed path (each tile's first, at the EM's gains, and one
  drawn from the seed), against the reference's cost and float64
  gradient at the same parameters and the same nu, on the reference's
  own channel-averaged coherencies and data: ``|c - c_ref| / |c_ref|``
  and ``|g - g_ref| / max(|g_ref|, |g_ref0|)``, g_ref0 the reference's
  gradient at the fit's first call, the largest over samples.  (Float32
  rounding of the gradient's sums is of the size of the terms summed,
  not of their sum, so against a later call's own, smaller gradient the
  gap grows as the fit converges; against the start's it does not.)  A
  tile whose solve made no such call (the joint fit skipped) reads
  infinity.  The nu is the program's own (its EM's estimate): the
  reference follows the fit from the program's state there.
- ``fit_drop``: the reference's joint cost of the written gains over
  that of the fit's first call, the largest over the tiles the app did
  not reset.  Its limit is the fit's guarantee (its line search accepts
  only steps that lower the cost), so it must stay below 1: a fit that
  returns its start unchanged reads 1.
- ``res_ratio`` (an end-to-end metric, not a check): the sum over tiles
  of the first norm over the sum of the second.  ``fit_grad_gap_own``
  (no limit, logged): the gradient gap against each call's own norm.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from benchmark.harness.inputs import Observation, read_solutions
from benchmark.reference import rime

BANNED = ("jax", "jaxlib", "flax", "sagecal_tpu")


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's, its libraries' or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in BANNED)


def _rows(obs: Observation, t0: int, t1: int, dev):
    """u, v, w (seconds, float64) and station indices of timeslots
    [t0, t1), baseline fastest."""
    sl = slice(t0 * obs.nbase, t1 * obs.nbase)
    f = lambda a: torch.as_tensor(a[sl] / rime.C_LIGHT,  # noqa: E731
                                  dtype=torch.float64, device=dev)
    n = t1 - t0
    ap = torch.as_tensor(np.tile(obs.ant_p, n), device=dev)
    aq = torch.as_tensor(np.tile(obs.ant_q, n), device=dev)
    return f(obs.u), f(obs.v), f(obs.w), ap, aq


def _flat(x: np.ndarray, dev) -> torch.Tensor:
    """(rows, F, 2, 2) -> (F, 4, rows) complex128."""
    t = torch.as_tensor(x, device=dev).to(torch.complex128)
    return t.reshape(t.shape[0], t.shape[1], 4).permute(1, 2, 0)


def _norm(x: torch.Tensor) -> float:
    return float(torch.sqrt((x.real ** 2 + x.imag ** 2).sum()))


def tables(obs: Observation, dev) -> list:
    return [rime.source_table(c, obs.ra0, obs.dec0, dev)
            for c in obs.clusters]


def column_gap(obs: Observation, tabs: list, gains: torch.Tensor, t0: int,
               t1: int, out: np.ndarray, dev) -> float:
    """|out - ref| / |ref| over timeslots [t0, t1), ref the data less
    the model of ``gains`` (K, N, 2, 2) at full channel resolution."""
    u, v, w, ap, aq = _rows(obs, t0, t1, dev)
    fr = torch.as_tensor(obs.freqs, dtype=torch.float64, device=dev)
    coh = rime.tile_coherencies(tabs, u, v, w, fr, obs.chan_width)
    ref = _flat(obs.read("vis", t0, t1), dev) - rime.model(coh, gains, ap, aq)
    return _norm(_flat(out, dev) - ref) / _norm(ref)


def fit_numbers(fit, coh, avg, ap, aq) -> tuple:
    """(largest cost gap, largest gradient gap, largest gradient gap
    against each call's own gradient, reference cost of the fit's first
    call) of one tile's sampled joint-fit calls (module doc); a fit with
    no sample reads infinity."""
    samples = [s for s in (fit or {}).get("samples", ()) if s is not None]
    if not samples or any(s["grad"] is None for s in samples):
        return math.inf, math.inf, math.inf, None
    nu = None if fit["nu"] is None else float(fit["nu"])
    K = coh.shape[0]
    cgap = ggap = own = 0.0
    first = norm0 = None
    for s in samples:
        p = s["p"].to(coh.device, torch.float64).reshape(K, -1)
        c_ref, g_ref = rime.joint_cost_and_grad(coh, avg, p, nu, ap, aq)
        g = s["grad"].to(coh.device, torch.float64).reshape(K, -1)
        err, norm = float((g - g_ref).norm()), float(g_ref.norm())
        if first is None:
            first, norm0 = c_ref, norm
        cgap = max(cgap, abs(float(s["cost"]) - c_ref) / abs(c_ref))
        ggap = max(ggap, err / max(norm, norm0))
        own = max(own, err / norm)
    return cgap, ggap, own, first


def calibrate_numbers(obs: Observation, runs: list, dev) -> dict:
    """``runs``: per app run {"results": [(res0, res1)] a tile, "gains":
    the written solutions (T, K, N, 2, 2), "diverged": the tiles the
    app reset, "columns": {timeslots (t0, t1): (rows, F, 2, 2) array},
    "fits": the sampled joint-fit calls of each tile in order}."""
    tabs = tables(obs, dev)
    T = obs.tilesz
    eye = torch.eye(2, dtype=torch.complex128, device=dev).expand(
        obs.nclusters, obs.nstations, 2, 2)
    gains = [torch.as_tensor(r["gains"], device=dev) for r in runs]
    nums = {k: 0.0 for k in ("resid_gap", "cost_gap", "tile_res_ratio",
                             "fit_cost_gap", "fit_grad_gap", "fit_drop",
                             "fit_grad_gap_own")}
    sum0 = sum1 = 0.0
    fr0 = torch.tensor([obs.freq0], dtype=torch.float64, device=dev)
    for t in range(obs.ntiles):
        u, v, w, ap, aq = _rows(obs, t * T, (t + 1) * T, dev)
        data = obs.read("vis", t * T, (t + 1) * T)
        avg = _flat(data.astype(np.complex128).mean(axis=1, keepdims=True),
                    dev)
        coh = rime.tile_coherencies(tabs, u, v, w, fr0, obs.bandwidth)
        for i, run in enumerate(runs):
            start = eye if t == 0 else gains[i][t - 1]
            r0 = float(rime.residual_norm(avg - rime.model(coh, start, ap,
                                                           aq)))
            res1 = avg - rime.model(coh, gains[i][t], ap, aq)
            r1 = float(rime.residual_norm(res1))
            sum0, sum1 = sum0 + r0, sum1 + r1
            nums["tile_res_ratio"] = max(nums["tile_res_ratio"], r1 / r0)
            fits = run.get("fits", [])
            cg, gg, own, first = fit_numbers(
                fits[t] if t < len(fits) else None, coh, avg, ap, aq)
            nums["fit_cost_gap"] = max(nums["fit_cost_gap"], cg)
            nums["fit_grad_gap"] = max(nums["fit_grad_gap"], gg)
            nums["fit_grad_gap_own"] = max(nums["fit_grad_gap_own"], own)
            if t not in run["diverged"]:
                p0, p1 = run["results"][t]
                nums["cost_gap"] = max(nums["cost_gap"], abs(p0 - r0) / r0,
                                       abs(p1 - r1) / r1)
                if first is not None:
                    nu = fits[t]["nu"]
                    end = float(rime.robust_cost(res1, float(nu))
                                if nu is not None
                                else (res1.real ** 2 + res1.imag ** 2).sum())
                    nums["fit_drop"] = max(nums["fit_drop"], end / first)
            del res1
        del coh, avg
        for i, run in enumerate(runs):
            for (a, b), out in run["columns"].items():
                if t * T <= a < (t + 1) * T:
                    nums["resid_gap"] = max(nums["resid_gap"], column_gap(
                        obs, tabs, gains[i][t], a, b, out, dev))
    nums["res_ratio"] = sum1 / sum0
    return nums


def subtract_numbers(obs: Observation, runs: list, dev) -> dict:
    """``runs``: per app run {"columns": {(t0, t1): array}}; the gains
    are the true ones the app was given (``-q``)."""
    tabs = tables(obs, dev)
    truth = torch.as_tensor(read_solutions(obs.truth_path, obs.nstations),
                            device=dev)
    T, gap = obs.tilesz, 0.0
    for run in runs:
        for (a, b), out in run["columns"].items():
            gap = max(gap, column_gap(obs, tabs, truth[a // T], a, b, out,
                                      dev))
    return {"resid_gap": gap}


def judged(numbers: dict, limits: dict) -> list:
    """(name, value, limit) of every number that has a limit."""
    return [(k, numbers[k], limits[k]) for k in limits]


def is_correct(checks: list) -> bool:
    """Every number below its limit (strictly: a stated limit of 1 on a
    ratio is the guarantee that the ratio falls)."""
    return bool(checks) and all(
        math.isfinite(v) and v < lim for _, v, lim in checks)
