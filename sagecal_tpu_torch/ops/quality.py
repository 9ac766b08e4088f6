"""Calibration-quality reductions on the device (counterpart of
``sagecal_tpu/ops/quality.py``).

A solve asked for quality (``collect_quality=True``) returns a
:class:`SolveQuality` of fixed-shape tensors beside its solution; with
the flag off nothing here runs.  Three families, as in the reference:

- chi^2 attribution (:func:`row_chi2` + :func:`chi2_scatter`): the
  solver's own squared residual per station, per baseline and per
  hybrid chunk, with ``sum(chi2_baseline) == sum(chi2_chunk)`` and
  ``sum(chi2_station) == 2 * sum(chi2_chunk)`` (every baseline row
  charges both of its stations);
- robust-noise statistics (:func:`weight_stats`): a histogram of the
  normalized Student's-t weights, the down-weighted and flagged
  fractions;
- gain health (:func:`gain_health`): non-finite count, per-station
  amplitude, its spread across lanes, circular phase spread and
  departure from identity.

The reference scatters with ``.at[].add``.  Here every sum by
destination is a fixed-order segment sum (``core/segment.py``, through
the solver's ``NormalEqPlan``) or a dense reduction, never a float
atomic: quality repeats bit for bit on CUDA, as the solve does.  Given
the solver's plan, nothing here reads back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sagecal_tpu_torch.core.types import params_to_jones

# Fixed weight-histogram bin count (part of the output shape).
WEIGHT_HIST_BINS = 16
# A normalized Student's-t weight below this marks the visibility as
# effectively down-weighted (w = (nu+1)/(nu+e^2) scaled to [0, 1]).
DOWNWEIGHT_THRESH = 0.5


class SolveQuality(NamedTuple):
    """Quality outputs of one solve; a solver fills the subset it can
    see and leaves the rest None."""

    chi2_station: Optional[torch.Tensor] = None   # (N,)
    chi2_baseline: Optional[torch.Tensor] = None  # (N, N), rows at (p, q)
    chi2_chunk: Optional[torch.Tensor] = None     # (nchunk,) == solver cost
    nonfinite_count: Optional[torch.Tensor] = None    # () count in p
    station_amp: Optional[torch.Tensor] = None        # (N,) mean |J|_F/sqrt2
    station_amp_spread: Optional[torch.Tensor] = None   # (N,) std over lanes
    station_phase_spread: Optional[torch.Tensor] = None  # (N,) circular
    identity_departure: Optional[torch.Tensor] = None    # (N,) mean |J-I|
    nu: Optional[torch.Tensor] = None             # () final Student's-t nu
    weight_hist: Optional[torch.Tensor] = None    # (WEIGHT_HIST_BINS,)
    downweighted_frac: Optional[torch.Tensor] = None  # () of unflagged
    flagged_frac: Optional[torch.Tensor] = None       # () of all elements


def stack_quality(qs, dim: int = 0) -> SolveQuality:
    """Stack same-layout :class:`SolveQuality` bundles field by field on
    a new axis ``dim`` (None fields stay None)."""
    return SolveQuality(*(None if f[0] is None else torch.stack(f, dim)
                          for f in zip(*qs)))


def row_chi2(e: torch.Tensor) -> torch.Tensor:
    """Per-row chi^2 of a real residual block (..., F, 8, rows) (mask
    and sqrt-weights applied: the solver's objective density)."""
    return (e * e).sum(dim=(-3, -2))


def chi2_scatter(row, ant_p, ant_q, chunk_map, n_stations: int,
                 n_chunks: int, plan=None):
    """Per-row chi^2 ``row`` (rows,) -> (chi2_station (N,), chi2_baseline
    (N, N), chi2_chunk (n_chunks,)).

    ``plan``: the solver's ``solvers.lm.NormalEqPlan`` of these rows
    (built here when None; that reads its widths back to the host).
    Station and baseline sums add the plan's chunks together, so a plan
    of any chunk map serves them; ``chi2_chunk`` uses the plan's chunk sums when
    ``n_chunks == plan.nchunk`` (the plan must then be of ``chunk_map``)
    and the total when ``n_chunks == 1``."""
    if plan is None:
        from sagecal_tpu_torch.solvers.lm import NormalEqPlan

        plan = NormalEqPlan(ant_p, ant_q, chunk_map, n_chunks, n_stations)
    N, nc = plan.N, plan.nchunk
    st = plan.station.sum(torch.cat([row, row])).reshape(nc, N).sum(0)
    bl = plan.pair.sum(torch.cat([row, torch.zeros_like(row)]))
    bl = bl.reshape(nc, N, N).sum(0)
    if n_chunks == nc:
        ch = plan.cost.sum(row)
    elif n_chunks == 1:
        ch = row.sum().reshape(1)
    else:
        raise ValueError(f"{n_chunks} chunks against a plan of {nc}")
    return st, bl, ch


def weight_stats(sqrt_w, nu, mask8, dof: float = 1.0):
    """Student's-t weight statistics of one solve: ``sqrt_w`` the sqrt
    IRLS weights w = (nu+dof)/(nu+e^2), ``mask8`` a broadcastable 0/1
    validity; ``dof`` 1 for the LM family, 2 for the RTR family.
    Returns (weight_hist (WEIGHT_HIST_BINS,), downweighted_frac (),
    flagged_frac ()); the histogram counts unflagged elements of the
    weights normalized to [0, 1] by their maximum (nu+dof)/nu."""
    w = sqrt_w * sqrt_w
    wn = torch.clamp(w * (nu / (nu + dof)), 0.0, 1.0)
    m = torch.broadcast_to(torch.as_tensor(mask8, dtype=wn.dtype), wn.shape)
    idx = torch.clamp((wn * WEIGHT_HIST_BINS).to(torch.int32), 0,
                      WEIGHT_HIST_BINS - 1).reshape(-1)
    bins = torch.arange(WEIGHT_HIST_BINS, dtype=torch.int32, device=wn.device)
    # a dense compare-and-sum per bin: fixed order, no atomics
    hist = ((idx[None, :] == bins[:, None]) * m.reshape(1, -1)).sum(dim=1)
    n_valid = torch.clamp(m.sum(), min=1.0)
    downweighted = (m * (wn < DOWNWEIGHT_THRESH)).sum() / n_valid
    flagged = 1.0 - m.sum() / m.numel()
    return hist, downweighted, flagged


def gain_health(p):
    """Gain health of a parameter block ``p`` (..., 8N); every leading
    axis (clusters, chunk lanes) is a lane.  Returns (nonfinite_count (),
    station_amp (N,), station_amp_spread (N,), station_phase_spread (N,),
    identity_departure (N,)): amplitude ||J||_F / sqrt2 (1 for identity)
    and its std across lanes, 1 - |mean resultant| of the J00 phase
    across lanes, and mean ||J - I||_F / sqrt2.  Non-finite parameters
    are counted, then zeroed before the summaries."""
    dt = p.dtype
    fin = torch.isfinite(p)
    nonfinite = (~fin).sum().to(dt)
    J = params_to_jones(torch.where(fin, p, torch.zeros_like(p)))
    lanes = J.reshape((-1,) + tuple(J.shape[-3:]))  # (L, N, 2, 2)
    amp = torch.sqrt((lanes.abs() ** 2).sum(dim=(-2, -1)) / 2.0)  # (L, N)
    station_amp = amp.mean(dim=0)
    station_amp_spread = amp.std(dim=0, correction=0)
    phase = torch.angle(lanes[..., 0, 0])
    resultant = torch.complex(torch.cos(phase), torch.sin(phase)).mean(
        dim=0).abs()
    eye = torch.eye(2, dtype=lanes.dtype, device=lanes.device)
    dep = torch.sqrt(((lanes - eye).abs() ** 2).sum(dim=(-2, -1)) / 2.0)
    return (nonfinite, station_amp.to(dt), station_amp_spread.to(dt),
            (1.0 - resultant).to(dt), dep.mean(dim=0).to(dt))


def residual_quality(e, p, ant_p, ant_q, chunk_map, n_chunks: int, nu=None,
                     sqrt_w=None, mask8=None, weight_dof: float = 1.0,
                     plan=None) -> SolveQuality:
    """The quality bundle of the LM-family and RTR-family solvers.

    ``e``: the final (F, 8, rows) real residual (weights applied); ``p``:
    (..., 8N) final parameters; ``plan``: the solver's ``NormalEqPlan``
    (see :func:`chi2_scatter`).  Robust solvers add ``nu``/``sqrt_w``/
    ``mask8`` (and ``weight_dof``, see :func:`weight_stats`) for the
    weight statistics."""
    chi2_st, chi2_bl, chi2_ch = chi2_scatter(
        row_chi2(e), ant_p, ant_q, chunk_map, p.shape[-1] // 8, n_chunks,
        plan)
    nonfinite, amp, amp_sp, ph_sp, dep = gain_health(p)
    q = SolveQuality(
        chi2_station=chi2_st, chi2_baseline=chi2_bl, chi2_chunk=chi2_ch,
        nonfinite_count=nonfinite, station_amp=amp,
        station_amp_spread=amp_sp, station_phase_spread=ph_sp,
        identity_departure=dep)
    if nu is not None and sqrt_w is not None:
        hist, down, flag = weight_stats(
            sqrt_w, nu, mask8 if mask8 is not None else torch.ones_like(sqrt_w),
            dof=weight_dof)
        q = q._replace(nu=torch.as_tensor(nu).to(e.dtype), weight_hist=hist,
                       downweighted_frac=down, flagged_frac=flag)
    return q
