"""Robust Student's-t noise model: EM weights and nu estimation
(counterpart of ``sagecal_tpu/solvers/robust.py``).

The E-step computes per-residual-element weights w = (nu+1)/(nu + e^2),
the M-step is a weighted LM solve with sqrt(w)-scaled residuals, and nu
is re-estimated by a digamma-score grid search over [nulow, nuhigh]
(Nd = 30 points, argmin |score|).  ``jax.scipy.special.digamma`` becomes
``torch.special.digamma``; the EM ``scan`` is a Python loop.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.special import digamma

from sagecal_tpu_torch.solvers.lm import LMConfig, _residual_flat, lm_solve
from sagecal_tpu_torch.utils.precision import true_f32


def _nu_grid(nulow, nuhigh, Nd, like):
    deltanu = (nuhigh - nulow) / Nd
    return nulow + deltanu * torch.arange(Nd, dtype=like.dtype,
                                          device=like.device)


def update_w_and_nu(ed, nu0, nulow: float = 2.0, nuhigh: float = 30.0,
                    Nd: int = 30, mask: Optional[torch.Tensor] = None):
    """E-step + nu grid search.  ed: residual elements (reals).  Returns
    (sqrt_w of ed's shape, new scalar nu as a 0-d tensor) with nu the grid
    point minimizing |psi((nu+1)/2) - ln((nu+1)/2) - psi(nu/2) + ln(nu/2)
    + mean(ln w - w) + 1|.  ``mask`` restricts the mean to valid elements
    (flagged data carries w = 1)."""
    w = (nu0 + 1.0) / (nu0 + ed * ed)
    q = w - torch.log(w)
    if mask is not None:
        mfull = torch.broadcast_to(mask, w.shape)
        msum = torch.clamp(mfull.sum(), min=1.0)
        sumq = (q.abs() * mfull).sum() / msum
        w = torch.where(mfull > 0, w, torch.ones_like(w))
    else:
        sumq = q.abs().mean()
    grid = _nu_grid(nulow, nuhigh, Nd, ed)
    score = (digamma(grid * 0.5 + 0.5) - torch.log((grid + 1.0) * 0.5)
             - digamma(grid * 0.5) + torch.log(grid * 0.5) - sumq + 1.0)
    nu = grid[torch.argmin(score.abs())]
    return torch.sqrt(w), nu


def update_nu_aecm(logsumw, nu_old, p: int = 8, nulow: float = 2.0,
                   nuhigh: float = 30.0, Nd: int = 30):
    """AECM nu update: the grid point solving psi((nu_old+p)/2)
    - ln((nu_old+p)/2) - psi(nu/2) + ln(nu/2) + logsumw + 1 = 0, with
    logsumw = mean(ln w_i - w_i)."""
    nu_old = torch.as_tensor(nu_old)
    dgm = digamma((nu_old + p) * 0.5) - torch.log((nu_old + p) * 0.5)
    grid = _nu_grid(nulow, nuhigh, Nd, nu_old)
    score = -digamma(grid * 0.5) + torch.log(grid * 0.5) + logsumw + dgm + 1.0
    return grid[torch.argmin(score.abs())]


@true_f32
def robust_lm_solve(vis, coh, mask, ant_p, ant_q, chunk_map, p0,
                    nu0: float = 2.0, nulow: float = 2.0, nuhigh: float = 30.0,
                    em_iters: int = 3, config: LMConfig = LMConfig()):
    """Robust LM: EM over (weights, nu) wrapping weighted LM solves.
    Returns (LMResult, nu).  The E-step runs FIRST, from the residual at
    p0, so gross outliers are down-weighted before the first fit."""
    mask8 = mask[..., None, :]
    ed0 = _residual_flat(p0, coh, vis, mask, ant_p, ant_q, chunk_map, None)
    sqrt_w, nu = update_w_and_nu(
        ed0, torch.as_tensor(nu0, dtype=p0.dtype, device=p0.device),
        nulow, nuhigh, mask=mask8)
    p = p0
    for _ in range(em_iters):
        res = lm_solve(vis, coh, mask, ant_p, ant_q, chunk_map, p, config,
                       sqrt_weights=sqrt_w)
        p = res.p
        ed = _residual_flat(p, coh, vis, mask, ant_p, ant_q, chunk_map, None)
        sqrt_w, nu = update_w_and_nu(ed, nu, nulow, nuhigh, mask=mask8)
    res = lm_solve(vis, coh, mask, ant_p, ant_q, chunk_map, p, config,
                   sqrt_weights=sqrt_w)
    return res, nu
