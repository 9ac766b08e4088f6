"""Consensus-ADMM polynomial math: frequency-smoothness constraints
(counterpart of ``sagecal_tpu/parallel/consensus.py``).

Every routine is a plain function on tensors, batched over clusters;
the frequency sums that the reference's MPI master accumulated from its
workers are sums over the band axis, made in band order by the caller
(``parallel/mesh.py``).

Conventions:
  B: (Nf, Npoly) real basis matrix, row f = basis evaluated at freqs[f].
  Z: (M, Npoly, K) global consensus variable; K = 8N (times the hybrid
     chunks).  The constraint is J_f ~ sum_p B[f,p] Z[:,p].
  rho: (Nf, M) per-frequency, per-cluster regularization.

The pseudo-inverses (:func:`pinv`) drop singular values at or below
``10 * max(m, n) * eps * s_max``, the JAX package's ``jnp.linalg.pinv``
cutoff (``torch.linalg.pinv``'s default is ten times smaller): the Gram
is singular when ``Nf < Npoly`` or a band has zero weight, and the two
cutoffs would give different Z there.  :func:`band_imbalance` and
:func:`consensus_health` are host math on numpy.
"""

from __future__ import annotations

import dataclasses
from math import comb
from typing import Optional

import numpy as np
import torch

# polynomial types (consensus_poly.c:21-28)
POLY_ORDINARY = 0
POLY_NORMALIZED = 1
POLY_BERNSTEIN = 2
POLY_RATIONAL = 3  # [1, (f-f0)/f0, (f0/f-1), ...]


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """Static configuration of the consensus (Z-step) layer; the JAX
    package's fields and defaults.

    ``zstep``: "grouped" (every round solves the full Z from the summed
    numerator) or "reduced" (the transpose-reduced z-step: the numerator
    is kept split over the solution axis in ``nshards`` slices, each
    slice solved on its own, and the active band's target B_f Z gathered
    back from the slices).  ``cluster_groups``: >1 splits each band's
    x-step into that many cluster factor groups.  ``staleness`` /
    ``staleness_discount``: bounded-staleness Z solves (weight
    ``discount**age``, 0 beyond ``staleness`` rounds).
    ``slot_schedule`` / ``group_schedule``: static (nadmm-1,) or
    (nadmm-1, nshards) per-round active slot / cluster group
    (``parallel/admm.py::factor_schedule``); None: the uniform
    rotation."""

    zstep: str = "grouped"
    cluster_groups: int = 1
    staleness: Optional[int] = None
    staleness_discount: float = 1.0
    slot_schedule: Optional[np.ndarray] = None
    group_schedule: Optional[np.ndarray] = None

    @property
    def is_default(self) -> bool:
        return (self.zstep == "grouped" and self.cluster_groups == 1
                and self.staleness is None
                and self.staleness_discount == 1.0
                and self.slot_schedule is None
                and self.group_schedule is None)


def setup_polynomials(freqs, f0: float, Npoly: int,
                      ptype: int = POLY_BERNSTEIN) -> torch.Tensor:
    """Basis matrix B (Nf, Npoly), float64 on the CPU.  Mirrors
    ``setup_polynomials`` (consensus_poly.c:39-186) including the
    Bernstein min/max frequency normalization and the odd/even split of
    the rational type-3 basis."""
    freqs = np.asarray(freqs, np.float64)
    Nf = freqs.shape[0]
    B = np.zeros((Nf, Npoly))
    if ptype in (POLY_ORDINARY, POLY_NORMALIZED):
        frat = (freqs - f0) / f0
        B[:, 0] = 1.0
        for p in range(1, Npoly):
            B[:, p] = B[:, p - 1] * frat
        if ptype == POLY_NORMALIZED:
            nrm = np.sqrt(np.sum(B ** 2, axis=0))
            B = np.where(nrm[None, :] > 0,
                         B / np.where(nrm == 0, 1, nrm)[None, :], 0.0)
    elif ptype == POLY_BERNSTEIN:
        fmax, fmin = freqs.max(), freqs.min()
        x = (freqs - fmin) / max(fmax - fmin, 1e-300)
        n = Npoly - 1
        for p in range(Npoly):
            B[:, p] = comb(n, p) * x ** p * (1.0 - x) ** (n - p)
    elif ptype == POLY_RATIONAL:
        B[:, 0] = 1.0
        frat = (freqs - f0) / f0
        last = frat.copy()
        for p in range(1, Npoly, 2):
            B[:, p] = last
            last = last * frat
        frat = f0 / freqs - 1.0
        last = frat.copy()
        for p in range(2, Npoly, 2):
            B[:, p] = last
            last = last * frat
    else:
        raise ValueError(f"unknown polynomial type {ptype}")
    return torch.from_numpy(B)


def pinv(A: torch.Tensor) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse of (..., m, n) real matrices by the
    SVD with the JAX package's cutoff (module doc)."""
    m, n = A.shape[-2:]
    u, s, vh = torch.linalg.svd(A, full_matrices=False)
    cutoff = 10.0 * max(m, n) * torch.finfo(A.dtype).eps * s[..., :1]
    s_inv = torch.where(s > cutoff, 1.0 / torch.where(s > cutoff, s,
                                                       torch.ones_like(s)),
                        torch.zeros_like(s))
    return vh.transpose(-1, -2) @ (s_inv[..., :, None]
                                   * u.transpose(-1, -2))


def find_prod_inverse(B: torch.Tensor, fratio=None) -> torch.Tensor:
    """pinv(sum_f w_f B_f B_f^T): (Npoly, Npoly).  ``find_prod_inverse``
    (consensus_poly.c:196): weights are the per-frequency unflagged-data
    ratios."""
    w = (torch.ones(B.shape[0], dtype=B.dtype, device=B.device)
         if fratio is None else torch.as_tensor(fratio, dtype=B.dtype,
                                                device=B.device))
    return pinv(torch.einsum("f,fp,fq->pq", w, B, B))


def find_prod_inverse_full(B: torch.Tensor, rho: torch.Tensor,
                           alpha=None) -> torch.Tensor:
    """Per-cluster pinv(sum_f rho[f,m] B_f B_f^T [+ alpha_m I]): (M,
    Npoly, Npoly).  ``find_prod_inverse_full[_fed]``
    (consensus_poly.c:465,547)."""
    P = torch.einsum("fm,fp,fq->mpq", rho, B, B)
    if alpha is not None:
        Np = B.shape[1]
        P = P + alpha[:, None, None] * torch.eye(Np, dtype=B.dtype,
                                                 device=B.device)[None]
    return pinv(P)


def accumulate_z_term(B_f: torch.Tensor, Yrho_f: torch.Tensor) -> torch.Tensor:
    """One frequency's additive contribution to the z right-hand side,
    outer(B_f, Y_f + rho_f J_f): B_f (Npoly,), Yrho_f (M, K) -> (M,
    Npoly, K) (the master's accumulation, sagecal_master.cpp:841-852)."""
    return B_f[None, :, None] * Yrho_f[:, None, :]


def update_global_z(z: torch.Tensor, Bii: torch.Tensor) -> torch.Tensor:
    """Z_m = Bii_m @ z_m: (M, Npoly, K) (``update_global_z_multi``,
    consensus_poly.c:778)."""
    return torch.einsum("mpq,mqk->mpk", Bii, z)


def bz_for_freq(Z: torch.Tensor, B_f: torch.Tensor) -> torch.Tensor:
    """The per-frequency consensus target B_f Z: (M, K) from Z (M, Npoly,
    K) (what the master sends each worker, sagecal_master.cpp:770-800)."""
    return torch.einsum("p,mpk->mk", B_f, Z)


def update_rho_bb(rho, rho_upper, dY, dJ, eps: float = 1e-12,
                  dj_floor: float = 1e-6):
    """Barzilai-Borwein adaptive penalty update per cluster
    (``update_rho_bb``, consensus_poly.c:860-911): spectral steps
    alphaSD = <dY,dY>/<dY,dJ> and alphaMG = <dY,dJ>/<dJ,dJ>, alphaMG if
    2 alphaMG > alphaSD else alphaSD - alphaMG/2, accepted only under
    correlation > 0.2, 0.001 < alpha < upper, and a per-element RMS of dJ
    above ``dj_floor`` (a converged cluster keeps its rho).

    rho, rho_upper: (M,); dY, dJ: (M, K)."""
    ip12 = (dY * dJ).sum(dim=-1)
    ip11 = (dY * dY).sum(dim=-1)
    ip22 = (dJ * dJ).sum(dim=-1)
    one = torch.ones_like(ip12)
    safe12 = torch.where(ip12.abs() < eps, one, ip12)
    corr = ip12 / torch.sqrt(torch.clamp(ip11 * ip22, min=eps))
    alphaSD = ip11 / safe12
    alphaMG = ip12 / torch.where(ip22 < eps, one, ip22)
    alphahat = torch.where(2.0 * alphaMG > alphaSD, alphaMG,
                           alphaSD - 0.5 * alphaMG)
    nk = float(dJ.shape[-1])
    ok = ((ip12 > eps) & (ip11 > eps) & (ip22 > eps)
          & (ip22 > nk * (dj_floor * dj_floor)) & (corr > 0.2)
          & (alphahat > 1e-3) & (alphahat < rho_upper))
    return torch.where(ok, alphahat, rho)


def slot_staleness_ages(active_slot: int, nslots: int) -> torch.Tensor:
    """Ages of every multiplexed slot's stored Yhat right after slot
    ``active_slot`` refreshed: ``(active_slot - s) mod nslots``
    (the Scurrent rotation of sagecal_master.cpp:157-206).  (nslots,)
    int64."""
    return torch.remainder(active_slot - torch.arange(nslots), nslots)


def staleness_weights(ages, staleness: Optional[int] = None,
                      discount: float = 1.0,
                      # JL004: a default for host-side callers; the mesh
                      # passes its data's dtype
                      dtype=torch.float64,  # torchlint: disable=JL004 — see above
                      ) -> torch.Tensor:
    """Per-contribution Z-solve weights: ``discount**age`` within the
    bound, 0 beyond ``staleness`` rounds (None: unbounded).  Applied to
    both the numerator term and that band's rho in the denominator, this
    is a rho-discount of a stale band."""
    ages = torch.as_tensor(ages)
    w = torch.as_tensor(discount, dtype=dtype) ** ages.to(dtype)
    if staleness is not None:
        w = torch.where(ages <= staleness, w, torch.zeros_like(w))
    return w


def soft_threshold(z, lam):
    """Elementwise soft threshold (``soft_threshold_z``,
    consensus_poly.c:1044)."""
    return torch.sign(z) * torch.clamp(z.abs() - lam, min=0.0)


def admm_dual_residual(Z_new, Z_old):
    """Per-real-parameter dual residual ||Z_old - Z_new|| / sqrt(size)
    (sagecal_master.cpp:878-885)."""
    d = (Z_new - Z_old).reshape(-1)
    return torch.linalg.norm(d) / float(d.shape[0]) ** 0.5


def admm_primal_residual(J_flat, BZ_flat):
    """Per-real-parameter primal residual ||J - BZ|| / sqrt(size) of one
    band (a 1-D input) or of each row of a 2-D input (the per-slave
    primal norm of sagecal_master.cpp:869-876)."""
    d = J_flat - BZ_flat
    if d.ndim == 1:
        return torch.linalg.norm(d) / float(d.shape[0]) ** 0.5
    d = d.reshape(d.shape[0], -1)
    return torch.sqrt((d * d).sum(dim=-1)) / float(d.shape[-1]) ** 0.5


def consensus_health(primal_res_band, dual_res_band,
                     trend_thresh: float = 2.0, eps: float = 1e-30,
                     ages=None, staleness: Optional[int] = None):
    """Per-band ADMM consensus health from (nadmm, Nf) residual
    trajectories: ``(ratio (Nf,), trend (Nf,), diverged (Nf,) bool)``,
    numpy.  ``ratio``: final primal / dual residual; ``trend``: final
    primal residual over its trajectory minimum; ``diverged``: any
    non-finite residual or ``trend > trend_thresh``.  With ``ages`` (the
    per-band age at the final round) a stale band's threshold relaxes to
    ``trend_thresh * (1 + age)``, and with ``staleness`` too a band older
    than the bound is diverged outright (starved)."""
    pr = np.asarray(primal_res_band, np.float64)
    du = np.asarray(dual_res_band, np.float64)
    ratio = pr[-1] / np.maximum(du[-1], eps)
    trend = pr[-1] / np.maximum(np.min(pr, axis=0), eps)
    nonfinite = ~(np.all(np.isfinite(pr), axis=0)
                  & np.all(np.isfinite(du), axis=0))
    thresh = np.asarray(trend_thresh, trend.dtype)
    if ages is not None:
        thresh = thresh * (1.0 + np.asarray(ages).astype(trend.dtype))
    diverged = nonfinite | (trend > thresh)
    if ages is not None and staleness is not None:
        diverged = diverged | (np.asarray(ages) > staleness)
    return ratio, trend, diverged


def band_imbalance(band_seconds, eps: float = 1e-30):
    """Per-band work-imbalance gauges ``(ratio, skew, argmax)``: the
    slowest/median ratio (the straggler gauge: a collective over bands
    runs at the pace of the slowest, so ratio ~1 wastes nothing), the
    relative skew ``(max - mean) / mean`` and the index of the slowest
    band.  ``band_seconds``: (Nf,) per-band wall seconds, real or
    attributed.  The median of an even count averages the two middle
    values (numpy's, as the JAX package's ``jnp.median``)."""
    t = np.asarray(band_seconds, dtype=np.float64)
    med = np.median(t)
    mean = np.mean(t)
    ratio = np.max(t) / max(med, eps)
    skew = (np.max(t) - mean) / max(mean, eps)
    return float(ratio), float(skew), int(np.argmax(t))
