"""Bounded-staleness consensus rounds for the host-driven band ADMM
(counterpart of ``sagecal_tpu/parallel/async_consensus.py``).

The minibatch consensus loop (``apps/minibatch.py``) runs its band
x-steps one after another, so a flag-skewed band makes every synchronous
round as expensive as its heaviest member.  Here each band refreshes its
basis-sized Gram contribution ``B_f^T (Y_f + rho_f J_f)`` on its own
deterministic period; the Z solve takes the freshest stored term of
every band with a ``discount**age`` rho-weighting, and a term older than
``staleness`` rounds drops out (the band is starved, which the watchdog
of ``consensus.consensus_health`` flags).

The periods are a pure function of the per-band work weights and the
bound, the round counter advances by one a round, and the ledger (ages,
stored terms, counter) is plain numpy, so a run is reproducible.
``staleness = 0`` gives periods of all ones: every band refreshes every
round, the synchronous loop.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def refresh_periods(band_weights: Sequence[float],
                    staleness: int) -> np.ndarray:
    """Per-band refresh periods from work weights (unflagged-row
    counts): the lightest band refreshes every round, a band of ``k``
    times its work every ``round(k)`` rounds, capped at ``staleness +
    1``.  ``staleness <= 0``: all ones."""
    w = np.asarray([max(float(x), 0.0) for x in band_weights], float)
    n = w.size
    if n == 0:
        return np.zeros((0,), np.int64)
    if staleness <= 0:
        return np.ones((n,), np.int64)
    pos = w[w > 0]
    unit = float(pos.min()) if pos.size else 1.0
    rel = np.where(w > 0, w / max(unit, 1e-30), 1.0)
    return np.clip(np.rint(rel).astype(np.int64), 1, int(staleness) + 1)


def band_active(round_index: int, periods: np.ndarray) -> np.ndarray:
    """Which bands refresh in round ``round_index`` (bool per band);
    offsets staggered by band index."""
    per = np.asarray(periods, np.int64)
    idx = np.arange(per.size)
    return (round_index % per) == (idx % per)


class StalenessLedger:
    """Ages and stored Gram terms of an async consensus run.

    ``ages[b]``: rounds since band ``b`` last refreshed ``zterms[b]``
    ((M, Npoly, K) each); -1 and a zero term for a band that has not
    contributed yet (excluded from the Z solve).  The ledger and the
    round counter are the whole async state (``to_arrays`` /
    ``from_arrays``)."""

    def __init__(self, nbands: int, zshape, dtype, round_index: int = 0):
        self.ages = np.full((nbands,), -1, np.int64)
        self.zterms = np.zeros((nbands,) + tuple(zshape), dtype)
        self.round_index = int(round_index)

    def record(self, band: int, zterm) -> None:
        """Band ``band`` refreshed this round: store its fresh term."""
        if isinstance(zterm, torch.Tensor):
            zterm = zterm.detach().cpu().numpy()
        self.zterms[band] = np.asarray(zterm)
        self.ages[band] = 0

    def advance(self) -> None:
        """Close the round: every previously-seen term ages by one."""
        self.ages = np.where(self.ages >= 0, self.ages + 1, self.ages)
        self.round_index += 1

    def weights(self, staleness: Optional[int],
                discount: float = 1.0) -> np.ndarray:
        """Per-band Z-solve weights: ``discount**age`` within the bound,
        0 for never-seen or over-age terms."""
        ages = np.maximum(self.ages, 0)
        w = np.asarray(discount, float) ** ages
        w = np.where(self.ages < 0, 0.0, w)
        if staleness is not None:
            w = np.where(ages > int(staleness), 0.0, w)
        return w

    def to_arrays(self, prefix: str = "ledger") -> dict:
        return {
            f"{prefix}.ages": self.ages.copy(),
            f"{prefix}.zterms": self.zterms.copy(),
            f"{prefix}.round": np.asarray([self.round_index], np.int64),
        }

    @classmethod
    def from_arrays(cls, arrs: dict, prefix: str = "ledger",
                    dtype=None) -> "StalenessLedger":
        z = np.asarray(arrs[f"{prefix}.zterms"])
        led = cls(z.shape[0], z.shape[1:], dtype or z.dtype,
                  round_index=int(np.asarray(arrs[f"{prefix}.round"])[0]))
        led.zterms = z.astype(dtype) if dtype is not None else z.copy()
        led.ages = np.asarray(arrs[f"{prefix}.ages"], np.int64).copy()
        return led

    @staticmethod
    def present(arrs: dict, prefix: str = "ledger") -> bool:
        return f"{prefix}.zterms" in arrs


def stale_weighted_z(ledger: StalenessLedger, B: torch.Tensor,
                     rho: torch.Tensor, weights) -> torch.Tensor:
    """The rho-discounted Z solve over the ledger's stored terms: num =
    sum_f w_f zterm_f, P_m = sum_f w_f rho[f,m] B_f B_f^T, Z = pinv(P)
    num (the synchronous ``consensus.update_global_z`` when every weight
    is 1).  With every band starved (all weights 0) the unweighted solve.
    ``B`` (Nf, Npoly), ``rho`` (Nf, M) on one device, ``weights``
    (Nf,)."""
    from sagecal_tpu_torch.parallel import consensus

    w = np.asarray(weights, float)
    if not np.any(w > 0):
        w = np.ones_like(w)
    wt = torch.as_tensor(w, dtype=B.dtype, device=B.device)
    num = torch.einsum("f,fmpk->mpk", wt,
                       torch.as_tensor(ledger.zterms, dtype=B.dtype,
                                       device=B.device))
    Bii = consensus.find_prod_inverse_full(B, wt[:, None] * rho)
    return consensus.update_global_z(num, Bii)
