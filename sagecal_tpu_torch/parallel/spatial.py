"""Model-order selection of the consensus polynomials (counterpart of
``sagecal_tpu/parallel/spatial.py``).

Only :func:`minimum_description_length` (``mdl.c``, the master's ``-M``
scan that the distributed app runs under ``--mdl``) is ported so far;
the spatial regularization of the consensus (FISTA over a spatial basis,
the diffuse-sky constraint) belongs to ROADMAP.md's A7.  Host math in
float64 on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sagecal_tpu_torch.parallel import consensus


def minimum_description_length(
    J, rho, freqs, freq0: float, weight=None,
    polytype: int = consensus.POLY_BERNSTEIN,
    Kstart: int = 1, Kfinish: int = 5,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Scan consensus polynomial orders and score AIC/MDL
    (``minimum_description_length``, mdl.c:43-260).

    J: (F, M, K) rho-scaled solutions (the master's weight*rho*J blocks);
    rho: (M,); weight: (F,) per-frequency unflagged fractions.  Returns
    (aic, mdl, best_aic_order, best_mdl_order)."""
    J = torch.as_tensor(np.asarray(J, np.float64))
    F, M, K = J.shape
    rho = torch.as_tensor(np.asarray(rho, np.float64))
    w = (torch.ones(F, dtype=torch.float64) if weight is None
         else torch.as_tensor(np.asarray(weight, np.float64)))
    inv_rho = torch.where(rho > 0, 1.0 / torch.where(rho == 0, 1.0, rho), 0.0)
    w3 = w[:, None, None]
    inv_w = torch.where(w3 > 0, 1.0 / torch.clamp(w3, min=1e-30), 0.0)
    orders = list(range(Kstart, Kfinish + 1))
    aic, mdl = [], []
    for Npoly in orders:
        ptype = consensus.POLY_NORMALIZED if Npoly == 1 else polytype
        B = consensus.setup_polynomials(np.asarray(freqs), freq0, Npoly,
                                        ptype)
        Bi = consensus.find_prod_inverse(B, w)  # (Npoly, Npoly)
        z = torch.einsum("fp,fmk->mpk", B, J) * inv_rho[:, None, None]
        Z = torch.einsum("pq,mqk->mpk", Bi, z)
        BZ = torch.einsum("fp,mpk->fmk", B, Z)
        scaled = BZ * (rho[None, :, None] * w3)
        res = (J - scaled) * (inv_rho[None, :, None] * inv_w)
        RSS = float((res ** 2).sum()) / (K * M)
        aic.append(F * np.log(RSS / F) + 2.0 * Npoly)
        mdl.append(0.5 * F * np.log(RSS / F) + 0.5 * Npoly * np.log(F))
    aic = np.asarray(aic)
    mdl = np.asarray(mdl)
    return aic, mdl, orders[int(np.argmin(aic))], orders[int(np.argmin(mdl))]
