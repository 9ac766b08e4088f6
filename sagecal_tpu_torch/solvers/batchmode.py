"""Minibatch (stochastic) joint LBFGS fits over visibility data
(counterpart of ``sagecal_tpu/solvers/batchmode.py``).

``bfgsfit_minibatch`` and ``bfgsfit_minibatch_consensus`` solve all
clusters' parameters jointly by LBFGS on one minibatch of
(multi-channel) data; curvature pairs and gradient-variance statistics
persist ACROSS minibatches through :class:`LBFGSMemory` (the C
reference's ``persistent_data_t``).  The consensus variant adds the
scaled-Lagrangian terms y^T (p - BZ) + rho/2 ||p - BZ||^2 per cluster.

The cost is the torch-op full-model predict (``predict_full_model``)
and its gradient comes from autograd, as the reference takes it from
autodiff of its one cost.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sagecal_tpu_torch.core.types import VisData
from sagecal_tpu_torch.solvers.lbfgs import LBFGSMemory, lbfgs_fit
from sagecal_tpu_torch.solvers.sage import ClusterData, predict_full_model
from sagecal_tpu_torch.utils.precision import true_f32


def _data_cost(pflat, data: VisData, cdata: ClusterData, shape, robust_nu):
    pa = pflat.reshape(shape)
    model = predict_full_model(pa, cdata, data)
    diff = (data.vis - model) * data.mask[..., None, :]
    e2 = diff.real ** 2 + diff.imag ** 2
    if robust_nu is not None:
        return torch.log1p(e2 / robust_nu).sum()
    return e2.sum()


def _fit(cost, p0, memory, itmax, lbfgs_m):
    pflat = p0.reshape(-1)
    if memory is None:
        memory = LBFGSMemory.init(pflat.shape[0], lbfgs_m, pflat.dtype,
                                  pflat.device)
    fit = lbfgs_fit(cost, None, pflat, itmax=itmax, M=lbfgs_m, memory=memory,
                    minibatch=True)
    return fit.p.reshape(p0.shape), fit.memory


@true_f32
def bfgsfit_minibatch(data: VisData, cdata: ClusterData, p0,
                      memory: Optional[LBFGSMemory] = None, itmax: int = 10,
                      lbfgs_m: int = 7, robust_nu: Optional[float] = None,
                      ) -> Tuple[torch.Tensor, LBFGSMemory]:
    """One minibatch joint LBFGS step (``bfgsfit_minibatch_visibilities``).

    ``p0``: (M, nchunk_max, 8N), on the device of ``data``.  Returns
    (p_new, memory): thread the memory into the next minibatch call."""
    shape = p0.shape
    return _fit(lambda pf: _data_cost(pf, data, cdata, shape, robust_nu),
                p0, memory, itmax, lbfgs_m)


@true_f32
def bfgsfit_minibatch_consensus(data: VisData, cdata: ClusterData, p0, Y, BZ,
                                rho, memory: Optional[LBFGSMemory] = None,
                                itmax: int = 10, lbfgs_m: int = 7,
                                robust_nu: Optional[float] = None,
                                ) -> Tuple[torch.Tensor, LBFGSMemory]:
    """Consensus variant (``bfgsfit_minibatch_consensus``): adds
    y^T (p - BZ) + rho/2 ||p - BZ||^2 to the minibatch cost.
    ``Y``/``BZ``: (M, nchunk_max, 8N); ``rho``: (M,)."""
    shape = p0.shape

    def cost(pf):
        d = pf.reshape(shape) - BZ
        aug = (Y * d).sum() + 0.5 * (rho[:, None, None] * d * d).sum()
        return _data_cost(pf, data, cdata, shape, robust_nu) + aug

    return _fit(cost, p0, memory, itmax, lbfgs_m)
