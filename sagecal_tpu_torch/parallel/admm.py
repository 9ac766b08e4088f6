"""Consensus-constrained local calibration: the ADMM x-step (counterpart
of ``sagecal_tpu/parallel/admm.py``).

``admm_sagefit`` is ``sagefit_visibilities_admm`` (admm_solve.c:221): an
EM pass over clusters where each per-cluster solve minimizes the data
misfit plus the scaled-Lagrangian consensus terms ``y^T (J - BZ) +
rho/2 ||J - BZ||^2``, the local solver dispatched on solver mode:

- ``SM_LM_LBFGS`` / ``SM_OSLM_LBFGS`` (and the other LM modes): LM with
  the quadratic terms folded into the normal equations
  (``solvers/lm.py``), IRLS-weighted by the Student's-t weights of the
  residual at the incoming solution when ``robust_nu`` is given;
- ``SM_RTR_OSLM_LBFGS``: plain RTR-ADMM;
- ``SM_RTR_OSRLM_RLBFGS`` (and every robust mode but NSD): Student's-t
  robust RTR-ADMM, the reference MPI slave's local solver;
- ``SM_NSD_RLBFGS``: robust NSD-ADMM.

Nothing here launches a CUDA kernel: the x-step runs on torch ops, as
the JAX package's runs on XLA ops.  :func:`round_work_weights` and
:func:`factor_schedule` are host-side schedules (plain floats, numpy).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from sagecal_tpu_torch.core.types import VisData
from sagecal_tpu_torch.obs.records import stack_traces
from sagecal_tpu_torch.solvers.lm import (
    LMConfig, NormalEqPlan, _residual_flat, lm_solve,
)
from sagecal_tpu_torch.solvers.robust import update_w_and_nu
from sagecal_tpu_torch.solvers.rtr import (
    RTRConfig, nsd_solve_robust, rtr_solve, rtr_solve_robust,
)
from sagecal_tpu_torch.solvers.sage import (
    SM_LM_LBFGS, SM_NSD_RLBFGS, SM_RTR_OSLM_LBFGS, SM_RTR_OSRLM_RLBFGS,
    _ROBUST_MODES, ClusterData, _res_norm, em_residual_scan,
    predict_full_model,
)
from sagecal_tpu_torch.utils.precision import true_f32


class AdmmLocalResult(NamedTuple):
    p: torch.Tensor  # (M, nchunk_max, 8N)
    res_0: torch.Tensor
    res_1: torch.Tensor
    # with collect_trace: one IterTrace per EM pass, leading cluster axis
    trace: Optional[tuple] = None


@true_f32
def admm_sagefit(data: VisData, cdata: ClusterData, p0, Y, BZ, rho,
                 max_emiter: int = 1, lm_config: LMConfig = LMConfig(),
                 robust_nu: Optional[float] = None,
                 solver_mode: int = SM_LM_LBFGS, nulow: float = 2.0,
                 nuhigh: float = 30.0, collect_trace: bool = False,
                 cluster_slice=None,
                 plans: Optional[dict] = None,
                 nchunks: Optional[Sequence[int]] = None) -> AdmmLocalResult:
    """One band's ADMM x-update for one tile.

    ``p0``, ``Y``, ``BZ``: (M, nchunk_max, 8N): the current solution, the
    scaled Lagrange multipliers and the consensus target B_f Z (the same
    BZ for every hybrid chunk of a cluster).  ``rho``: (M,) penalties,
    already scaled by the band's unflagged fraction.  ``robust_nu``: the
    Student's-t nu of an LM mode's IRLS weights (robust RTR/NSD modes run
    their own nu EM).  ``cluster_slice``: ``(start, count)``: only those
    clusters are solved and dual-coupled this pass (the rest stay fixed
    and subtracted; ``solvers/sage.py::em_residual_scan``).  ``plans``:
    a dict (chunk count -> :class:`NormalEqPlan`) the caller may keep
    across calls on one tile's row layout; filled here.  ``nchunks``:
    ``cdata.nchunk`` as host ints, which a caller that solves a tile's
    bands round after round reads once; read from the device when not
    given."""
    F, rows = data.vis.shape[-3], data.vis.shape[-1]
    nreal = rows * F * 8
    res_0 = _res_norm(data.vis - predict_full_model(p0, cdata, data),
                      data.mask, nreal)

    use_rtr = solver_mode in (SM_RTR_OSLM_LBFGS, SM_RTR_OSRLM_RLBFGS)
    use_nsd = solver_mode == SM_NSD_RLBFGS
    robust = solver_mode in _ROBUST_MODES
    irls = robust_nu is not None and not (use_rtr or use_nsd)
    mask8 = data.mask[..., None, :] if irls else None
    nu0 = torch.as_tensor(robust_nu if robust_nu is not None else nulow,
                          dtype=p0.dtype, device=p0.device)
    itmax = lm_config.itmax
    rtr_cfg = RTRConfig(itmax_rsd=itmax + 5, itmax_rtr=itmax + 10)
    plans = {} if plans is None else plans
    nchunks = cdata.nchunk.tolist() if nchunks is None else nchunks

    def plan_of(k, cmap_k):
        # a cluster's chunk map is a function of its chunk count
        if nchunks[k] not in plans:
            plans[nchunks[k]] = NormalEqPlan(data.ant_p, data.ant_q, cmap_k,
                                             p0.shape[1], p0.shape[2] // 8)
        return plans[nchunks[k]]

    def solve_one(xeff, coh_k, cmap_k, p_k, extras_k):
        k, y_k, bz_k, rho_k = extras_k
        args = (xeff, coh_k, data.mask, data.ant_p, data.ant_q, cmap_k, p_k)
        admm = dict(admm_y=y_k, admm_bz=bz_k, admm_rho=rho_k,
                    collect_trace=collect_trace, plan=plan_of(k, cmap_k))
        if use_nsd:
            res, _ = nsd_solve_robust(*args, itmax=itmax + 15, nu0=nu0,
                                      nulow=nulow, nuhigh=nuhigh, **admm)
        elif use_rtr and robust:
            res, _ = rtr_solve_robust(*args, rtr_cfg, nu0=nu0, nulow=nulow,
                                      nuhigh=nuhigh, **admm)
        elif use_rtr:
            res = rtr_solve(*args, rtr_cfg, **admm)
        else:
            sqrt_w = None
            if irls:
                ed = _residual_flat(p_k, coh_k, xeff, data.mask, data.ant_p,
                                    data.ant_q, cmap_k, None)
                sqrt_w, _ = update_w_and_nu(ed, nu0, mask=mask8)
            res = lm_solve(*args, lm_config, sqrt_weights=sqrt_w, **admm)
        return res.p, res.trace

    extras = [(k, Y[k], BZ[k], rho[k]) for k in range(p0.shape[0])]
    p = p0
    traces = []
    for _ in range(max_emiter):
        p, aux = em_residual_scan(data, cdata, p, extras, solve_one,
                                  cluster_slice=cluster_slice)
        if collect_trace:
            traces.append(stack_traces(aux))
    res_1 = _res_norm(data.vis - predict_full_model(p, cdata, data),
                      data.mask, nreal)
    return AdmmLocalResult(p=p, res_0=res_0, res_1=res_1,
                           trace=tuple(traces) if collect_trace else None)


def admm_dual_update(Y, p, BZ, rho):
    """Y <- Y + rho (J - BZ) (sagecal_slave.cpp:831), the scaled dual
    ascent step.  Shapes (M, nchunk_max, 8N); rho (M,)."""
    return Y + rho[:, None, None] * (p - BZ)


def round_work_weights(nadmm: int, nslots: int, plain_emiter: int = 2,
                       max_emiter: int = 1, slot_rows=None,
                       cluster_groups: int = 1):
    """Static per-ADMM-round work model (host side, plain floats) for the
    wall-clock attribution of one tile's ADMM (``obs/trace.py``): round 0
    plain-solves all ``nslots`` local slots with ``plain_emiter`` EM
    passes, rounds >= 1 one active slot with ``max_emiter`` passes
    (slot ``((r-1) // cluster_groups) % nslots``, and 1/cluster_groups
    of the clusters).  ``slot_rows``: per-slot unflagged-row counts (or
    any work proxy), normalized to a mean of 1; a longer list (several
    bands a slot) folds down to ``nslots`` entries.  Returns ``nadmm``
    weights."""
    if nadmm <= 0:
        return []
    nslots = max(nslots, 1)
    if slot_rows is not None and len(slot_rows) and sum(slot_rows) > 0:
        mean = float(sum(slot_rows)) / len(slot_rows)
        rel = [float(r) / mean for r in slot_rows]
        if len(rel) != nslots:
            per = max(len(rel) // nslots, 1)
            rel = [sum(rel[s * per:(s + 1) * per]) / per
                   for s in range(nslots)]
    else:
        rel = [1.0] * nslots
    cg = max(cluster_groups, 1)
    ws = [float(sum(rel) * max(plain_emiter, 1))]
    for r in range(1, nadmm):
        s = ((r - 1) // cg) % nslots
        ws.append(float(max(max_emiter, 1)) * rel[s] / cg)
    return ws


def factor_schedule(nadmm: int, nslots: int, cluster_groups: int = 1,
                    band_weights=None, ndev: int = 1):
    """Host-built static (slot, cluster-group) schedule of the mesh
    ADMM's rounds: ``(slot_sched, group_sched)`` int32 arrays of shape
    ``(nadmm-1, ndev)``, one column per shard.  Without
    ``band_weights``: groups fastest, then the Sbegin/Scurrent/Send slot
    rotation, the same on every shard.  ``band_weights``: per-band
    unflagged-row counts, length ``nslots * ndev`` (band ``d * nslots +
    s`` on shard d): each shard apportions its slot visits to its bands'
    weights (largest remainder), interleaved round-robin."""
    nrounds = max(nadmm - 1, 0)
    cg = max(cluster_groups, 1)
    nslots = max(nslots, 1)
    slot_sched = np.zeros((nrounds, ndev), np.int32)
    group_sched = np.zeros((nrounds, ndev), np.int32)
    for r in range(nrounds):
        group_sched[r, :] = r % cg
    if band_weights is None:
        for r in range(nrounds):
            slot_sched[r, :] = (r // cg) % nslots
        return slot_sched, group_sched
    w = np.asarray(band_weights, float).reshape(ndev, nslots)
    w = np.maximum(w, 1e-12)
    nvisits = (nrounds + cg - 1) // cg
    for d in range(ndev):
        share = w[d] / w[d].sum() * nvisits
        counts = np.floor(share).astype(int)
        rem = share - counts
        for s in np.argsort(-rem)[: nvisits - counts.sum()]:
            counts[s] += 1
        counts = np.maximum(counts, 1 if nvisits >= nslots else 0)
        visits = []
        left = counts.copy()
        while len(visits) < nvisits:
            for s in range(nslots):
                if left[s] > 0:
                    visits.append(s)
                    left[s] -= 1
            if left.sum() <= 0 and len(visits) < nvisits:
                visits.extend([int(np.argmax(w[d]))] * (nvisits - len(visits)))
        for r in range(nrounds):
            slot_sched[r, d] = visits[r // cg]
    return slot_sched, group_sched
