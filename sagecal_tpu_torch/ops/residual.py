"""Residual calculation, correction and simulation (counterpart of
``sagecal_tpu/ops/residual.py``).

Subtract the solution-corrupted model from the data
(:func:`calculate_residuals`), optionally correct the residual by the
regularized inverse of one cluster's solutions (the ``-E ccid`` option,
with MMSE damping rho and a phase-only variant), and simulate with the
``-a 1|2|3`` semantics (:func:`simulate_visibilities`, ``SIMUL_*``).

The model of every cluster corrupted by ``p`` is formed by
:func:`_full_model`: with float32 data it packs the tile
(``pack_gain_tables`` / ``pack_predict_inputs``) and calls the fused
predict (``fused_predict_packed``, or ``_hybrid`` when any cluster has
more than one hybrid chunk), which launches kernel #1 on CUDA tensors
and runs its plain version on CPU tensors.  Float64 data take
``solvers.sage.predict_full_model``: the kernels compute in float32, as
the JAX package's fused paths do.  That is the dtype contract, not a
fallback.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sagecal_tpu_torch.core.types import (
    VisData, corrupt_flat_2sided, params_to_jones,
)
from sagecal_tpu_torch.parallel.manifold import extract_phases
from sagecal_tpu_torch.solvers.sage import (
    ClusterData, _res_norm, predict_full_model,
)

# simulation modes (SIMUL_ONLY/ADD/SUB of the reference, -a 1|2|3)
SIMUL_ONLY = 1  # the model in place of the data
SIMUL_ADD = 2  # the data plus the model
SIMUL_SUB = 3  # the data minus the model


def mat_invert_reg(J: torch.Tensor, rho: float) -> torch.Tensor:
    """Regularized 2x2 inverse inv(J + rho I) with the determinant guard
    of the reference's ``mat_invert``: where sqrt|det| <= rho, det + rho
    is used."""
    a = J[..., 0, 0] + rho
    b = J[..., 0, 1]
    c = J[..., 1, 0]
    d = J[..., 1, 1] + rho
    det = a * d - b * c
    det = torch.where(torch.sqrt(torch.abs(det)) <= rho, det + rho, det)
    inv_det = 1.0 / det
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def correction_jones(p_ccid: torch.Tensor, rho: float = 1e-9,
                     phase_only: bool = False) -> torch.Tensor:
    """Per-station correction matrices inv(J_ccid + rho I), (nchunk, N,
    2, 2); ``phase_only`` reduces the solutions to their diagonal phases
    first."""
    jones = params_to_jones(p_ccid)
    if phase_only:
        jones = extract_phases(jones)
    return mat_invert_reg(jones, rho)


def apply_correction(vis, pinv, ant_p, ant_q, chunk_map):
    """x <- Ginv_p x Ginv_q^H per row.  vis: flat (F, 4, rows); pinv:
    (nchunk, N, 2, 2); indices (rows,)."""
    return corrupt_flat_2sided(pinv, pinv, vis, ant_p, ant_q, chunk_map)


def packed_predict_inputs(p, cdata: ClusterData, data: VisData):
    """The fused predict's packed inputs for the solutions ``p`` (M,
    nchunk, 8N) on this float32 tile: (tab_re, tab_im, coh_ri, ant_p,
    ant_q, cmap, nc), cmap None when nc is 1."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        pack_gain_tables, pack_predict_inputs,
    )

    M, nchunk = cdata.coh.shape[0], p.shape[1]
    _, _, coh_ri, antp, antq, cmap = pack_predict_inputs(
        data.vis, data.mask, cdata.coh, data.ant_p, data.ant_q,
        cdata.chunk_map if nchunk > 1 else None)
    jones = params_to_jones(p.float())  # (M, nchunk, N, 2, 2)
    tre, tim = pack_gain_tables(jones if nchunk > 1 else jones[:, 0], M)
    return tre, tim, coh_ri, antp, antq, cmap, nchunk


def _full_model(p, cdata: ClusterData, data: VisData) -> torch.Tensor:
    """sum_k J_k C_k J_k^H over all clusters, flat (F, 4, rows): the
    fused predict for float32 data, ``predict_full_model`` for float64
    (module doc).  ``p``: (M, nchunk, 8N)."""
    if data.vis.real.dtype != torch.float32:
        return predict_full_model(p, cdata, data)
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_predict_packed, fused_predict_packed_hybrid,
    )

    tre, tim, coh_ri, antp, antq, cmap, nchunk = packed_predict_inputs(
        p, cdata, data)
    if nchunk > 1:
        m = fused_predict_packed_hybrid(tre, tim, coh_ri, antp, antq, cmap,
                                        nchunk)
    else:
        m = fused_predict_packed(tre, tim, coh_ri, antp, antq)
    return torch.complex(m[:, :4], m[:, 4:])


def calculate_residuals(data: VisData, cdata: ClusterData, p,
                        ccid_index: Optional[int] = None, rho: float = 1e-9,
                        phase_only: bool = False) -> torch.Tensor:
    """Residual visibilities x - sum_k J C J^H, flat (F, 4, rows),
    optionally corrected by cluster ``ccid_index``'s inverse solutions.

    ``ccid_index`` is the cluster array index of the correction cluster
    (the caller resolves the reference's ``-E ccid`` id to an index).
    ``p``: (M, nchunk, 8N) on the tile's device."""
    res = data.vis - _full_model(p, cdata, data)
    if ccid_index is not None:
        pinv = correction_jones(p[ccid_index], rho, phase_only)
        res = apply_correction(res, pinv, data.ant_p, data.ant_q,
                               cdata.chunk_map[ccid_index])
    return res


def simulate_visibilities(data: VisData, cdata: ClusterData, p=None,
                          mode: int = SIMUL_ONLY,
                          ignore_clusters: Sequence[int] = (),
                          ccid_index: Optional[int] = None, rho: float = 1e-9,
                          phase_only: bool = False) -> torch.Tensor:
    """Simulation modes of ``sagecal -a 1|2|3``.

    Without ``p`` the model is the uncorrupted sky; with ``p`` it is
    corrupted by those solutions, skipping the clusters in
    ``ignore_clusters`` (the ``-z`` ignore file), and optionally
    correcting the output by cluster ``ccid_index``.  Returns the new
    visibilities per ``mode``."""
    M = cdata.coh.shape[0]
    ignored = set(ignore_clusters)
    keep = torch.as_tensor([0.0 if k in ignored else 1.0 for k in range(M)],
                           dtype=cdata.coh.real.dtype, device=cdata.coh.device)
    if p is None:
        model = torch.einsum("k,kfcr->fcr", keep.to(cdata.coh.dtype),
                             cdata.coh)
    else:
        masked = cdata.replace(coh=cdata.coh * keep[:, None, None, None])
        model = _full_model(p, masked, data)
    if ccid_index is not None and p is not None:
        pinv = correction_jones(p[ccid_index], rho, phase_only)
        model = apply_correction(model, pinv, data.ant_p, data.ant_q,
                                 cdata.chunk_map[ccid_index])
    if mode == SIMUL_ADD:
        return data.vis + model
    if mode == SIMUL_SUB:
        return data.vis - model
    return model


def fused_objective(data: VisData, cdata: ClusterData, p, nu=None):
    """Scalar calibration objective through the fused-objective kernels
    #3/#4: ``sum |(vis - model) * mask|^2`` when ``nu`` is None,
    ``sum log1p(|...|^2 / nu)`` otherwise, in one pass over the
    coherency stack.  Differentiable with respect to ``p`` only: asking
    for coherency gradients raises FusedSkyGradientError (differentiate
    ``predict_full_model`` for sky refinement).  ``p``: (M, nchunk, 8N).
    Float32 data only.  The JAX package's ``tile`` and ``max_rows``
    (TPU row tiling) have no counterpart."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        FusedSkyGradientError, fused_cost_packed, fused_cost_packed_hybrid,
        pack_gain_tables, pack_predict_inputs,
    )

    if data.vis.real.dtype != torch.float32:
        raise ValueError(
            "fused_objective requires float32 data (the kernels compute in "
            "f32); use predict_full_model for f64")
    if cdata.coh.requires_grad:
        raise FusedSkyGradientError(
            "fused_objective has no coherency cotangent; differentiate "
            "solvers.sage.predict_full_model for sky-model gradients")
    M, nchunk = cdata.coh.shape[0], p.shape[1]
    vis_ri, mask_p, coh_ri, antp, antq, cmap = pack_predict_inputs(
        data.vis, data.mask, cdata.coh, data.ant_p, data.ant_q,
        cdata.chunk_map if nchunk > 1 else None)
    jones = params_to_jones(p.float())
    if nchunk > 1:
        tre, tim = pack_gain_tables(jones, M)
        return fused_cost_packed_hybrid(tre, tim, coh_ri, antp, antq, vis_ri,
                                        mask_p, cmap, nchunk, nu)
    tre, tim = pack_gain_tables(jones[:, 0], M)
    return fused_cost_packed(tre, tim, coh_ri, antp, antq, vis_ri, mask_p, nu)


def residual_norm(res: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """||res|| / n_real, the per-tile print; delegates to the solver's
    bookkeeping (``_res_norm``) so the two stay identical.  res: flat
    (F, 4, rows); mask: (F, rows)."""
    return _res_norm(res, mask, res.shape[-3] * res.shape[-1] * 8)
