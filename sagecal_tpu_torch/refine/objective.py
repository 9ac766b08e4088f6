"""Differentiable bilevel objectives for sky-model refinement
(counterpart of ``sagecal_tpu/refine/objective.py``).

The inner (calibration) and outer (refinement) problems share one
residual ``r(p, theta) = mask * (vis - sum_k J_p^k C^k(theta) J_q^kH)``
in which the cluster coherencies ``C^k(theta)`` are recomputed from the
sky parameters (the port's torch-op ``ops/rime.py`` predict) instead
of being constants.  That lets gradients flow from the residuals
through the calibration solve into fluxes, spectral indices, positions
and shapelet coefficients.

This is the torch-op path by construction: the hand CUDA kernels have
no coherency cotangent (``ops/rime_kernel.py::FUSED_COHERENCY_COTANGENT``
is False), so :func:`require_xla_predict` refuses the fused path with
``FusedSkyGradientError``, as the JAX package refuses its Pallas one.

- inner ``f(p, theta) = 0.5 ||r||^2 + 0.5 ridge ||p - p_anchor||^2``
- outer ``h(p, theta) = 0.5 ||r||^2``

The gain ridge (anchor: identity gains by default) breaks the
flux/gain degeneracy and makes the inner objective differ from the
outer one, so the implicit adjoint term is nonzero.

The coherencies depend on theta only, so a caller that evaluates many
residuals at one theta (the inner solve, its adjoint) computes them
once (:func:`cluster_data_from_theta`) and passes them as ``cdata``.
:func:`model_jvp` is the model's exact directional derivative in the
gains: the model is bilinear in (p-side, q-side) gains, so ``dM[v] =
B(v, p) + B(p, v)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import torch

from sagecal_tpu_torch.core.segment import SegmentPlan, gather_rows
from sagecal_tpu_torch.core.types import (
    VisData, complex_dtype_of, identity_jones, jones_to_params,
    params_to_jones,
)
from sagecal_tpu_torch.ops.rime import (
    ShapeletTable, SourceBatch, _predict_coherencies, resolve_source_flags,
)
from sagecal_tpu_torch.refine.skyparams import SkySpec
from sagecal_tpu_torch.solvers.sage import ClusterData


def require_xla_predict(use_fused_predict: bool) -> None:
    """Refinement's capability check: the hand kernels cannot give the
    coherency cotangents refinement needs, so asking for them fails at
    configuration time."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        FUSED_COHERENCY_COTANGENT, FusedSkyGradientError,
    )

    if use_fused_predict and not FUSED_COHERENCY_COTANGENT:
        raise FusedSkyGradientError(
            "sky-model refinement requires the torch-op predict path: the "
            "fused CUDA kernels' backward gives gain cotangents only "
            "(FUSED_COHERENCY_COTANGENT=False). Drop --fused for the "
            "refine app.")


@dataclasses.dataclass(frozen=True)
class RefineProblem:
    """Everything the bilevel objectives close over.  ``p`` is handled
    flat, ``(M * 8N,)`` real, and reshaped to the solver layout ``(M, 1,
    8N)`` at the predict; refinement solves nchunk = 1."""

    data: VisData
    clusters: List[SourceBatch]
    tables: Optional[List[Optional[ShapeletTable]]]
    spec: SkySpec
    fdelta: float = 0.0
    ridge: float = 1e-2
    p_anchor: Optional[torch.Tensor] = None  # flat (M*8N,); None = identity
    source_chunk: int = 32

    @property
    def nclusters(self) -> int:
        return len(self.clusters)

    @property
    def nstations(self) -> int:
        return self.data.nstations

    @property
    def nparams_p(self) -> int:
        return self.nclusters * 8 * self.nstations

    @functools.cached_property
    def source_flags(self) -> list:
        """Each cluster's (has_extended, has_shapelet), read from the
        catalog batches once."""
        return [resolve_source_flags(
            c, self.tables[ci] if self.tables is not None else None)
            for ci, c in enumerate(self.clusters)]

    @functools.cached_property
    def gather_plans(self) -> tuple:
        """The gain gathers' (index, :class:`SegmentPlan`) of the p and
        the q side, built once: every residual and product gathers by
        the same rows (nchunk = 1)."""
        M, N = self.nclusters, self.nstations
        base = torch.arange(M, device=self.data.device)[:, None] * N
        out = []
        for ant in (self.data.ant_p, self.data.ant_q):
            idx = (base + ant[None, :]).reshape(-1)
            out.append((idx, SegmentPlan(idx, M * N)))
        return tuple(out)

    def identity_gains(self) -> torch.Tensor:
        """Flat identity gains: J = I for every (cluster, station)."""
        rdt = self.data.u.dtype
        eye = identity_jones(self.nstations, complex_dtype_of(rdt),
                             device=self.data.device)
        return jones_to_params(eye.expand(self.nclusters, -1, 2, 2)
                               ).reshape(-1).to(rdt)

    def anchor(self) -> torch.Tensor:
        return (self.p_anchor if self.p_anchor is not None
                else self.identity_gains())


def cluster_coherencies(problem: RefineProblem,
                        theta: torch.Tensor) -> torch.Tensor:
    """(M, F, 4, rows) complex coherencies recomputed from the free sky
    parameters: the differentiable analog of ``build_cluster_data``'s
    ``coh``.  The source-type flags come from the catalog batches."""
    clusters, tables = problem.spec.apply(theta, problem.clusters,
                                          problem.tables)
    d = problem.data
    cohs = []
    for ci, src in enumerate(clusters):
        has_ext, has_sh = problem.source_flags[ci]
        cohs.append(_predict_coherencies(
            d.u, d.v, d.w, d.freqs, src, float(problem.fdelta),
            int(problem.source_chunk),
            tables[ci] if tables is not None else None, has_ext, has_sh))
    return torch.stack(cohs, dim=0)


def cluster_data_from_theta(problem: RefineProblem,
                            theta: torch.Tensor) -> ClusterData:
    coh = cluster_coherencies(problem, theta)
    M, _, _, rows = coh.shape
    dev = coh.device
    return ClusterData(coh=coh,
                       chunk_map=torch.zeros((M, rows), dtype=torch.int64,
                                             device=dev),
                       nchunk=torch.ones((M,), dtype=torch.int64, device=dev))


def gain_rows(problem: RefineProblem, p_flat: torch.Tensor) -> tuple:
    """The gains of every (cluster, row), p side and q side (conjugated):
    two 4-tuples of (M, 1, rows) complex tensors, gathered by the
    problem's ``gather_plans``."""
    M = problem.nclusters
    tab = params_to_jones(p_flat.reshape(M, 1, -1)).reshape(-1, 4)
    out = []
    for side, (idx, plan) in enumerate(problem.gather_plans):
        g = gather_rows(tab, idx, plan).reshape(M, 1, -1, 4)
        g = (g[..., 0], g[..., 1], g[..., 2], g[..., 3])
        out.append(g if side == 0 else tuple(x.conj() for x in g))
    return tuple(out)


def _bilinear_model(ga, gb, cdata: ClusterData):
    """``sum_k Ja_p C_k Jb_q^H``, (F, 4, rows), from the p-side gains of
    one parameter vector (``ga``) and the conjugated q-side gains of
    another (``gb``), as :func:`gain_rows` gives them;
    ``solvers/sage.py::predict_full_model`` is ``B(p, p)``."""
    a0, a1, a2, a3 = ga
    q0, q1, q2, q3 = gb
    c00, c01 = cdata.coh[:, :, 0], cdata.coh[:, :, 1]
    c10, c11 = cdata.coh[:, :, 2], cdata.coh[:, :, 3]
    w00 = c00 * q0 + c01 * q1
    w01 = c00 * q2 + c01 * q3
    w10 = c10 * q0 + c11 * q1
    w11 = c10 * q2 + c11 * q3
    v00 = (a0 * w00 + a1 * w10).sum(0)
    v01 = (a0 * w01 + a1 * w11).sum(0)
    v10 = (a2 * w00 + a3 * w10).sum(0)
    v11 = (a2 * w01 + a3 * w11).sum(0)
    return torch.stack([v00, v01, v10, v11], dim=-2)


def _flat_reals(diff: torch.Tensor) -> torch.Tensor:
    return torch.cat([diff.real.reshape(-1), diff.imag.reshape(-1)])


def residual_vec(problem: RefineProblem, p_flat: torch.Tensor,
                 theta: torch.Tensor,
                 cdata: Optional[ClusterData] = None) -> torch.Tensor:
    """Masked residual as one flat real vector (re and im stacked),
    differentiable in both arguments.  ``cdata``: the coherencies of
    ``theta`` when the caller has them."""
    d = problem.data
    if cdata is None:
        cdata = cluster_data_from_theta(problem, theta)
    gp, gq = gain_rows(problem, p_flat)
    model = _bilinear_model(gp, gq, cdata)
    return _flat_reals((d.vis - model) * d.mask[:, None, :])


def model_jvp(problem: RefineProblem, p_flat: torch.Tensor,
              v_flat: torch.Tensor, cdata: ClusterData,
              p_gains: Optional[tuple] = None) -> torch.Tensor:
    """``d residual_vec / dp @ v`` at fixed coherencies: ``-mask (B(v,
    p) + B(p, v))`` as a flat real vector (exact; the model is bilinear
    in its two gain sides).  ``p_gains``: :func:`gain_rows` of ``p_flat``
    when the caller keeps them (the CG steps of one Gauss-Newton step)."""
    gp, gq = p_gains if p_gains is not None else gain_rows(problem, p_flat)
    vp, vq = gain_rows(problem, v_flat)
    dm = _bilinear_model(vp, gq, cdata) + _bilinear_model(gp, vq, cdata)
    return _flat_reals(-dm * problem.data.mask[:, None, :])


def outer_cost(problem: RefineProblem, p_flat: torch.Tensor,
               theta: torch.Tensor,
               cdata: Optional[ClusterData] = None) -> torch.Tensor:
    """h(p, theta) = 0.5 ||r||^2: the misfit the refinement minimizes
    at the inner fixed point."""
    r = residual_vec(problem, p_flat, theta, cdata)
    return 0.5 * torch.dot(r, r)


def inner_cost(problem: RefineProblem, p_flat: torch.Tensor,
               theta: torch.Tensor,
               cdata: Optional[ClusterData] = None) -> torch.Tensor:
    """f(p, theta) = h + 0.5 ridge ||p - anchor||^2: the calibration
    objective whose fixed point defines p*(theta)."""
    dp = p_flat - problem.anchor()
    return (outer_cost(problem, p_flat, theta, cdata)
            + 0.5 * problem.ridge * torch.dot(dp, dp))
