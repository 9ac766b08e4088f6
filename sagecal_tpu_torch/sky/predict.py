"""Hierarchical prediction: a drop-in, differentiable variant of
:func:`sagecal_tpu_torch.ops.rime.predict_coherencies` for wide-field
(10k+ source) point skies (counterpart of ``sagecal_tpu/sky/predict.py``).

``predict_coherencies_hier`` returns the same (F, 4, rows) complex
coherency stack, computed as

- far field: per-node order-p phase-gradient expansions about the
  tree-node centroids (:mod:`sagecal_tpu_torch.sky.farfield`) for every
  (node, baseline-tile) pair passing the well-separation criterion
  ``2*pi*fmax*|b|*r_node <= theta``;
- near field: the exact predict on the gathered residual source subsets
  (:mod:`sagecal_tpu_torch.sky.nearfield`), zero-flux padded to the
  largest near list.

The error knob is ``(order, theta)``: the a-priori pointwise bound is
``theta^(order+1)/(order+1)!`` relative to the summed absolute source
amplitude (:func:`~sagecal_tpu_torch.sky.farfield.apriori_rel_bound`),
and :func:`sampled_error_estimate` measures the a-posteriori error
against the exact predict on a random row subsample, the number the
quality watchdog (``obs/quality.py::check_hier_predict``) gauges.

Plan/compute split: :func:`build_hier_plan` runs once per (uvw tile
set, sky geometry) on the host and moves its index arrays (and each
routed level's node membership matrix) to the device; the same plan
serves repeated calls, other orders (the routing depends only on
theta) and gradients in the fluxes.  Everything runs in torch ops on the
rows' device; no CUDA kernel of this package is launched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sagecal_tpu_torch.ops.rime import (
    ST_POINT, SourceBatch, predict_coherencies,
)
from sagecal_tpu_torch.sky.farfield import (
    apriori_rel_bound, far_field_tiles, level_members, multipole_table,
    node_moments,
)
from sagecal_tpu_torch.sky.nearfield import near_field_tiles
from sagecal_tpu_torch.sky.tree import (
    HierRouting, SourceTree, build_source_tree, route_tiles,
)
from sagecal_tpu_torch.utils.precision import full_f32


@dataclasses.dataclass(frozen=True)
class HierPlan:
    """One sky x uvw-tile-set routing, on the device.

    ``tree``/``routing`` keep the host-side numpy bookkeeping (stats,
    bound accounting); the tensors are what the predict consumes.
    Reusable across calls with the same uvw rows and source positions;
    fluxes and spectra may differ (and may require gradients)."""

    tree: SourceTree
    routing: HierRouting
    theta: float
    node_of_source: torch.Tensor  # (L_used, S) int64, far-used levels only
    node_center: torch.Tensor     # (nnodes, 3)
    far_idx: torch.Tensor         # (T, Fmax) int64
    far_valid: torch.Tensor       # (T, Fmax)
    near_src: torch.Tensor        # (T, Nmax) int64
    near_valid: torch.Tensor      # (T, Nmax)
    # rows sorted by baseline length, so each tile's max |b| is as small
    # as its members allow; row_inv puts the result back in row order
    row_perm: torch.Tensor        # (rows,) int64
    row_inv: torch.Tensor         # (rows,) int64
    used_levels: tuple = ()       # tree levels with >= 1 far node
    # 1 = unpolarized path (no Q/U/V in the sky at build time), 4 = full
    # Stokes (needed for gradients in Q/U/V: force_polarized)
    npol: int = 4
    members: tuple = ()           # level_members of the used levels

    @property
    def nnodes(self) -> int:
        return self.tree.nnodes

    @property
    def use_far(self) -> bool:
        return self.routing.far_pairs > 0

    @property
    def use_near(self) -> bool:
        return self.routing.near_sources_total > 0

    def stats(self) -> dict:
        r = self.routing
        return {
            "depth": self.tree.depth,
            "nnodes": self.nnodes,
            "ntiles": r.ntiles,
            "tile_rows": r.tile_rows,
            "far_pairs": r.far_pairs,
            "max_far": r.max_far,
            "near_sources_total": r.near_sources_total,
            "max_near": r.max_near,
            "theta": self.theta,
        }


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plan_from_routing(tree: SourceTree, routing: HierRouting, theta: float,
                      row_perm, npol: int, rdtype, device) -> HierPlan:
    """The device plan of a host routing (``row_perm``: the rows' order
    in the tiles)."""
    row_perm = np.asarray(row_perm, np.int64)
    row_inv = np.empty_like(row_perm)
    row_inv[row_perm] = np.arange(row_perm.size)
    far_nodes = routing.far_idx[routing.far_valid > 0]
    if far_nodes.size:
        levs = np.searchsorted(tree.level_offset, far_nodes,
                               side="right") - 1
        used_levels = tuple(sorted({int(x) for x in levs}))
    else:
        used_levels = ()
    # moments are needed only on the levels the far routing references
    nos = (tree.node_of_source[list(used_levels)] if used_levels
           else tree.node_of_source[:0])

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    return HierPlan(
        tree=tree, routing=routing, theta=float(theta),
        node_of_source=t(nos, torch.int64),
        node_center=t(tree.node_center, rdtype),
        far_idx=t(routing.far_idx, torch.int64),
        far_valid=t(routing.far_valid, rdtype),
        near_src=t(routing.near_src, torch.int64),
        near_valid=t(routing.near_valid, rdtype),
        row_perm=t(row_perm, torch.int64), row_inv=t(row_inv, torch.int64),
        used_levels=used_levels, npol=int(npol),
        members=tuple(level_members(nos, rdtype, device)))


def build_hier_plan(u, v, w, freqs, src: SourceBatch, *, theta: float = 1.5,
                    leaf_size: int = 32, tile_rows: int = 128,
                    depth: Optional[int] = None,
                    force_polarized: bool = False) -> HierPlan:
    """The plan, built on the host from the source positions and the
    rows (read back once), on the rows' device.

    Raises on non-point batches: extended and shapelet sources have
    uv-dependent amplitudes the far-field expansion does not model; they
    take the exact predict.  ``force_polarized`` keeps the full-Stokes
    moments for an unpolarized sky (gradients in Q/U/V)."""
    if bool(np.any(_host(src.stype) != ST_POINT)):
        raise ValueError(
            "predict_coherencies_hier supports point-source batches only; "
            "extended/shapelet clusters must use the exact "
            "predict_coherencies path")
    tree = build_source_tree(_host(src.ll).astype(np.float64),
                             _host(src.mm).astype(np.float64),
                             _host(src.nn).astype(np.float64),
                             leaf_size=leaf_size, depth=depth)
    uu, vv, ww = (_host(x).astype(np.float64) for x in (u, v, w))
    # sort rows by baseline length so each tile's max |b| is as small as
    # its members allow: short-baseline tiles then admit coarse nodes
    row_perm = np.argsort(np.sqrt(uu * uu + vv * vv + ww * ww),
                          kind="stable")
    routing = route_tiles(tree, uu[row_perm], vv[row_perm], ww[row_perm],
                          float(np.max(_host(freqs))), float(theta),
                          tile_rows=tile_rows)
    unpol = not (bool(np.any(_host(src.sQ0))) or bool(np.any(_host(src.sU0)))
                 or bool(np.any(_host(src.sV0))))
    npol = 1 if (unpol and not force_polarized) else 4
    return plan_from_routing(tree, routing, theta, row_perm, npol, u.dtype,
                             u.device)


def _hier_core(u_t, v_t, w_t, freqs, src, plan: HierPlan, order: int,
               fdelta: float, source_chunk: int) -> torch.Tensor:
    """Far plus near coherencies of the tiled rows: (F, 4, T*R)."""
    abc, invfact, degree = multipole_table(order)
    T, R = u_t.shape
    F = freqs.shape[0]
    total = None  # every source is in a far node or a near list
    if plan.use_far:
        moments = node_moments(src, freqs, plan.node_of_source,
                               plan.node_center, plan.nnodes, abc,
                               npol=plan.npol, members=plan.members)
        total = far_field_tiles(u_t, v_t, w_t, freqs, plan.node_center,
                                moments, plan.far_idx, plan.far_valid, abc,
                                invfact, degree, fdelta=fdelta)
    if plan.use_near:
        near = near_field_tiles(u_t, v_t, w_t, freqs, src, plan.near_src,
                                plan.near_valid, fdelta, source_chunk)
        total = near if total is None else total + near
    # (T, F, 4, R) -> (F, 4, T*R)
    return total.permute(1, 2, 0, 3).reshape(F, 4, T * R)


def predict_coherencies_hier(u, v, w, freqs, src: SourceBatch, *,
                             order: int = 8, theta: float = 1.5,
                             leaf_size: int = 32, tile_rows: int = 128,
                             fdelta: float = 0.0, source_chunk: int = 32,
                             plan: Optional[HierPlan] = None,
                             return_plan: bool = False):
    """Hierarchical sum of point-source coherencies: (F, 4, rows)
    complex, drop-in for :func:`~sagecal_tpu_torch.ops.rime.
    predict_coherencies`, on the rows' device.

    ``order`` (Taylor order p) and ``theta`` (well-separation phase
    budget, radians; <= 0 sends everything through the exact near-field
    path) are the error knobs: a-priori pointwise error <=
    ``apriori_rel_bound(order, theta)`` x the summed absolute source
    amplitude.  ``fdelta`` smears exactly on the near field and in the
    node-centroid approximation on the far field.  Pass a prebuilt
    ``plan`` to reuse the routing; ``return_plan`` returns ``(coh,
    plan)``."""
    if plan is None:
        plan = build_hier_plan(u, v, w, freqs, src, theta=theta,
                               leaf_size=leaf_size, tile_rows=tile_rows)
    T, R = plan.routing.ntiles, plan.routing.tile_rows
    rows = plan.routing.rows
    pad = T * R - rows

    # rows enter in the plan's baseline-length order and leave in theirs
    def tiled(x):
        return torch.nn.functional.pad(x[plan.row_perm], (0, pad)).reshape(
            T, R)

    with full_f32():
        coh = _hier_core(tiled(u), tiled(v), tiled(w), freqs, src, plan,
                         int(order), float(fdelta), int(source_chunk))
    coh = coh[:, :, :rows][:, :, plan.row_inv]
    return (coh, plan) if return_plan else coh


def sampled_error_estimate(u, v, w, freqs, src: SourceBatch, coh_hier,
                           nsample: int = 32, seed: int = 0,
                           fdelta: float = 0.0,
                           source_chunk: int = 32) -> dict:
    """A-posteriori error of a hierarchical prediction: the exact predict
    on a random row subsample (numpy's ``default_rng(seed)``, so the JAX
    package samples the same rows) against those rows of ``coh_hier``.
    Returns ``rel_err`` (max abs deviation over the sample over the
    sample's max exact amplitude), ``abs_err``, ``scale``, ``nsample``
    and the sampled ``rows``."""
    rows = int(u.shape[0])
    rng = np.random.default_rng(seed)
    k = int(min(max(nsample, 1), rows))
    sel = np.sort(rng.choice(rows, size=k, replace=False))
    idx = torch.as_tensor(sel, device=u.device)
    with full_f32():
        exact = predict_coherencies(u[idx], v[idx], w[idx], freqs, src,
                                    fdelta, source_chunk,
                                    has_extended=False, has_shapelet=False)
    exact = exact.detach().cpu().numpy()
    h = coh_hier[:, :, idx].detach().cpu().numpy()
    abs_err = float(np.max(np.abs(h - exact))) if exact.size else 0.0
    scale = float(np.max(np.abs(exact))) if exact.size else 0.0
    rel = abs_err / scale if scale > 0 else 0.0
    return {"rel_err": rel, "abs_err": abs_err, "scale": scale,
            "nsample": k, "rows": sel}


def gather_sources(src: SourceBatch, idx) -> SourceBatch:
    """Sub-batch of ``src`` at the given source indices (the tree's
    effective clusters)."""
    ix = torch.as_tensor(np.asarray(idx, np.int64), device=src.ll.device)
    return src.map(lambda x: x[ix])


__all__ = [
    "HierPlan",
    "apriori_rel_bound",
    "build_hier_plan",
    "gather_sources",
    "plan_from_routing",
    "predict_coherencies_hier",
    "sampled_error_estimate",
]
