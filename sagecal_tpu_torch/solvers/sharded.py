"""Rows-sharded joint calibration (counterpart of
``sagecal_tpu/solvers/sharded.py``).

The JAX package shards the visibility rows of one tile over a device
mesh: each device evaluates the joint cost (the torch-op
``predict_full_model`` cost, robust with ``robust_nu``) and its
gradient on its rows, one ``psum`` of ``(value, grad)`` per evaluation
adds them, and the joint LBFGS iterates on replicated parameters.

Here the padded rows are split into ``nshards`` contiguous virtual row
blocks.  An evaluation takes each block's value and gradient in turn,
frees that block's autograd graph before the next block, and adds the
blocks in block order; one :func:`~sagecal_tpu_torch.solvers.lbfgs.
lbfgs_fit` runs over the replicated parameters.  That is the JAX fit's
semantics, and on one card it bounds the model's transient memory (the
predicted model, the residual and their graph) to about 1/nshards of
the unsharded fit's.  Under a :class:`~sagecal_tpu_torch.parallel.
multihost.ShardGroup` each rank evaluates its own blocks and one
``all_gather`` of the per-block ``(value, grad)`` partials, added in
global block order, gives every rank the same iterate.

``collect_quality`` scatters the final objective density per station
and baseline block by block and adds the blocks in block order (the
JAX package's psummed :class:`~sagecal_tpu_torch.ops.quality.
SolveQuality`).
"""

from __future__ import annotations

from typing import Optional

import torch

from sagecal_tpu_torch.core.types import VisData
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.ops.quality import SolveQuality, chi2_scatter, gain_health
from sagecal_tpu_torch.parallel import multihost
from sagecal_tpu_torch.solvers.lbfgs import lbfgs_fit
from sagecal_tpu_torch.solvers.sage import ClusterData, predict_full_model

# the per-row fields of each container (rows minor-most, core/types.py)
_VIS_ROW_FIELDS = ("u", "v", "w", "ant_p", "ant_q", "vis", "mask",
                   "time_idx")
_CDATA_ROW_FIELDS = ("coh", "chunk_map")


def pad_rows_to(data: VisData, cdata: ClusterData, mult: int):
    """Pad the rows axis to a multiple of ``mult`` with masked rows
    (zero coherency, zero mask: zero contribution everywhere)."""
    rows = data.vis.shape[-1]
    pr = -(-rows // mult) * mult - rows
    if pr == 0:
        return data, cdata

    def pad_last(x):
        return torch.nn.functional.pad(x, (0, pr))

    data = data.replace(**{f: pad_last(getattr(data, f))
                           for f in _VIS_ROW_FIELDS})
    cdata = cdata.replace(**{f: pad_last(getattr(cdata, f))
                             for f in _CDATA_ROW_FIELDS})
    return data, cdata


def _row_block(data: VisData, cdata: ClusterData, sl: slice):
    return (data.replace(**{f: getattr(data, f)[..., sl]
                            for f in _VIS_ROW_FIELDS}),
            cdata.replace(**{f: getattr(cdata, f)[..., sl]
                             for f in _CDATA_ROW_FIELDS}))


def _density(pa, cdata_b, data_b, robust_nu):
    """The joint objective density (F, 4, rows_b) of one row block."""
    model = predict_full_model(pa, cdata_b, data_b)
    diff = (data_b.vis - model) * data_b.mask[..., None, :]
    e2 = diff.real ** 2 + diff.imag ** 2
    return torch.log1p(e2 / robust_nu) if robust_nu is not None else e2


def make_sharded_joint_fn(data: VisData, cdata: ClusterData, p_shape: tuple,
                          nshards: int, itmax: int = 30, lbfgs_m: int = 7,
                          robust_nu: Optional[float] = None,
                          collect_quality: bool = False,
                          group: Optional[multihost.ShardGroup] = None):
    """``fn(data, cdata, p0) -> (p, cost, iterations)``, or ``(p, cost,
    iterations, quality)`` with ``collect_quality``, over ``nshards``
    row blocks (rows a multiple of ``nshards``: :func:`pad_rows_to`).
    ``group``: the ranks that share the blocks (None: this process
    evaluates all of them)."""
    rows = data.vis.shape[-1]
    if rows % nshards != 0:
        raise ValueError(f"{rows} rows do not split into {nshards} blocks; "
                         "pad them with pad_rows_to first")
    rb = rows // nshards
    shp = tuple(p_shape)
    own = (range(nshards) if group is None
           else group.shard_range(nshards))

    def fn(data, cdata, p0):
        blocks = [_row_block(data, cdata, slice(k * rb, (k + 1) * rb))
                  for k in range(nshards)]

        def vg_fn(pflat):
            vals, grads = [], []
            for k in own:
                data_b, cdata_b = blocks[k]
                with torch.enable_grad():
                    x = pflat.detach().requires_grad_(True)
                    f = _density(x.reshape(shp), cdata_b, data_b,
                                 robust_nu).sum()
                    (g,) = torch.autograd.grad(f, x)
                vals.append(f.detach())
                grads.append(g)  # the block's graph is freed here
            f = multihost.shard_sum(vals, group)
            g = multihost.shard_sum(grads, group)
            return f, g

        def cost_fn(pflat):
            with torch.no_grad():
                return multihost.shard_sum(
                    [_density(pflat.reshape(shp), blocks[k][1], blocks[k][0],
                              robust_nu).sum() for k in own], group)

        fit = lbfgs_fit(cost_fn, None, p0.reshape(-1), itmax=itmax,
                        M=lbfgs_m, vg_fn=vg_fn)
        pf = fit.p.reshape(shp)
        if not collect_quality:
            return pf, fit.cost, fit.iterations
        n_st = shp[-1] // 8
        parts = [[], [], []]
        with torch.no_grad():
            for k in own:
                data_b, cdata_b = blocks[k]
                row = _density(pf, cdata_b, data_b, robust_nu).sum(
                    dim=(-3, -2))
                for acc, x in zip(parts, chi2_scatter(
                        row, data_b.ant_p, data_b.ant_q,
                        torch.zeros_like(data_b.ant_p), n_st, 1)):
                    acc.append(x)
        chi2_st, chi2_bl, chi2_tot = (multihost.shard_sum(x, group)
                                      for x in parts)
        nonfinite, amp, amp_sp, ph_sp, dep = gain_health(pf)
        quality = SolveQuality(
            chi2_station=chi2_st, chi2_baseline=chi2_bl,
            chi2_chunk=chi2_tot, nonfinite_count=nonfinite,
            station_amp=amp, station_amp_spread=amp_sp,
            station_phase_spread=ph_sp, identity_departure=dep)
        return pf, fit.cost, fit.iterations, quality

    return fn


def sharded_joint_fit(data: VisData, cdata: ClusterData, p0, nshards: int,
                      itmax: int = 30, lbfgs_m: int = 7,
                      robust_nu: Optional[float] = None,
                      collect_quality: bool = False,
                      group: Optional[multihost.ShardGroup] = None,
                      device=None):
    """Joint LBFGS over all clusters with the rows in ``nshards`` blocks,
    on ``device`` (CUDA unless ``device="cpu"``; inputs elsewhere are
    moved there).

    ``p0``: (M, nchunk, 8N).  Returns (p, cost, iterations), plus the
    block-summed :class:`SolveQuality` with ``collect_quality`` (see
    :func:`make_sharded_joint_fn`).  Rows must divide by ``nshards``:
    use :func:`pad_rows_to` first."""
    from sagecal_tpu_torch.obs.trace import get_tracer

    dev = resolve_device(device)
    data = data if data.device == dev else data.to(dev)
    cdata = cdata if cdata.coh.device == dev else cdata.to(dev)
    p0 = torch.as_tensor(p0).to(dev)
    fn = make_sharded_joint_fn(data, cdata, p0.shape, nshards, itmax=itmax,
                               lbfgs_m=lbfgs_m, robust_nu=robust_nu,
                               collect_quality=collect_quality, group=group)
    # a host-side collective span around the whole fit
    with get_tracer().span("sharded_joint_fit", kind="collective",
                           ndev=int(nshards), rows=int(data.vis.shape[-1])):
        return fn(data, cdata, p0)
