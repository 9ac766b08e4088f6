"""SAGE/EM calibration driver (counterpart of ``sagecal_tpu/solvers/sage.py``).

One tile: coherencies per cluster (:func:`build_cluster_data`), EM passes
that solve each cluster against the residual with every other cluster's
model removed (:func:`em_residual_scan`, per-cluster LM, OS-LM or robust
LM), then one joint LBFGS over all gains.  With
``SageConfig.use_fused_predict`` every cost and gradient of the joint
LBFGS goes through the fused-objective CUDA kernels
(:func:`_make_fused_joint_cost`); otherwise through torch ops
(``predict_full_model`` + autograd).

Reproduced reference behaviours: weighted LM-iteration allocation by the
previous cost reduction, alternating with equal allocation when
``randomize`` is on; robust solves only on the final EM pass for the
LM-family modes, the mean Student's-t nu carried to the joint LBFGS;
OS acceleration on the earlier passes; res_0/res_1 bookkeeping.

Ported solver modes: 0 (OS-LM + LBFGS), 1 (LM + LBFGS), 2 (robust LM +
robust LBFGS), 3 (OS-LM, OS robust LM, robust LBFGS: the CLI default).
Modes 4-6 (RTR/NSD), ``param_bound > 0`` (LBFGS-B), ``collect_telemetry``
and ``collect_quality`` raise NotImplementedError until their slice
(ROADMAP.md Queue A).  ``jax.random`` keys become a ``torch.Generator``
(CPU) from which the OS-LM row permutations are drawn.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from sagecal_tpu_torch.core.types import VisData, corrupt_flat, params_to_jones
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.ops.rime import (
    SourceBatch, _check_point_only, _predict_coherencies, pad_source_batch,
    predict_coherencies,
)
from sagecal_tpu_torch.solvers.lbfgs import lbfgs_fit
from sagecal_tpu_torch.solvers.lm import LMConfig, lm_solve, os_lm_solve
from sagecal_tpu_torch.solvers.robust import robust_lm_solve
from sagecal_tpu_torch.utils.precision import true_f32

# solver modes (values match the reference's Dirac.h)
SM_OSLM_LBFGS = 0
SM_LM_LBFGS = 1
SM_RLM_RLBFGS = 2
SM_OSLM_OSRLM_RLBFGS = 3
SM_RTR_OSLM_LBFGS = 4
SM_RTR_OSRLM_RLBFGS = 5
SM_NSD_RLBFGS = 6

_ROBUST_MODES = (SM_RLM_RLBFGS, SM_OSLM_OSRLM_RLBFGS, SM_RTR_OSRLM_RLBFGS,
                 SM_NSD_RLBFGS)
_PORTED_MODES = (SM_OSLM_LBFGS, SM_LM_LBFGS, SM_RLM_RLBFGS,
                 SM_OSLM_OSRLM_RLBFGS)


@dataclasses.dataclass(frozen=True)
class SageConfig:
    """Same fields and defaults as the JAX package's SageConfig."""

    max_emiter: int = 3
    max_iter: int = 10
    max_lbfgs: int = 10
    lbfgs_m: int = 7
    solver_mode: int = SM_LM_LBFGS
    nulow: float = 2.0
    nuhigh: float = 30.0
    randomize: bool = True
    em_rounds_robust: int = 2
    param_bound: float = 0.0
    # joint-LBFGS cost through the fused-objective CUDA kernels (f32 only)
    use_fused_predict: bool = False
    # coherency storage on the fused path: "f32" or "bf16" (f32 math)
    coh_dtype: str = "f32"
    iter_budget_cap: int = 3
    collect_telemetry: bool = False
    collect_quality: bool = False

    def replace(self, **changes) -> "SageConfig":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class ClusterData:
    """Stacked per-cluster arrays of one tile."""

    coh: torch.Tensor  # (M, F, 4, rows) complex cluster coherencies
    chunk_map: torch.Tensor  # (M, rows) int64 row -> hybrid chunk
    nchunk: torch.Tensor  # (M,) int64 chunk counts

    def replace(self, **changes) -> "ClusterData":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "ClusterData":
        return ClusterData(self.coh.to(device), self.chunk_map.to(device),
                           self.nchunk.to(device))


@dataclasses.dataclass
class SageResult:
    p: torch.Tensor  # (M, nchunk_max, 8N) solved parameters
    res_0: torch.Tensor  # initial residual norm / n
    res_1: torch.Tensor  # final residual norm / n
    mean_nu: torch.Tensor
    diverged: torch.Tensor  # bool, res_1 > res_0
    # wall seconds of the EM passes and the joint LBFGS, each ending in a
    # device synchronize; LBFGS iterations taken
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    lbfgs_iterations: int = 0


def _chunk_maps(data: VisData, nchunks: Sequence[int]) -> torch.Tensor:
    cmaps = []
    for nch in nchunks:
        tilechunk = -(-data.tilesz // nch)  # ceil
        cmaps.append(torch.clamp(data.time_idx // tilechunk, max=nch - 1))
    return torch.stack(cmaps).to(torch.int64)


def build_cluster_data(data: VisData, clusters: Sequence[SourceBatch],
                       nchunks: Sequence[int],
                       fdelta: Optional[float] = None) -> ClusterData:
    """Coherencies + chunk maps of every cluster, on the tile's device.

    Batched path (clusters padded to the largest source count and
    predicted in blocks of 16) unless padding would waste more than 4x
    the source count; then one predict per cluster.  Point skies only."""
    if fdelta is None:
        fdelta = data.deltaf
    for c in clusters:
        _check_point_only(c)
    sizes = [int(c.ll.shape[0]) for c in clusters]
    smax, total = max(sizes), sum(sizes)
    if smax * len(clusters) <= 4 * total and len(clusters) > 1:
        block = 16
        padded = [pad_source_batch(c, smax) for c in clusters]
        parts = []
        for i in range(0, len(padded), block):
            group = padded[i:i + block]
            stacked = SourceBatch(**{
                f.name: torch.stack([getattr(g, f.name) for g in group])
                for f in dataclasses.fields(SourceBatch)})
            parts.append(_predict_coherencies(
                data.u, data.v, data.w, data.freqs, stacked, float(fdelta), 32))
        coh = torch.cat(parts, dim=0)
    else:
        coh = torch.stack([
            predict_coherencies(data.u, data.v, data.w, data.freqs, src, fdelta)
            for src in clusters])
    return ClusterData(
        coh=coh, chunk_map=_chunk_maps(data, nchunks),
        nchunk=torch.as_tensor(list(nchunks), dtype=torch.int64,
                               device=coh.device),
    )


def cluster_model(p_k, coh_k, cmap_k, ant_p, ant_q):
    """One cluster's corrupted model J_p C J_q^H, flat (F, 4, rows).
    p_k (nchunk, 8N); coh_k (F, 4, rows); cmap_k (rows,)."""
    return corrupt_flat(params_to_jones(p_k), coh_k, ant_p, ant_q, cmap_k)


def predict_full_model(p_all, cdata: ClusterData, data: VisData):
    """sum_k J C J^H over all clusters, flat (F, 4, rows): gains gathered
    per (cluster, row) by index, then V = Jp (C Jq^H) contracted over the
    cluster axis."""
    jones = params_to_jones(p_all)  # (M, nchunk, N, 2, 2)
    M, nchunk, N = jones.shape[0], jones.shape[1], jones.shape[2]
    tab = jones.reshape(M * nchunk * N, 4)
    mrow = (torch.arange(M, device=tab.device)[:, None] * nchunk
            + cdata.chunk_map) * N  # (M, rows)

    def gains(ant):
        g = tab.index_select(0, (mrow + ant[None, :]).reshape(-1))
        g = g.reshape(M, 1, -1, 4)  # (M, 1, rows, 4) vs coh (M, F, rows)
        return g[..., 0], g[..., 1], g[..., 2], g[..., 3]

    pa, pb, pc, pd = gains(data.ant_p)
    qa, qb, qc, qd = (x.conj() for x in gains(data.ant_q))
    c00, c01 = cdata.coh[:, :, 0], cdata.coh[:, :, 1]
    c10, c11 = cdata.coh[:, :, 2], cdata.coh[:, :, 3]
    w00 = c00 * qa + c01 * qb
    w01 = c00 * qc + c01 * qd
    w10 = c10 * qa + c11 * qb
    w11 = c10 * qc + c11 * qd
    v00 = (pa * w00 + pb * w10).sum(0)
    v01 = (pa * w01 + pb * w11).sum(0)
    v10 = (pc * w00 + pd * w10).sum(0)
    v11 = (pc * w01 + pd * w11).sum(0)
    return torch.stack([v00, v01, v10, v11], dim=-2)


def em_residual_scan(data: VisData, cdata: ClusterData, p_all, extras,
                     solve_one):
    """One SAGE expectation pass: clusters in order, the residual carried
    (add back this cluster's model, solve, subtract the new model).

    ``solve_one(xeff, coh_k, cmap_k, p_k, extras_k) -> (p_new_k, aux_k)``;
    ``extras``: per-cluster list (or None).  Returns (p_new (M, ...),
    [aux_k])."""
    xres = data.vis - predict_full_model(p_all, cdata, data)
    p_new, aux = [], []
    for k in range(cdata.coh.shape[0]):
        coh_k, cmap_k, p_k = cdata.coh[k], cdata.chunk_map[k], p_all[k]
        xeff = xres + cluster_model(p_k, coh_k, cmap_k, data.ant_p, data.ant_q)
        pk_new, aux_k = solve_one(xeff, coh_k, cmap_k, p_k,
                                  None if extras is None else extras[k])
        xres = xeff - cluster_model(pk_new, coh_k, cmap_k, data.ant_p,
                                    data.ant_q)
        p_new.append(pk_new)
        aux.append(aux_k)
    return torch.stack(p_new), aux


def _res_norm(res, mask, nreal):
    r = res * mask[..., None, :]
    return torch.sqrt((r.abs() ** 2).sum()) / nreal


def _make_fused_joint_cost(data, cdata, M, nchunk_max, n8, robust, mean_nu,
                           coh_dtype="f32"):
    """Joint-LBFGS cost through the fused-objective kernels: predict,
    masked residual, Student's-t (or Gaussian) weighting and the scalar
    reduction in one pass over the coherency stack, forward and
    backward.  The packed arrays are built once here (constants of the
    LBFGS loop).  f32 only; ``coh_dtype="bf16"`` stores the coherency
    stack as bfloat16 (f32 math)."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_packed, fused_cost_packed_hybrid, pack_gain_tables,
        pack_predict_inputs,
    )

    if data.vis.real.dtype != torch.float32:
        raise ValueError(
            "use_fused_predict requires float32 data (the fused kernels "
            "compute in f32); use the torch-op path for f64")
    if coh_dtype not in ("f32", "bf16"):
        raise ValueError(f"coh_dtype must be 'f32' or 'bf16', got {coh_dtype!r}")
    N = n8 // 8
    if int(torch.maximum(data.ant_p.max(), data.ant_q.max())) >= N:
        raise ValueError("station index out of range of the gain tables")
    vis_ri, mask_p, coh_ri, antp, antq, cmap = pack_predict_inputs(
        data.vis, data.mask, cdata.coh, data.ant_p, data.ant_q,
        cdata.chunk_map if nchunk_max > 1 else None)
    if coh_dtype == "bf16":
        coh_ri = coh_ri.to(torch.bfloat16)
    nu_c = mean_nu if robust else None

    def cost_fn(pflat):
        jones = params_to_jones(pflat.reshape(M, nchunk_max, n8).float())
        if nchunk_max > 1:
            tre, tim = pack_gain_tables(jones, M)
            return fused_cost_packed_hybrid(tre, tim, coh_ri, antp, antq,
                                            vis_ri, mask_p, cmap, nchunk_max,
                                            nu_c)
        tre, tim = pack_gain_tables(jones[:, 0], M)
        return fused_cost_packed(tre, tim, coh_ri, antp, antq, vis_ri, mask_p,
                                 nu_c)

    return cost_fn


def _em_phase(data: VisData, cdata: ClusterData, p0, config: SageConfig,
              generator: torch.Generator):
    """The EM passes of :func:`sagefit`: per-cluster solves and nu
    estimation.  Returns (p, mean_nu, res_0)."""
    M = cdata.coh.shape[0]
    F, rows = data.vis.shape[-3], data.vis.shape[-1]
    nreal = rows * F * 8
    mode = config.solver_mode
    robust = mode in _ROBUST_MODES
    lmcfg = LMConfig(itmax=config.max_iter)
    total_iter = M * config.max_iter
    iter_bar = int(math.ceil((0.80 / M) * total_iter))

    res_0 = _res_norm(data.vis - predict_full_model(p0, cdata, data),
                      data.mask, nreal)

    def nerr_of(res):
        c0, c1 = res.cost0.sum(), res.cost.sum()
        return torch.where(c0 > 0.0, torch.clamp((c0 - c1) / c0, min=0.0),
                           torch.zeros_like(c0))

    p = p0
    nerr = torch.zeros((M,), dtype=p0.dtype, device=p0.device)
    weighted = False
    nus = torch.full((M,), config.nulow, dtype=p0.dtype, device=p0.device)
    for em in range(config.max_emiter):
        last_em = em == config.max_emiter - 1
        use_robust = robust and last_em
        use_os = mode in (SM_OSLM_LBFGS, SM_RLM_RLBFGS,
                          SM_OSLM_OSRLM_RLBFGS) and not last_em
        nerr_host = nerr.tolist()

        def solve_one(xeff, coh_k, cmap_k, p_k, k):
            args = (xeff, coh_k, data.mask, data.ant_p, data.ant_q, cmap_k, p_k)
            nu_k = torch.as_tensor(config.nulow, dtype=p0.dtype,
                                   device=p0.device)
            if use_robust:
                res, nu_k = robust_lm_solve(
                    *args, nu0=config.nulow, nulow=config.nulow,
                    nuhigh=config.nuhigh, em_iters=config.em_rounds_robust,
                    config=LMConfig(itmax=config.max_iter))
                nu_k = nu_k.to(p0.dtype)
            elif use_os:
                res = os_lm_solve(*args, lmcfg, nsubsets=2, generator=generator)
            else:
                itermax = (int(0.20 * nerr_host[k] * total_iter) + iter_bar
                           if weighted else config.max_iter)
                res = lm_solve(*args, lmcfg, itmax_dynamic=itermax)
            return res.p, (nerr_of(res), nu_k)

        p, aux = em_residual_scan(data, cdata, p, list(range(M)), solve_one)
        nerr_new = torch.stack([a[0] for a in aux])
        nus = torch.stack([a[1] for a in aux])
        tot = nerr_new.sum()
        nerr = torch.where(tot > 0.0, nerr_new / tot, nerr_new)
        if config.randomize:
            weighted = not weighted
    mean_nu = torch.clamp(nus.mean(), config.nulow, config.nuhigh)
    return p, mean_nu, res_0


def _clock(device) -> float:
    """Host seconds after the device has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _finalize(data, cdata, p, res_0, mean_nu) -> SageResult:
    F, rows = data.vis.shape[-3], data.vis.shape[-1]
    res_1 = _res_norm(data.vis - predict_full_model(p, cdata, data),
                      data.mask, rows * F * 8)
    return SageResult(p=p, res_0=res_0, res_1=res_1, mean_nu=mean_nu,
                      diverged=res_1 > res_0)


def _check_supported(config: SageConfig):
    missing = []
    if config.solver_mode not in _PORTED_MODES:
        missing.append(f"solver_mode={config.solver_mode} (RTR/NSD)")
    if config.param_bound > 0.0:
        missing.append("param_bound > 0 (LBFGS-B)")
    if config.collect_telemetry:
        missing.append("collect_telemetry")
    if config.collect_quality:
        missing.append("collect_quality")
    if missing:
        raise NotImplementedError(
            "not ported to sagecal_tpu_torch yet (ROADMAP.md Queue A): "
            + ", ".join(missing))


@true_f32
def sagefit(data: VisData, cdata: ClusterData, p0, config: SageConfig = SageConfig(),
            generator: Optional[torch.Generator] = None, device=None) -> SageResult:
    """One tile's SAGE calibration.  ``p0``: (M, nchunk_max, 8N).

    Runs on ``device`` (CUDA unless ``device="cpu"``); inputs elsewhere
    are moved there.  ``generator``: CPU ``torch.Generator`` for the
    OS-LM subsets (default: seeded with 0)."""
    _check_supported(config)
    dev = resolve_device(device)
    data = data if data.device == dev else data.to(dev)
    cdata = cdata if cdata.coh.device == dev else cdata.to(dev)
    p0 = torch.as_tensor(p0).to(dev)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    M = cdata.coh.shape[0]
    nchunk_max, n8 = p0.shape[1], p0.shape[2]
    robust = config.solver_mode in _ROBUST_MODES

    t0 = _clock(dev)
    p, mean_nu, res_0 = _em_phase(data, cdata, p0, config, generator)
    t1 = _clock(dev)
    lbfgs_iterations = 0
    if config.max_lbfgs > 0:
        if config.use_fused_predict:
            cost_fn = _make_fused_joint_cost(data, cdata, M, nchunk_max, n8,
                                             robust, mean_nu, config.coh_dtype)
        else:
            def cost_fn(pflat):
                model = predict_full_model(pflat.reshape(M, nchunk_max, n8),
                                           cdata, data)
                diff = (data.vis - model) * data.mask[..., None, :]
                e2 = diff.real ** 2 + diff.imag ** 2
                if robust:
                    return torch.log1p(e2 / mean_nu).sum()
                return e2.sum()

        fit = lbfgs_fit(cost_fn, None, p.reshape(-1), itmax=config.max_lbfgs,
                        M=config.lbfgs_m)
        p = fit.p.reshape(M, nchunk_max, n8).to(p0.dtype)
        lbfgs_iterations = fit.iterations
    t2 = _clock(dev)
    res = _finalize(data, cdata, p, res_0, mean_nu)
    res.phase_seconds = {"em": t1 - t0, "lbfgs": t2 - t1}
    res.lbfgs_iterations = lbfgs_iterations
    return res


def solve_tile(data: VisData, cdata: ClusterData, p0, config: SageConfig = SageConfig(),
               generator: Optional[torch.Generator] = None, device=None) -> SageResult:
    """Host convenience around :func:`sagefit`: ``p0`` may be numpy; the
    tile is moved to ``device`` (CUDA unless ``device="cpu"``)."""
    if isinstance(p0, np.ndarray):
        p0 = torch.from_numpy(p0)
    return sagefit(data, cdata, p0, config, generator, device=device)
