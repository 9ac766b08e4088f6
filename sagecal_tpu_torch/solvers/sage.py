"""SAGE/EM calibration driver (counterpart of ``sagecal_tpu/solvers/sage.py``).

One tile: coherencies per cluster (:func:`build_cluster_data`, any sky:
points, Gaussians, disks, rings and shapelets), EM passes that solve each
cluster against the residual with every other cluster's model removed
(:func:`em_residual_scan`: per-cluster LM, OS-LM, robust LM, RTR, robust
RTR or robust NSD), then one joint LBFGS over all gains, or LBFGS-B when
``param_bound > 0`` keeps every parameter within the bound.  With
``SageConfig.use_fused_predict`` every cost and gradient of the joint
LBFGS goes through the fused-objective CUDA kernels
(:func:`_make_fused_joint_cost`); otherwise through torch ops
(``predict_full_model`` + autograd).

Reproduced reference behaviours: weighted LM-iteration allocation by the
previous cost reduction, alternating with equal allocation when
``randomize`` is on; robust solves only on the final EM pass for the
LM-family modes, the mean Student's-t nu carried to the joint LBFGS;
OS acceleration on the earlier passes; res_0/res_1 bookkeeping.

:func:`sagefit_batched_fused` solves a serve bucket of B same-shape
tiles: the EM passes lane by lane, then one joint LBFGS of all lanes in
lock-step on the batched fused-objective kernels
(:func:`_make_fused_joint_cost_batch`); ``solvers/batched.py`` routes a
bucket to it.

Solver modes: 0 (OS-LM + LBFGS), 1 (LM + LBFGS), 2 (robust LM + robust
LBFGS), 3 (OS-LM, OS robust LM, robust LBFGS: the CLI default), 4 (RTR +
LBFGS), 5 (robust RTR + robust LBFGS), 6 (robust NSD + robust LBFGS); in
modes 5 and 6 each cluster's nu is carried across EM passes.
``collect_telemetry`` returns every per-cluster solver trace of every EM
pass and the joint LBFGS's (``SageResult.telemetry``), and
``collect_quality`` the final pass's per-cluster quality and the whole
solution's (``SageResult.quality``); both are written on the device and
read nothing more back to the host, and both off leave the solve as it
was.  ``jax.random`` keys become a ``torch.Generator`` (CPU) from which
the OS-LM row permutations are drawn.
:func:`sagefit_packed` is the real-array entry (the visibilities and
coherencies as real and imaginary parts); :func:`solve_tile` takes the
complex tile to :func:`sagefit` as it is.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from sagecal_tpu_torch.core.segment import gather_rows
from sagecal_tpu_torch.core.types import (
    VisData, corrupt_flat, params_to_jones, reals_of_flat,
)
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.obs.records import stack_traces
from sagecal_tpu_torch.ops.quality import (
    SolveQuality, chi2_scatter, gain_health, row_chi2, stack_quality,
)
from sagecal_tpu_torch.ops.rime import (
    _NO_TABLE, ST_POINT, ST_SHAPELET, SourceBatch, _predict_coherencies,
    pad_source_batch, predict_coherencies,
)
from sagecal_tpu_torch.solvers.lbfgs import lbfgs_fit, lbfgs_fit_batched
from sagecal_tpu_torch.solvers.lbfgsb import lbfgsb_fit
from sagecal_tpu_torch.solvers.lm import (
    LMConfig, NormalEqPlan, lm_solve, os_lm_solve,
)
from sagecal_tpu_torch.solvers.robust import robust_lm_solve
from sagecal_tpu_torch.solvers.rtr import (
    RTRConfig, nsd_solve_robust, rtr_solve, rtr_solve_robust,
)
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
    # every solver's per-iteration trace, in SageResult.telemetry
    collect_telemetry: bool = False
    # the final EM pass's per-cluster SolveQuality and the whole
    # solution's, in SageResult.quality
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
    """One tile's result; a batched solve gives the same fields with a
    leading lane axis B on every tensor and a list of B iteration
    counts."""

    p: torch.Tensor  # (M, nchunk_max, 8N) solved parameters
    res_0: torch.Tensor  # initial residual norm / n
    res_1: torch.Tensor  # final residual norm / n
    mean_nu: torch.Tensor
    diverged: torch.Tensor  # bool, res_1 > res_0
    # wall seconds of the EM passes and the joint LBFGS, each ending in a
    # device synchronize; LBFGS iterations taken (per lane when batched)
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    lbfgs_iterations: Union[int, List[int]] = 0
    # collect_telemetry: {"em": (IterTrace per EM pass, leading cluster
    # axis), "lbfgs": IterTrace or None}
    telemetry: Optional[dict] = None
    # collect_quality: {"em": SolveQuality of the final EM pass, leading
    # cluster axis; "final": SolveQuality of the whole solution}
    quality: Optional[dict] = None


def lane_of(obj, b: int):
    """Lane ``b`` of a batched :class:`VisData` or :class:`ClusterData`
    (every tensor field indexed on its leading axis; static fields
    kept)."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name)[b] for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def _chunk_maps(data: VisData, nchunks: Sequence[int]) -> torch.Tensor:
    cmaps = []
    for nch in nchunks:
        tilechunk = -(-data.tilesz // nch)  # ceil
        cmaps.append(torch.clamp(data.time_idx // tilechunk, max=nch - 1))
    return torch.stack(cmaps).to(torch.int64)


def build_cluster_data(data: VisData, clusters: Sequence[SourceBatch],
                       nchunks: Sequence[int],
                       fdelta: Optional[float] = None,
                       shapelets=None) -> ClusterData:
    """Coherencies + chunk maps of every cluster, on the tile's device.

    ``shapelets``: the sky-global ShapeletTable (``io.skymodel.load_sky``);
    clusters with shapelet members take the per-cluster path with it,
    the others keep the batched path, and the results are reassembled
    in cluster order.  Batched path: clusters padded to the largest
    source count and predicted in blocks of 16, unless padding would
    waste more than 4x the source count; then one predict per cluster."""
    if fdelta is None:
        fdelta = data.deltaf
    if shapelets is not None:
        shap = [bool((c.stype == ST_SHAPELET).any()) for c in clusters]
        if any(shap):
            plain_idx = [i for i, f in enumerate(shap) if not f]
            plain = build_cluster_data(
                data, [clusters[i] for i in plain_idx],
                [nchunks[i] for i in plain_idx], fdelta) if plain_idx else None
            parts = {i: plain.coh[j] for j, i in enumerate(plain_idx)}
            for i in (i for i, f in enumerate(shap) if f):
                parts[i] = predict_coherencies(
                    data.u, data.v, data.w, data.freqs, clusters[i], fdelta,
                    shapelets=shapelets)
            coh = torch.stack([parts[i] for i in range(len(clusters))])
            return _cluster_data(data, coh, nchunks)
    sizes = [int(c.ll.shape[0]) for c in clusters]
    smax, total = max(sizes), sum(sizes)
    if smax * len(clusters) <= 4 * total and len(clusters) > 1:
        stypes = torch.cat([c.stype.cpu() for c in clusters])
        if bool((stypes == ST_SHAPELET).any()):
            raise ValueError(_NO_TABLE)
        has_ext = bool((stypes != ST_POINT).any())
        block = 16
        padded = [pad_source_batch(c, smax) for c in clusters]
        parts = []
        for i in range(0, len(padded), block):
            group = padded[i:i + block]
            stacked = SourceBatch(**{
                f.name: torch.stack([getattr(g, f.name) for g in group])
                for f in dataclasses.fields(SourceBatch)})
            parts.append(_predict_coherencies(
                data.u, data.v, data.w, data.freqs, stacked, float(fdelta), 32,
                None, has_ext))
        coh = torch.cat(parts, dim=0)
    else:
        coh = torch.stack([
            predict_coherencies(data.u, data.v, data.w, data.freqs, src,
                                fdelta, shapelets=shapelets)
            for src in clusters])
    return _cluster_data(data, coh, nchunks)


def _cluster_data(data: VisData, coh, nchunks) -> ClusterData:
    return ClusterData(
        coh=coh, chunk_map=_chunk_maps(data, nchunks),
        nchunk=torch.as_tensor(list(nchunks), dtype=torch.int64,
                               device=coh.device),
    )


def build_cluster_data_withbeam(data: VisData,
                                clusters: Sequence[SourceBatch],
                                nchunks: Sequence[int], geom, pointing,
                                coeff, beam_mode: int, time_jd, ra0: float,
                                dec0: float, fdelta: Optional[float] = None,
                                wideband: bool = False, shapelets=None,
                                precess: bool = True) -> ClusterData:
    """Beam-aware coherencies: per cluster, the station beam toward each
    source folded into its coherencies (``ops/beam.py``: ``beam_jones``
    at float64, cast to the data's complex dtype, then
    ``predict_coherencies_withbeam``).  The same :class:`ClusterData` as
    :func:`build_cluster_data`, so the solvers and kernels take it as
    they are.

    ``geom``/``pointing``/``coeff``: ``StationGeometry`` (on the tile's
    device), ``BeamPointing``, ``ElementCoeffs`` or None; ``time_jd``:
    the tile's (tilesz,) Julian dates; each source's (ra, dec) comes from
    its direction cosines about (ra0, dec0).  ``precess``: precess the
    sources, the pointing and the tile beam centre from J2000 to the
    tile's mid-time epoch before az/el (off for the lunar ALO element)."""
    from sagecal_tpu_torch.ops.beam import (
        beam_jones, predict_coherencies_withbeam,
    )
    from sagecal_tpu_torch.ops.transforms import (
        get_precession_params, lmn_to_radec, precess_radec_equatorial,
    )

    if fdelta is None:
        fdelta = data.deltaf
    jd = np.asarray(time_jd)
    Tr = None
    if precess:
        Tr = get_precession_params(float(jd[len(jd) // 2]))
        pra, pdec = precess_radec_equatorial(pointing.ra0, pointing.dec0, Tr)
        bra, bdec = precess_radec_equatorial(pointing.b_ra0, pointing.b_dec0,
                                             Tr)
        pointing = pointing._replace(ra0=float(pra), dec0=float(pdec),
                                     b_ra0=float(bra), b_dec0=float(bdec))
    cohs = []
    for src in clusters:
        ra, dec = lmn_to_radec(src.ll.cpu().numpy(), src.mm.cpu().numpy(),
                               ra0, dec0)
        if Tr is not None:
            ra, dec = precess_radec_equatorial(ra, dec, Tr)
        B = beam_jones(geom, pointing, coeff, ra, dec, jd, data.freqs,
                       mode=beam_mode, wideband=wideband).to(data.vis.dtype)
        cohs.append(predict_coherencies_withbeam(
            data.u, data.v, data.w, data.freqs, src, B, data.time_idx,
            data.ant_p, data.ant_q, fdelta, shapelets=shapelets))
    return _cluster_data(data, torch.stack(cohs), nchunks)


def cluster_model(p_k, coh_k, cmap_k, ant_p, ant_q):
    """One cluster's corrupted model J_p C J_q^H, flat (F, 4, rows).
    p_k (nchunk, 8N); coh_k (F, 4, rows); cmap_k (rows,)."""
    return corrupt_flat(params_to_jones(p_k), coh_k, ant_p, ant_q, cmap_k)


def predict_full_model(p_all, cdata: ClusterData, data: VisData):
    """sum_k J C J^H over all clusters, flat (F, 4, rows): gains gathered
    per (cluster, row) by index (a fixed-order backward, so the torch-op
    joint cost's gradient is bit-identical on repeat), then
    V = Jp (C Jq^H) contracted over the cluster axis."""
    jones = params_to_jones(p_all)  # (M, nchunk, N, 2, 2)
    M, nchunk, N = jones.shape[0], jones.shape[1], jones.shape[2]
    tab = jones.reshape(M * nchunk * N, 4)
    mrow = (torch.arange(M, device=tab.device)[:, None] * nchunk
            + cdata.chunk_map) * N  # (M, rows)

    def gains(ant):
        g = gather_rows(tab, (mrow + ant[None, :]).reshape(-1))
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


def _fused_cost_prologue(vis, ant_p, ant_q, n8, coh_dtype):
    """The fused kernels' input rules, shared by the solo and batched
    joint costs: f32 data, ``coh_dtype`` "f32" or "bf16", stations within
    the ``n8 // 8`` columns of the gain tables.  Returns the dtype the
    packed coherency stack is stored in."""
    if vis.real.dtype != torch.float32:
        raise ValueError(
            "the fused joint cost requires float32 data (the kernels "
            "compute in f32); use the torch-op path for f64")
    if coh_dtype not in ("f32", "bf16"):
        raise ValueError(f"coh_dtype must be 'f32' or 'bf16', got {coh_dtype!r}")
    if int(torch.maximum(ant_p.max(), ant_q.max())) >= n8 // 8:
        raise ValueError("station index out of range of the gain tables")
    return torch.bfloat16 if coh_dtype == "bf16" else torch.float32


def _make_fused_joint_cost(data, cdata, M, nchunk_max, n8, robust, mean_nu,
                           coh_dtype="f32"):
    """Joint-LBFGS cost through the fused-objective kernels: predict,
    masked residual, Student's-t (or Gaussian) weighting and the scalar
    reduction in one pass over the coherency stack, forward and
    backward.  The packed arrays are built once here (constants of the
    LBFGS loop), and so is the backward's station plan (``BwdPlan``, the
    (role, row) -> station order of each row tile).  f32 only;
    ``coh_dtype="bf16"`` stores the coherency stack as bfloat16 (f32
    math)."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        BwdPlan, fused_cost_packed, fused_cost_packed_hybrid,
        pack_gain_tables, pack_predict_inputs,
    )

    coh_store = _fused_cost_prologue(data.vis, data.ant_p, data.ant_q, n8,
                                     coh_dtype)
    vis_ri, mask_p, coh_ri, antp, antq, cmap = pack_predict_inputs(
        data.vis, data.mask, cdata.coh, data.ant_p, data.ant_q,
        cdata.chunk_map if nchunk_max > 1 else None)
    coh_ri = coh_ri.to(coh_store)
    nu_c = mean_nu if robust else None
    plan = BwdPlan(antp, antq, cmap, nchunk_max, n8 // 8)

    def cost_fn(pflat):
        jones = params_to_jones(pflat.reshape(M, nchunk_max, n8).float())
        if nchunk_max > 1:
            tre, tim = pack_gain_tables(jones, M)
            return fused_cost_packed_hybrid(tre, tim, coh_ri, antp, antq,
                                            vis_ri, mask_p, cmap, nchunk_max,
                                            nu_c, plan=plan)
        tre, tim = pack_gain_tables(jones[:, 0], M)
        return fused_cost_packed(tre, tim, coh_ri, antp, antq, vis_ri, mask_p,
                                 nu_c, plan=plan)

    return cost_fn


def _make_fused_joint_cost_batch(data, cdata, B, M, n8, robust, mean_nu_b,
                                 coh_dtype="f32", valid=None):
    """Batched joint-LBFGS cost: the fused objective of B lanes in one
    launch of the batched kernels (``fused_cost_packed_batch``), (B, M*8N)
    parameters -> (B,) per-lane costs.  ``data``/``cdata`` carry a leading
    lane axis; every lane shares lane 0's ``ant_p``/``ant_q`` (the router
    checks it), so one backward station plan (``BwdPlan``), built here
    from lane 0's packed indices, serves every lane and every launch.
    ``mean_nu_b``: (B,) per-lane nu on the device.
    ``valid``: optional (B,) lane mask zeroing padded lanes' cost and
    cotangent.  f32 data only; ``coh_dtype="bf16"`` stores the coherency
    stack as bfloat16 (f32 math)."""
    from sagecal_tpu_torch.ops.rime_kernel import (
        BwdPlan, fused_cost_packed_batch, pack_cost_inputs_batch,
        pack_gain_tables_batch,
    )

    ant_p, ant_q = data.ant_p[0], data.ant_q[0]
    coh_store = _fused_cost_prologue(data.vis, ant_p, ant_q, n8, coh_dtype)
    vis_ri, mask_p, coh_ri, antp, antq = pack_cost_inputs_batch(
        data.vis, data.mask, cdata.coh, ant_p, ant_q, valid=valid)
    coh_ri = coh_ri.to(coh_store)
    nu_c = mean_nu_b if robust else None
    plan = BwdPlan(antp, antq, None, 1, n8 // 8)

    def cost_fn(pflat_b):
        jones = params_to_jones(pflat_b.reshape(B, M, n8).float())
        tre, tim = pack_gain_tables_batch(jones)
        return fused_cost_packed_batch(tre, tim, coh_ri, antp, antq, vis_ri,
                                       mask_p, nu_c, plan=plan)

    return cost_fn


def _em_phase(data: VisData, cdata: ClusterData, p0, config: SageConfig,
              generator: torch.Generator):
    """The EM passes of :func:`sagefit`: per-cluster solves and nu
    estimation.  Returns (p, mean_nu, res_0, em_traces, em_quality,
    plans): with ``collect_telemetry`` one IterTrace per pass (leading
    cluster axis), with ``collect_quality`` the final pass's
    SolveQuality (leading cluster axis), and the solvers' NormalEqPlans
    (one per distinct chunk map)."""
    M = cdata.coh.shape[0]
    F, rows = data.vis.shape[-3], data.vis.shape[-1]
    nreal = rows * F * 8
    mode = config.solver_mode
    robust = mode in _ROBUST_MODES
    lmcfg = LMConfig(itmax=config.max_iter)
    total_iter = M * config.max_iter
    iter_bar = int(math.ceil((0.80 / M) * total_iter))
    collect = config.collect_telemetry

    iter_cap = config.max_iter * config.iter_budget_cap
    rtr_cfg = RTRConfig(itmax_rsd=iter_cap + 5, itmax_rtr=iter_cap + 10)
    robust_kw = dict(nulow=config.nulow, nuhigh=config.nuhigh,
                     em_iters=config.em_rounds_robust)

    res_0 = _res_norm(data.vis - predict_full_model(p0, cdata, data),
                      data.mask, nreal)

    def nerr_of(res):
        c0, c1 = res.cost0.sum(), res.cost.sum()
        return torch.where(c0 > 0.0, torch.clamp((c0 - c1) / c0, min=0.0),
                           torch.zeros_like(c0))

    # the solvers' fixed-order sums (LM assembly, RTR station sums) of
    # each distinct chunk map, planned once per tile
    plans = []

    def plan_of(cmap_k):
        for cmap, plan in plans:
            if torch.equal(cmap, cmap_k):
                return plan
        plan = NormalEqPlan(data.ant_p, data.ant_q, cmap_k, p0.shape[1],
                            p0.shape[2] // 8)
        plans.append((cmap_k, plan))
        return plan

    p = p0
    nerr = torch.zeros((M,), dtype=p0.dtype, device=p0.device)
    weighted = False
    nus = torch.full((M,), config.nulow, dtype=p0.dtype, device=p0.device)
    em_traces, em_quality = [], None
    for em in range(config.max_emiter):
        last_em = em == config.max_emiter - 1
        use_robust = robust and last_em
        use_os = mode in (SM_OSLM_LBFGS, SM_RLM_RLBFGS,
                          SM_OSLM_OSRLM_RLBFGS) and not last_em
        # quality of the final pass only: earlier iterates are discarded
        want_q = config.collect_quality and last_em
        flags = dict(collect_trace=collect, collect_quality=want_q)
        nerr_host = nerr.tolist()

        def solve_one(xeff, coh_k, cmap_k, p_k, k):
            args = (xeff, coh_k, data.mask, data.ant_p, data.ant_q, cmap_k, p_k)
            plan = plan_of(cmap_k)
            nu_k = torch.as_tensor(config.nulow, dtype=p0.dtype,
                                   device=p0.device)
            itermax = (int(0.20 * nerr_host[k] * total_iter) + iter_bar
                       if weighted else config.max_iter)
            if mode == SM_RTR_OSLM_LBFGS:
                res = rtr_solve(*args, rtr_cfg, itmax_dynamic=itermax,
                                plan=plan, **flags)
            elif mode == SM_RTR_OSRLM_RLBFGS:
                res, nu_k = rtr_solve_robust(
                    *args, rtr_cfg, nu0=nus[k], itmax_dynamic=itermax,
                    plan=plan, **robust_kw, **flags)
                nu_k = nu_k.to(p0.dtype)
            elif mode == SM_NSD_RLBFGS:
                res, nu_k = nsd_solve_robust(
                    *args, itmax=iter_cap + 15, nu0=nus[k],
                    itmax_dynamic=itermax, plan=plan, **robust_kw, **flags)
                nu_k = nu_k.to(p0.dtype)
            elif use_robust:
                res, nu_k = robust_lm_solve(
                    *args, nu0=config.nulow, nulow=config.nulow,
                    nuhigh=config.nuhigh, em_iters=config.em_rounds_robust,
                    config=LMConfig(itmax=config.max_iter), plan=plan,
                    **flags)
                nu_k = nu_k.to(p0.dtype)
            elif use_os:
                res = os_lm_solve(*args, lmcfg, nsubsets=2, generator=generator,
                                  plan=plan, **flags)
            else:
                res = lm_solve(*args, lmcfg, itmax_dynamic=itermax, plan=plan,
                               **flags)
            return res.p, (nerr_of(res), nu_k, res.trace, res.quality)

        p, aux = em_residual_scan(data, cdata, p, list(range(M)), solve_one)
        nerr_new = torch.stack([a[0] for a in aux])
        nus = torch.stack([a[1] for a in aux])
        if collect:
            em_traces.append(stack_traces([a[2] for a in aux]))
        if want_q:
            em_quality = stack_quality([a[3] for a in aux])
        tot = nerr_new.sum()
        nerr = torch.where(tot > 0.0, nerr_new / tot, nerr_new)
        if config.randomize:
            weighted = not weighted
    mean_nu = torch.clamp(nus.mean(), config.nulow, config.nuhigh)
    return (p, mean_nu, res_0, em_traces, em_quality,
            [plan for _, plan in plans])


def _clock(device) -> float:
    """Host seconds after the device has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _finalize(data, cdata, p, res_0, mean_nu, config: SageConfig,
              lbfgs_trace=None, em_traces=(), em_quality=None,
              plans=()) -> SageResult:
    """res_1 of the final solution, and the telemetry and quality
    bundles the config asks for.  The whole-solution quality attributes
    the full residual (every cluster's model subtracted) per station and
    baseline on one of the EM's ``plans`` (its chunks summed), with a
    single chunk, and the gain health of every (cluster, chunk) lane."""
    F, rows = data.vis.shape[-3], data.vis.shape[-1]
    resid = data.vis - predict_full_model(p, cdata, data)
    res_1 = _res_norm(resid, data.mask, rows * F * 8)
    telemetry = ({"em": tuple(em_traces), "lbfgs": lbfgs_trace}
                 if config.collect_telemetry else None)
    quality = None
    if config.collect_quality:
        N = p.shape[-1] // 8
        plan = plans[0] if plans else NormalEqPlan(
            data.ant_p, data.ant_q, torch.zeros_like(data.ant_p), 1, N)
        e = reals_of_flat(resid * data.mask[..., None, :])
        chi2_st, chi2_bl, chi2_ch = chi2_scatter(
            row_chi2(e), data.ant_p, data.ant_q, None, N, 1, plan)
        nonfinite, amp, amp_sp, ph_sp, dep = gain_health(p)
        robust = config.solver_mode in _ROBUST_MODES
        final_q = SolveQuality(
            chi2_station=chi2_st, chi2_baseline=chi2_bl, chi2_chunk=chi2_ch,
            nonfinite_count=nonfinite, station_amp=amp,
            station_amp_spread=amp_sp, station_phase_spread=ph_sp,
            identity_departure=dep, nu=mean_nu if robust else None)
        quality = {"em": em_quality, "final": final_q}
    return SageResult(p=p, res_0=res_0, res_1=res_1, mean_nu=mean_nu,
                      diverged=res_1 > res_0, telemetry=telemetry,
                      quality=quality)


@true_f32
def sagefit(data: VisData, cdata: ClusterData, p0, config: SageConfig = SageConfig(),
            generator: Optional[torch.Generator] = None, device=None) -> SageResult:
    """One tile's SAGE calibration.  ``p0``: (M, nchunk_max, 8N).

    Runs on ``device`` (CUDA unless ``device="cpu"``); inputs elsewhere
    are moved there.  ``generator``: CPU ``torch.Generator`` for the
    OS-LM subsets (default: seeded with 0)."""
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
    p, mean_nu, res_0, em_traces, em_quality, plans = _em_phase(
        data, cdata, p0, config, generator)
    t1 = _clock(dev)
    lbfgs_iterations, lbfgs_trace = 0, None
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

        if config.param_bound > 0.0:
            fit = lbfgsb_fit(cost_fn, None, p.reshape(-1),
                             lb=-config.param_bound, ub=config.param_bound,
                             itmax=config.max_lbfgs, M=config.lbfgs_m)
        else:
            fit = lbfgs_fit(cost_fn, None, p.reshape(-1),
                            itmax=config.max_lbfgs, M=config.lbfgs_m,
                            collect_trace=config.collect_telemetry)
            lbfgs_trace = fit.trace
        p = fit.p.reshape(M, nchunk_max, n8).to(p0.dtype)
        lbfgs_iterations = fit.iterations
    t2 = _clock(dev)
    res = _finalize(data, cdata, p, res_0, mean_nu, config, lbfgs_trace,
                    em_traces, em_quality, plans)
    res.phase_seconds = {"em": t1 - t0, "lbfgs": t2 - t1}
    res.lbfgs_iterations = lbfgs_iterations
    return res


def sagefit_packed(data: VisData, cdata: ClusterData, vis_re, vis_im, coh_re,
                   coh_im, p0, config: SageConfig = SageConfig(),
                   generator: Optional[torch.Generator] = None,
                   device=None) -> SageResult:
    """The tile solve on real arrays: ``data`` with ``vis=None`` and
    ``cdata`` with ``coh=None``, the visibilities (F, 4, rows) and
    coherencies (M, F, 4, rows) given as real and imaginary parts, put
    back together on ``device`` before :func:`sagefit` runs."""
    dev = resolve_device(device)
    join = lambda re, im: torch.complex(torch.as_tensor(re).to(dev),
                                        torch.as_tensor(im).to(dev))
    return sagefit(data.replace(vis=join(vis_re, vis_im)),
                   cdata.replace(coh=join(coh_re, coh_im)), p0, config,
                   generator, device=dev)


def solve_tile(data: VisData, cdata: ClusterData, p0, config: SageConfig = SageConfig(),
               generator: Optional[torch.Generator] = None, device=None) -> SageResult:
    """Host convenience around :func:`sagefit`: ``p0`` may be numpy; the
    tile is moved to ``device`` (CUDA unless ``device="cpu"``).  The
    tile stays complex: :func:`sagefit_packed`'s real/imaginary split
    exists for callers holding real arrays, and its join would copy the
    coherency stack."""
    if isinstance(p0, np.ndarray):
        p0 = torch.from_numpy(p0)
    return sagefit(data, cdata, p0, config, generator, device=device)


@true_f32
def sagefit_batched_fused(data: VisData, cdata: ClusterData, p0,
                          config: SageConfig = SageConfig(),
                          generators: Optional[Sequence[torch.Generator]] = None,
                          valid=None, device=None) -> SageResult:
    """B independent tile solves whose joint LBFGS runs all lanes in
    lock-step on the batched fused-objective kernels.

    ``data``/``cdata``: every tensor field carries a leading lane axis B,
    and all lanes share one baseline geometry (``choose_batched_path``
    checks it); ``p0`` is (B, M, 1, 8N).  ``generators``: one CPU
    ``torch.Generator`` per lane (``derive_lane_generators``; default
    lanes 0..B-1 of seed 0).  ``valid``: optional (B,) lane mask; padded
    lanes run the EM phase on their replicated data, but their mask is
    zeroed in the LBFGS pack, so they add exactly zero cost and
    cotangent there.  ``collect_quality`` gives each lane's quality, as
    its own :func:`sagefit` would, stacked on a leading lane axis;
    ``collect_telemetry`` is refused, as in the reference.

    The EM phase is :func:`_em_phase` run lane by lane, each with its own
    generator (the reference vmaps it; the port's EM reads the host,
    which ``torch.func.vmap`` cannot trace).  The joint LBFGS is
    :func:`lbfgs_fit_batched` over ``fused_cost_packed_batch``: one
    batched kernel launch per cost or gradient for the whole bucket.
    ``_finalize`` runs per lane.  Returns a :class:`SageResult` with a
    leading B on every tensor, ``phase_seconds`` {"em", "lbfgs"} and the
    per-lane LBFGS iteration counts."""
    B, M, nchunk_max, n8 = p0.shape
    if nchunk_max != 1:
        raise ValueError(
            "sagefit_batched_fused requires nchunk_max == 1 (the batched "
            "kernel has no hybrid-chunk selection); use the per-lane path")
    if config.param_bound > 0.0 or config.collect_telemetry:
        raise ValueError(
            "batched fused path supports neither param_bound nor "
            "telemetry traces; use the per-lane path")
    dev = resolve_device(device)
    data = data if data.device == dev else data.to(dev)
    cdata = cdata if cdata.coh.device == dev else cdata.to(dev)
    p0 = torch.as_tensor(p0).to(dev)
    if generators is None:
        from sagecal_tpu_torch.solvers.batched import derive_lane_generators
        generators = derive_lane_generators(0, range(B))
    robust = config.solver_mode in _ROBUST_MODES
    lanes = [(lane_of(data, b), lane_of(cdata, b)) for b in range(B)]

    t0 = _clock(dev)
    em = [_em_phase(d, c, p0[b], config, generators[b])
          for b, (d, c) in enumerate(lanes)]
    p_b = torch.stack([e[0] for e in em])
    mean_nu_b = torch.stack([e[1] for e in em])
    t1 = _clock(dev)
    iterations = [0] * B
    if config.max_lbfgs > 0:
        cost_fn = _make_fused_joint_cost_batch(
            data, cdata, B, M, n8, robust, mean_nu_b, config.coh_dtype, valid)
        fit = lbfgs_fit_batched(cost_fn, p_b.reshape(B, -1),
                                itmax=config.max_lbfgs, M=config.lbfgs_m)
        p_b = fit.p.reshape(B, M, nchunk_max, n8).to(p0.dtype)
        iterations = fit.iterations.tolist()
    t2 = _clock(dev)
    fins = [_finalize(d, c, p_b[b], em[b][2], mean_nu_b[b], config,
                      em_quality=em[b][4], plans=em[b][5])
            for b, (d, c) in enumerate(lanes)]
    quality = None
    if config.collect_quality:
        quality = {k: stack_quality([r.quality[k] for r in fins])
                   for k in ("em", "final")}
    return SageResult(
        p=p_b, res_0=torch.stack([r.res_0 for r in fins]),
        res_1=torch.stack([r.res_1 for r in fins]), mean_nu=mean_nu_b,
        diverged=torch.stack([r.diverged for r in fins]),
        phase_seconds={"em": t1 - t0, "lbfgs": t2 - t1},
        lbfgs_iterations=iterations, quality=quality)
