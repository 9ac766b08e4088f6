"""Levenberg-Marquardt for per-cluster Jones solves (counterpart of
``sagecal_tpu/solvers/lm.py``).

Each residual row (one baseline, 8F reals) depends only on the 16
parameters of its two stations, so J^T J is assembled from per-row 8x8
blocks summed into an (nchunk, N, N, 8, 8) grid and J^T e from per-row
8-vectors, for all hybrid chunks at once; the LM iterations of all
chunks run in lock-step (per-chunk damping and acceptance, masked once
a chunk terminates) and the (8N x 8N) damped systems are solved by a
batched Cholesky.

The sums by block and by chunk are fixed-order segment sums
(:class:`NormalEqPlan`, built once per tile by the caller, or once per
:func:`lm_solve` when not given, and reused by every iteration), not
``index_add_``: on CUDA that adds with float atomics, and two runs of
one solve would differ in the last bits, which the LM iterations
amplify.  The EM is bit-identical on repeat.

Where the JAX package takes ``jax.jacfwd`` of a per-row model, this
port writes the per-row Jacobian in closed form (:func:`_row_jacobians`):
for ``M = Jp A``, ``A = C Jq^H`` and ``B = Jp C``,
``dM_ij/dRe Jp_ka = d_ik A_aj``, ``dM_ij/dIm Jp_ka = i d_ik A_aj``,
``dM_ij/dRe Jq_kb = d_jk B_ib`` and ``dM_ij/dIm Jq_kb = -i d_jk B_ib``.

Termination follows levmar: max iterations, gradient inf-norm < eps1,
relative step < eps2, cost < eps3; Nielsen's damping update.  The
``while_loop`` is a Python loop that reads one flag per iteration.

``collect_trace`` fills an ``obs.records.IterTrace`` of ``(itmax,
nchunk)`` rows (NaN past the last iteration run), ``collect_quality`` an
``ops.quality.SolveQuality`` of the final residual; both are written on
the device, reading nothing more back, and both off leave the solve as
it was.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from sagecal_tpu_torch.core.segment import SegmentPlan
from sagecal_tpu_torch.core.types import corrupt_flat, params_to_jones, reals_of_flat
from sagecal_tpu_torch.obs.records import IterTrace, init_trace, write_trace
from sagecal_tpu_torch.ops.quality import SolveQuality, residual_quality
from sagecal_tpu_torch.utils.precision import true_f32


@dataclasses.dataclass(frozen=True)
class LMConfig:
    itmax: int = 10
    tau: float = 1e-3
    eps1: float = 1e-15
    eps2: float = 1e-15
    eps3: float = 1e-15


class LMResult(NamedTuple):
    p: torch.Tensor  # (nchunk, 8N)
    cost0: torch.Tensor  # (nchunk,) initial cost
    cost: torch.Tensor  # (nchunk,) final cost
    iterations: int
    trace: Optional[IterTrace] = None  # when collect_trace
    quality: Optional[SolveQuality] = None  # when collect_quality


def _residual_flat(p_all, coh, vis, mask, ant_p, ant_q, chunk_map, sqrt_w):
    """Real residual (F, 8, rows): reals of (vis - J_p C J_q^H) * mask
    (* sqrt_w), in the reference's 8-real ordering."""
    model = corrupt_flat(params_to_jones(p_all), coh, ant_p, ant_q, chunk_map)
    r = reals_of_flat((vis - model) * mask[..., None, :])
    if sqrt_w is not None:
        r = r * sqrt_w
    return r


def _param_index(k: int, a: int) -> int:
    """Position of Jones element (k, a) in the 8-real station block
    (``[Re J00, Im J00, Re J10, Im J10, Re J01, Im J01, Re J11, Im J11]``)."""
    return 2 * (k + 2 * a)


def _row_jacobians(pp, qq, C):
    """Closed-form per-row Jacobians of the row model (module doc).

    pp, qq: (R, 8) station params; C: (R, F, 2, 2) complex.  Returns
    (Jp, Jq), each (R, F*8, 8) real, rows ordered (f, i, j, re/im) —
    the layout of one row of :func:`_residual_flat`."""
    R, F = C.shape[0], C.shape[1]
    Jpm = params_to_jones(pp)[:, 0]  # (R, 2, 2)
    Jqm = params_to_jones(qq)[:, 0]
    A = C @ Jqm.conj().transpose(-1, -2)[:, None]  # (R, F, 2, 2) = C Jq^H
    B = Jpm[:, None] @ C  # Jp C
    jp = torch.zeros((R, F, 2, 2, 2, 8), dtype=A.real.dtype, device=A.device)
    jq = torch.zeros_like(jp)
    for i in range(2):
        for j in range(2):
            for a in range(2):
                # d M_ij / d Jp_ia = A_aj ;  d M_ij / d Jq_ja = B_ia (re part)
                col = _param_index(i, a)
                dA = A[:, :, a, j]
                jp[:, :, i, j, 0, col] = dA.real
                jp[:, :, i, j, 1, col] = dA.imag
                jp[:, :, i, j, 0, col + 1] = -dA.imag  # times i
                jp[:, :, i, j, 1, col + 1] = dA.real
                colq = _param_index(j, a)
                dB = B[:, :, i, a]
                jq[:, :, i, j, 0, colq] = dB.real
                jq[:, :, i, j, 1, colq] = dB.imag
                jq[:, :, i, j, 0, colq + 1] = dB.imag  # times -i
                jq[:, :, i, j, 1, colq + 1] = -dB.real
    return jp.reshape(R, F * 8, 8), jq.reshape(R, F * 8, 8)


class NormalEqPlan:
    """The fixed-order sums of one tile's LM assembly (module doc).

    ``cost``: rows -> chunk.  ``station``: the 2*rows items (every row as
    station p, then every row as station q) -> (chunk, station), for
    J^T e and the diagonal blocks of J^T J.  ``pair``: the 2*rows items
    (chunk, p, q), then (chunk, q, p) -> the (chunk, N, N) block grid,
    for the off-diagonal blocks.  Diagonal and off-diagonal blocks have
    plans of their own because a station's block gathers ~tilesz*(N-1)
    rows and a baseline's ~tilesz.  The RTR/NSD solvers
    (``solvers/rtr.py``) sum their per-station gradients on ``station``
    and their costs on ``cost``."""

    def __init__(self, ant_p, ant_q, chunk_map, nchunk: int, N: int):
        cp, cq = chunk_map * N + ant_p, chunk_map * N + ant_q
        self.idx_p, self.idx_q = cp, cq  # each row's (chunk, station)
        self.nchunk, self.N = nchunk, N
        self.cost = SegmentPlan(chunk_map, nchunk)
        self.station = SegmentPlan(torch.cat([cp, cq]), nchunk * N)
        self.pair = SegmentPlan(torch.cat([cp * N + ant_q, cq * N + ant_p]),
                                nchunk * N * N)


def _assemble_normal_eq(p_all, coh, vis, mask, ant_p, ant_q, chunk_map,
                        plan: NormalEqPlan, sqrt_w):
    """-> (JTJ (nchunk, 8N, 8N), JTe (nchunk, 8N), cost (nchunk,)).

    Residual e = vis - model, Jacobian of the model, so the gradient of
    0.5||e||^2 is -J^T e; JTe = J^T e and the LM step solves
    (JTJ + mu I) dp = JTe."""
    nchunk, N = plan.nchunk, plan.N
    F, rows = vis.shape[-3], ant_p.shape[0]
    e = _residual_flat(p_all, coh, vis, mask, ant_p, ant_q, chunk_map, sqrt_w)
    cost = plan.cost.sum((e * e).sum(dim=(0, 1)))

    pblk = p_all.reshape(nchunk * N, 8)
    pp = pblk.index_select(0, chunk_map * N + ant_p)  # (rows, 8)
    qq = pblk.index_select(0, chunk_map * N + ant_q)
    C = coh.permute(2, 0, 1).reshape(rows, F, 2, 2)
    Jp, Jq = _row_jacobians(pp, qq, C)  # (rows, F8, 8)
    wrow = mask.transpose(0, 1).repeat_interleave(8, dim=1)  # (rows, F8)
    if sqrt_w is not None:
        sw = torch.broadcast_to(sqrt_w, e.shape)
        wrow = wrow * sw.permute(2, 0, 1).reshape(rows, F * 8)
    Jp = Jp * wrow[..., None]
    Jq = Jq * wrow[..., None]
    erow = e.permute(2, 0, 1).reshape(rows, F * 8)
    App = torch.einsum("rki,rkj->rij", Jp, Jp)
    Apq = torch.einsum("rki,rkj->rij", Jp, Jq)
    Aqq = torch.einsum("rki,rkj->rij", Jq, Jq)
    gp = torch.einsum("rki,rk->ri", Jp, erow)
    gq = torch.einsum("rki,rk->ri", Jq, erow)

    JTJ = plan.pair.sum(torch.cat([Apq, Apq.transpose(-1, -2)]))
    JTJ = JTJ.reshape(nchunk, N, N, 8, 8)
    diag = plan.station.sum(torch.cat([App, Aqq])).reshape(nchunk, N, 8, 8)
    JTJ.diagonal(dim1=1, dim2=2).add_(diag.permute(0, 2, 3, 1))
    JTe = plan.station.sum(torch.cat([gp, gq]))
    JTJ = JTJ.permute(0, 1, 3, 2, 4)
    return (JTJ.reshape(nchunk, 8 * N, 8 * N), JTe.reshape(nchunk, 8 * N),
            cost)


def _cost_only(p_all, coh, vis, mask, ant_p, ant_q, chunk_map,
               plan: NormalEqPlan, sqrt_w):
    e = _residual_flat(p_all, coh, vis, mask, ant_p, ant_q, chunk_map, sqrt_w)
    return plan.cost.sum((e * e).sum(dim=(0, 1)))


def _solve_spd(A, b):
    """Batched damped normal-equation solve: Cholesky of A + 1e-9 I, with
    a plain solve of A + 1e-5 I where the Cholesky fails or is not
    finite."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A + 1e-9 * eye)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    ok = (info == 0) & torch.isfinite(x).all(dim=-1)
    x2 = torch.linalg.solve(A + 1e-5 * eye, b)
    return torch.where(ok[:, None], x, x2)


def _plan_for(plan, ant_p, ant_q, chunk_map, p0) -> NormalEqPlan:
    if plan is None:
        plan = NormalEqPlan(ant_p, ant_q, chunk_map, p0.shape[0],
                            p0.shape[-1] // 8)
    return plan


@true_f32
def lm_solve(vis, coh, mask, ant_p, ant_q, chunk_map, p0,
             config: LMConfig = LMConfig(), sqrt_weights=None,
             itmax_dynamic: Optional[int] = None,
             plan: Optional[NormalEqPlan] = None,
             collect_trace: bool = False,
             collect_quality: bool = False) -> LMResult:
    """Solve min_p sum_rows ||vis - J_p C J_q^H||^2 per hybrid chunk.

    vis/coh: (F, 4, rows) complex; mask (F, rows); ant_p/ant_q/chunk_map
    (rows,) int64; p0 (nchunk, 8N).  ``itmax_dynamic`` lowers the
    iteration bound below ``config.itmax`` (the SAGE driver's weighted
    allocation).  ``plan``: the tile's :class:`NormalEqPlan` for these
    indices (built here when None).  ``collect_trace`` /
    ``collect_quality``: the per-iteration trace (cost, gradient
    inf-norm, ||dp||, one evaluation per live chunk) and the final
    residual's quality (module doc)."""
    nchunk = p0.shape[0]
    plan = _plan_for(plan, ant_p, ant_q, chunk_map, p0)
    args = (coh, vis, mask, ant_p, ant_q, chunk_map, plan, sqrt_weights)
    JTJ, JTe, cost0 = _assemble_normal_eq(p0, *args)
    mu = config.tau * torch.diagonal(JTJ, dim1=-2, dim2=-1).amax(dim=-1)
    it_bound = config.itmax if itmax_dynamic is None else min(
        config.itmax, int(itmax_dynamic))
    n8 = p0.shape[-1]
    eye = torch.eye(n8, dtype=p0.dtype, device=p0.device)
    p, cost = p0, cost0
    nu = torch.full((nchunk,), 2.0, dtype=p0.dtype, device=p0.device)
    done = torch.zeros((nchunk,), dtype=torch.bool, device=p0.device)
    trace = (init_trace(config.itmax, (nchunk,), p0.dtype, p0.device)
             if collect_trace else None)
    it = 0
    while it < it_bound and not bool(done.all()):
        JTJ, JTe, _ = _assemble_normal_eq(p, *args)
        dp = _solve_spd(JTJ + mu[:, None, None] * eye, JTe)
        pnew = p + dp
        cost_new = _cost_only(pnew, *args)
        denom = (dp * (mu[:, None] * dp + JTe)).sum(dim=-1)
        gain = (cost - cost_new) / torch.where(
            denom == 0.0, torch.full_like(denom, 1e-30), denom)
        accept = (gain > 0.0) & torch.isfinite(cost_new) & ~done
        fac = torch.clamp(1.0 - (2.0 * gain - 1.0) ** 3, min=1.0 / 3.0)
        p1 = torch.where(accept[:, None], pnew, p)
        cost1 = torch.where(accept, cost_new, cost)
        mu = torch.where(done, mu, torch.where(accept, mu * fac, mu * nu))
        nu = torch.where(done, nu, torch.where(accept, torch.full_like(nu, 2.0),
                                               2.0 * nu))
        g_inf = JTe.abs().amax(dim=-1)
        small_step = torch.linalg.norm(dp, dim=-1) <= config.eps2 * (
            torch.linalg.norm(p1, dim=-1) + config.eps2)
        if trace is not None:
            write_trace(trace, it, cost=cost1, grad_norm=g_inf,
                        step=torch.linalg.norm(dp, dim=-1),
                        ls_evals=(~done).to(p.dtype))
        done = done | (g_inf <= config.eps1) | small_step | (cost1 <= config.eps3)
        p, cost = p1, cost1
        it += 1
    quality = _quality(p, args) if collect_quality else None
    return LMResult(p=p, cost0=cost0, cost=cost, iterations=it, trace=trace,
                    quality=quality)


def _quality(p, args) -> SolveQuality:
    """Quality of the residual at ``p`` (``args`` as :func:`_cost_only`
    takes them after ``p``)."""
    coh, vis, mask, ant_p, ant_q, chunk_map, plan, sqrt_w = args
    e = _residual_flat(p, coh, vis, mask, ant_p, ant_q, chunk_map, sqrt_w)
    return residual_quality(e, p, ant_p, ant_q, chunk_map, p.shape[0],
                            plan=plan)


@true_f32
def os_lm_solve(vis, coh, mask, ant_p, ant_q, chunk_map, p0,
                config: LMConfig = LMConfig(), sqrt_weights=None,
                nsubsets: int = 4, perm=None,
                generator: Optional[torch.Generator] = None,
                plan: Optional[NormalEqPlan] = None,
                collect_trace: bool = False,
                collect_quality: bool = False) -> LMResult:
    """Ordered-subsets accelerated LM: one LM pass per random subset of
    rows (subsets realized as masks).  ``perm`` is the row permutation
    that assigns subsets (row perm[i] goes to subset i % nsubsets); by
    default it is drawn from ``generator`` (a CPU ``torch.Generator``).
    ``plan`` as for :func:`lm_solve`.  The subsets' traces concatenate on
    the iteration axis; the quality is of the full-mask residual at the
    final ``p``."""
    rows = vis.shape[-1]
    plan = _plan_for(plan, ant_p, ant_q, chunk_map, p0)
    if perm is None:
        perm = torch.randperm(rows, generator=generator)
    perm = torch.as_tensor(perm, device=vis.device).long()
    subset_of_row = torch.zeros((rows,), dtype=torch.int64, device=vis.device)
    subset_of_row[perm] = torch.arange(rows, device=vis.device) % nsubsets
    sub_cfg = dataclasses.replace(config, itmax=max(1, config.itmax // nsubsets))
    p = p0
    cost0 = None
    traces = []
    for s in range(nsubsets):
        m_s = mask * (subset_of_row == s)[None, :].to(mask.dtype)
        res = lm_solve(vis, coh, m_s, ant_p, ant_q, chunk_map, p, sub_cfg,
                       sqrt_weights, plan=plan, collect_trace=collect_trace)
        p = res.p
        if cost0 is None:
            cost0 = res.cost0 * nsubsets
        traces.append(res.trace)
    args = (coh, vis, mask, ant_p, ant_q, chunk_map, plan, sqrt_weights)
    final_cost = _cost_only(p, *args)
    trace = (IterTrace(*(torch.cat(f) for f in zip(*traces)))
             if collect_trace else None)
    quality = _quality(p, args) if collect_quality else None
    return LMResult(p=p, cost0=cost0, cost=final_cost, iterations=config.itmax,
                    trace=trace, quality=quality)
