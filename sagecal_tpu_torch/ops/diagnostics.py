"""Influence-function diagnostics, the ``-i`` flag (counterpart of
``sagecal_tpu/ops/diagnostics.py``).

Instead of residuals, write the influence function of the calibration:
how strongly a perturbation of the visibilities on one baseline leaks
into the residual of every baseline through the solved gains
(``calculate_diagnostics_gpu``).  Per cluster k at the solved gains, on
the first channel (F = 1, as the reference):

1. ``H = dg/dvec(J)``, g the Wirtinger gradient of the misfit over the
   station-stacked gains (4N complex, column-major vec): four kron
   blocks per row summed into (station, station) blocks
   (:func:`_cluster_hessian`); small diagonal entries set to 1, plus the
   consensus curvature when given (:func:`_condition_diag`);
2. ``AdV[:, b]``: the gradient perturbation of nudging every element of
   baseline b's visibilities by (1 + j), at station p's row block;
3. ``U = lstsq(H, AdV)``, the minimum-norm least-squares solution, as
   the JAX package's ``jnp.linalg.lstsq``: an SVD with its cutoff
   ``eps(float32) * 4N`` of the largest singular value
   (:func:`_lstsq_min_norm`), which stays defined where H loses rank (a
   flagged station); ``torch.linalg.lstsq`` on CUDA has only ``gels``,
   which assumes full rank;
4. ``dR[b', b] += vec(-U_p(b) (sum_t C J_q^H))`` on rows b' sharing
   station p;
5. per correlation (vec order 00, 10, 01, 11) the eigenvalues of the
   (Nbase, Nbase) matrix ``dR[:, :, c]`` on the host with numpy (as the
   JAX package; the order is numpy's), replicated over timeslots.

Everything is complex64, as in the JAX package even at float64.  The
station-block sums go through fixed-order :class:`SegmentPlan` s (no
float atomics), and the 2x2 products are broadcast multiplies and sums.
:func:`influence_function` leaves the split of its seconds in
``last_seconds``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from sagecal_tpu_torch.core.segment import SegmentPlan
from sagecal_tpu_torch.core.types import VisData, params_to_jones
from sagecal_tpu_torch.solvers.sage import ClusterData, predict_full_model

# wall seconds of the last influence_function call, each part ending in
# a device synchronize: "residual" (the model at the solution),
# "hessian_lstsq" (H, AdV and the SVD solve, summed over clusters), "dR"
# (its accumulation), "eig" (dR to the host and the four eigensolves),
# "total"
last_seconds: dict = {}


def _herm(m):
    return m.conj().transpose(-1, -2)


def _mm22(A, B):
    """Batched 2x2 product A @ B (broadcast multiply and sum)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _kron4(A, B):
    """Batched ``np.kron`` of (rows, 2, 2) blocks -> (rows, 4, 4)."""
    return (A[:, :, None, :, None] * B[:, None, :, None, :]).reshape(
        A.shape[0], 4, 4)


def _vec_idx_assemble(blocks_colrow, N: int):
    """(N, N, 4, 4) station blocks [col station, row station] -> (4N, 4N)
    in the column-major vec(X) layout, index(c, s, r) = c*2N + 2s + r."""
    b = blocks_colrow.reshape(N, N, 2, 2, 2, 2)  # (m, n, c1, r1, c2, r2)
    return b.permute(2, 1, 3, 4, 0, 5).reshape(4 * N, 4 * N)


class HessianPlan:
    """The fixed-order sums of :func:`_cluster_hessian` for one row
    layout: the diagonal station blocks (each row adds to (p, p) and
    (q, q)) and the off-diagonal ones ((q, p) and (p, q)), each its own
    :class:`SegmentPlan` so that the crowded diagonal does not pad the
    rest."""

    def __init__(self, ant_p, ant_q, N: int):
        self.N = N
        self.diag = SegmentPlan(torch.cat([ant_p, ant_q]), N)
        self.off = SegmentPlan(torch.cat([ant_q * N + ant_p,
                                          ant_p * N + ant_q]), N * N)
        self.diag_idx = torch.arange(N, device=ant_p.device) * (N + 1)


def _cluster_hessian(C, R, Jp, Jq, ant_p, ant_q, N: int,
                     plan: Optional[HessianPlan] = None):
    """H = dg/dvec(J): (4N, 4N) complex (``kernel_hessian``).

    C/R: (rows, 2, 2) coherency and residual; Jp/Jq: (rows, 2, 2) the
    rows' gains; ``plan``: a :class:`HessianPlan` of (ant_p, ant_q), built
    once per tile (None: built here)."""
    if plan is None:
        plan = HessianPlan(ant_p, ant_q, N)
    CJqH = _mm22(C, _herm(Jq))
    JpC = _mm22(Jp, C)
    Mpp = _mm22(CJqH, _herm(CJqH))
    Mqq = _mm22(_herm(JpC), JpC)
    I2 = torch.eye(2, dtype=C.dtype, device=C.device).expand(C.shape[0], 2, 2)
    Bpp = _kron4(Mpp.transpose(-1, -2), I2)
    Bqq = _kron4(Mqq.transpose(-1, -2), I2)
    Bqp = _kron4(-C.conj(), R)  # (col q, row p)
    Bpq = _kron4(-C.transpose(-1, -2), _herm(R))  # (col p, row q)
    blocks = torch.zeros((N * N, 4, 4), dtype=C.dtype, device=C.device)
    blocks = blocks + plan.off.sum(torch.cat([Bqp, Bpq]))
    blocks[plan.diag_idx] += plan.diag.sum(torch.cat([Bpp, Bqq]))
    return _vec_idx_assemble(blocks.reshape(N, N, 4, 4), N)


def _condition_diag(H, extra=0.0):
    """Diagonal entries below 1e-5 in magnitude (flagged stations) set to
    1; ``extra`` (the consensus curvature) added to the diagonal."""
    d = torch.diagonal(H)
    d1 = torch.where(d.abs() < 1e-5, torch.ones_like(d), d) + extra
    return H - torch.diag(d) + torch.diag(d1)


def consensus_hessian_addition(rho_k, Bpoly, Binv_k):
    """0.5 rho Fd1, the frequency-consensus constraint's curvature added
    to the diagonal.  Bpoly: (Npoly,) this band's basis row; Binv_k:
    (Npoly, Npoly) the cluster's pseudo-inverse of sum_f rho_f B_f
    B_f^T."""
    bfBibf = Bpoly @ (Binv_k @ Bpoly)
    Fd = 1.0 - bfBibf
    Fdd = Fd * Fd
    Fd1 = Fdd * (1.0 + Fdd / torch.clamp(1.0 - Fdd, min=1e-12))
    return 0.5 * rho_k * Fd1


def _lstsq_min_norm(A, b):
    """Minimum-norm least-squares solution of A x = b by the SVD, with the
    JAX package's cutoff: singular values at or below eps(A's real
    dtype) * max(m, n) * s_max are dropped."""
    m, n = A.shape
    u, s, vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(s.dtype).eps * max(m, n)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s)).to(A.dtype)
    return _herm(vh) @ (s_inv[:, None] * (_herm(u) @ b))


def influence_function(data: VisData, cdata: ClusterData, p, rho=None,
                       Bpoly=None, Binv=None) -> np.ndarray:
    """Influence eigenvalues in place of residuals: host (F, 4, rows)
    complex, every channel the same (the reference computes F = 1 and
    replicates).

    p: (M, nchunk_max, 8N) solved parameters; rho/Bpoly/Binv: optional
    consensus information (per-cluster rho (M,), basis row (Npoly,),
    inverses (M, Npoly, Npoly)) for the constraint curvature.  Rows are
    timeslot-major over one baseline layout (``rows = tilesz * nbase``),
    as ``io.dataset`` and ``io.simulate`` lay them out."""
    dev = data.vis.device

    def clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t_start = clock()
    c64 = torch.complex64
    M = cdata.coh.shape[0]
    N, Bt, T, F = data.nstations, data.nbase, data.tilesz, data.nchan
    rows = Bt * T

    def mat22(flat_c):  # (4, rows) -> (rows, 2, 2)
        return flat_c.transpose(0, 1).reshape(rows, 2, 2)

    res_flat = (data.vis - predict_full_model(p, cdata, data)) \
        * data.mask[..., None, :]
    Rm = mat22(res_flat[0]).to(c64)
    maskr = data.mask[0]
    plan = HessianPlan(data.ant_p, data.ant_q, N)
    p_bl = data.ant_p[:Bt]  # the station of each baseline, every timeslot
    bl_idx = torch.arange(Bt, device=dev)
    ones2 = torch.full((2, 2), 1.0 + 1.0j, dtype=c64, device=dev)
    dR = torch.zeros((Bt, Bt, 2, 2), dtype=c64, device=dev)
    t_res = clock()
    secs = {"hessian_lstsq": 0.0, "dR": 0.0}
    for k in range(M):
        t0 = clock()
        Cm = (mat22(cdata.coh[k, 0]) * maskr[:, None, None]).to(c64)
        jones = params_to_jones(p[k]).to(c64)  # (nchunk, N, 2, 2)
        Jp = jones[cdata.chunk_map[k], data.ant_p]
        Jq = jones[cdata.chunk_map[k], data.ant_q]
        H = _cluster_hessian(Cm, Rm, Jp, Jq, data.ant_p, data.ant_q, N, plan)
        extra = 0.0
        if rho is not None and Bpoly is not None and Binv is not None:
            extra = consensus_hessian_addition(rho[k], Bpoly, Binv[k])
        H = _condition_diag(H, extra)

        # AdV (4N, Bt): station p's row block of each baseline's column
        JqCH = _mm22(Jq, _herm(Cm)).reshape(T, Bt, 2, 2).sum(0)
        blockp = _mm22(ones2, JqCH)  # (Bt, 2, 2)
        AdV = torch.zeros((2, N, 2, Bt), dtype=c64, device=dev)
        AdV[:, p_bl, :, bl_idx] = blockp.transpose(-1, -2)  # (Bt, c, r)
        U = _lstsq_min_norm(H, AdV.reshape(4 * N, Bt))
        Up = U.reshape(2, N, 2, Bt)  # (c, station, r, col)
        t1 = clock()
        secs["hessian_lstsq"] += t1 - t0

        # dR: only the p (first station) block, as the reference's kernel
        Asum = (-_mm22(Cm, _herm(Jq))).reshape(T, Bt, 2, 2).sum(0)
        Upb = Up[:, p_bl].permute(1, 2, 0, 3)  # (Bt, r, k, col)
        # contrib[b, l, r, c] = sum_k Upb[b, r, k, l] Asum[b, k, c]
        dR = dR + (Upb.permute(0, 3, 1, 2)[..., None]
                   * Asum[:, None, None, :, :]).sum(-2)
        secs["dR"] += clock() - t1
    t_eig = clock()
    dR_np = dR.cpu().numpy()
    out = np.zeros((rows, 8), np.float64)
    for ci, (r, c) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        lam = np.linalg.eigvals(dR_np[:, :, r, c])  # (Bt,)
        out[:, 2 * ci] = np.tile(lam.real, T)
        out[:, 2 * ci + 1] = np.tile(lam.imag, T)
    # vec order [00, 10, 01, 11] -> component order [00, 01, 10, 11]
    cplx = (out[:, 0::2] + 1j * out[:, 1::2])[:, [0, 2, 1, 3]]
    flat = np.broadcast_to(np.moveaxis(cplx, 0, -1)[None], (F, 4, rows))
    t_end = time.perf_counter()
    last_seconds.clear()
    last_seconds.update(residual=t_res - t_start, eig=t_end - t_eig,
                        total=t_end - t_start, **secs)
    return np.ascontiguousarray(flat)
