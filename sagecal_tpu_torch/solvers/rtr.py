"""Riemannian trust region and Nesterov steepest descent on the Jones
quotient manifold (counterpart of ``sagecal_tpu/solvers/rtr.py``).

The structure is the reference's (rtr_solve.c, rtr_solve_robust.c):
- solution space X in C^{2N x 2} (station-stacked Jones), quotient by
  the right unitary U(2) ambiguity; metric g(eta, gamma) = 2 Re
  tr(eta^H gamma); horizontal projection z - X Om with Om M + M Om =
  X^H z - z^H X, M = X^H X, a 4x4 Sylvester system; retraction x + eta;
- per-station gradient weights: inverse baseline counts, scaled to max 1;
- RSD (Armijo) warmup, then trust region with truncated CG (theta 1,
  kappa 0.1, eta1 1e-4, eta2 0.99, alpha1 0.25, alpha2 3.5,
  Delta_bar = min(f0, 0.01), Delta0 = Delta_bar / 8);
- NSD: Nesterov acceleration with a Barzilai-Borwein step.

Where the JAX package takes ``jax.grad`` and ``jax.jvp`` of the cost,
this port writes the data cost's Wirtinger gradient and its
Hessian-vector product in closed form (the reference's fns_fgrad and
fns_fhess).  With E = V - Jp C Jq^H, weights a (mask times the robust
sqrt-weight, squared), A = C Jq^H and B = Jp C, the gradient in the
metric's convention is -a E A^H at station p and -a E^H B at station q;
along eta, dE = -(eta_p A + B eta_q^H) and the Hessian applies
-(a dE) A^H - a E (eta_q C^H) at p and -(a dE)^H B - a E^H (eta_p C)
at q.  The per-row 2x2 products are written as broadcast multiplies
and sums (:func:`_mm`): on an H100, cuBLAS takes ~0.9 ms for the
226,920 2x2 complex products of one north-star product, the
elementwise form ~0.03 (``tools/rtr_profile.py``).  Per-station sums are
the fixed-order segment sums of the LM's ``NormalEqPlan`` (``station``
and ``cost``; planned once per tile by ``sagefit``, else once per
solve), so every solve is bit-identical on repeat on CUDA.

Hybrid chunks solve in lock-step on a leading chunk axis: each row
only meets its own chunk's gains, a chunk that has finished is masked
as the reference's vmap masks it.  The ``while_loop``s become Python
loops; every decision they read back is counted in
``host_read.count`` (one host sync each on CUDA).

``collect_trace`` records the trust-region or NSD iterations in an
``obs.records.IterTrace`` of ``(itmax, nchunk)`` rows, written per lane
with ``torch.where`` on the lanes' live mask (rows a lane never ran stay
NaN, as under the reference's vmapped ``while_loop``); RTR's
``ls_evals`` is the lane's truncated-CG step count.  ``collect_quality``
adds the ``ops.quality.SolveQuality`` of the final solution (data term
only, robust weights with dof 2).  Neither reads anything more back to
the host, and both off leave the solve as it was.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from sagecal_tpu_torch.core.types import (
    corrupt_flat, jones_to_params, params_to_jones,
)
from sagecal_tpu_torch.obs.trace import host_read as trace_read
from sagecal_tpu_torch.obs.records import (
    init_trace, stack_traces, with_nu, write_trace,
)
from sagecal_tpu_torch.ops.quality import residual_quality
from sagecal_tpu_torch.solvers.lm import (
    NormalEqPlan, _plan_for, _residual_flat,
)
from sagecal_tpu_torch.utils.precision import true_f32


@dataclasses.dataclass(frozen=True)
class RTRConfig:
    itmax_rsd: int = 2
    itmax_rtr: int = 10
    max_inner: int = 10
    theta: float = 1.0
    kappa: float = 0.1
    eta1: float = 1e-4
    eta2: float = 0.99
    alpha1: float = 0.25
    alpha2: float = 3.5
    epsilon: float = 1e-12


class RTRResult(NamedTuple):
    p: torch.Tensor  # (nchunk, 8N)
    cost0: torch.Tensor  # (nchunk,)
    cost: torch.Tensor  # (nchunk,)
    trace: Optional[tuple] = None
    quality: Optional[tuple] = None


def host_read(flag: torch.Tensor) -> bool:
    """One loop decision read back to the host, counted in
    ``host_read.count`` and, while the tracer records, as its
    ``rtr.decision`` site (``obs/trace.py::host_read``)."""
    host_read.count += 1
    with trace_read("rtr.decision"):
        return bool(flag)


host_read.count = 0


def _lane(v):
    """(nchunk,) per-lane scalars against (nchunk, N, 2, 2)."""
    return v[:, None, None, None]


def _g(eta, gamma):
    """Metric 2 Re<eta, gamma> per lane: (nchunk, N, 2, 2) -> (nchunk,)."""
    return 2.0 * (eta.conj() * gamma).real.sum(dim=(-3, -2, -1))


def _sqnorm(x):
    return (x.abs() ** 2).sum(dim=(-3, -2, -1))


def _hermitian(m):
    return m.conj().transpose(-1, -2)


def _mm(a, b):
    """Batched 2x2 products a @ b (broadcasting), as a multiply and a
    sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mm_f(a, b):
    """Per-row sum over channels of a @ b: (rows, F, 2, 2) -> (rows, 2, 2)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=(1, -2))


def _project(x, z):
    """Horizontal projection z - X Om per lane; x, z (..., N, 2, 2), the
    2N x 2 matrix view X[2s+r, c] = x[s, r, c]."""
    lead, N = x.shape[:-3], x.shape[-3]
    X = x.reshape(lead + (2 * N, 2))
    Z = z.reshape(lead + (2 * N, 2))
    XH = _hermitian(X)
    M = XH @ X
    R = XH @ Z
    R = R - _hermitian(R)  # X^H Z - Z^H X
    eye = torch.eye(2, dtype=x.dtype, device=x.device)
    # kron(I, M) + kron(M^T, I) acts on the column-major vec of Om
    A = (torch.einsum("ij,...kl->...ikjl", eye, M)
         + torch.einsum("...ij,kl->...ikjl", M.transpose(-1, -2), eye)
         ).reshape(lead + (4, 4))
    A = A + 1e-12 * torch.eye(4, dtype=x.dtype, device=x.device)
    b = R.transpose(-1, -2).reshape(lead + (4, 1))
    u = torch.linalg.solve_ex(A, b)[0]
    Om = u.reshape(lead + (2, 2)).transpose(-1, -2)
    return (Z - X @ Om).reshape(z.shape)


def _per_row(t):
    """(F, 4, rows) -> (rows, F, 2, 2)."""
    F, _, rows = t.shape
    return t.permute(2, 0, 1).reshape(rows, F, 2, 2)


class _Fns:
    """Cost, gradient and Hessian-vector product of every chunk lane of
    one cluster's solve (module doc).  ``x``: (nchunk, N, 2, 2)."""

    def __init__(self, vis, coh, mask, plan: NormalEqPlan, sqrt_w=None,
                 admm=None):
        self.plan = plan
        self.C = _per_row(coh)
        self.CH = _hermitian(self.C).contiguous()
        self.V = _per_row(vis)
        a = mask[..., None, :]
        if sqrt_w is not None:
            a = a * sqrt_w
        a = a * a  # (F, 1 or 4, rows)
        k = a.shape[-2]
        self.a = (_per_row(a) if k == 4 else
                  a.permute(2, 0, 1)[..., None])  # (rows, F, 2|1, 2|1)
        self.admm = admm
        good = (mask.sum(dim=0) > 0).to(mask.dtype)
        cnt = plan.station.sum(torch.cat([good, good]))
        iw = torch.where(cnt > 0, 1.0 / torch.clamp(cnt, min=1.0),
                         torch.zeros_like(cnt)).reshape(plan.nchunk, plan.N)
        mx = iw.max(dim=1, keepdim=True).values
        self.iw = torch.where(mx > 0, iw / mx, iw)[..., None, None]
        self._x = None

    def _gather(self, x):
        tab = x.reshape(-1, 2, 2)
        return (tab.index_select(0, self.plan.idx_p)[:, None],
                tab.index_select(0, self.plan.idx_q)[:, None])

    def _station_sum(self, gp, gq):
        """Per-row (rows, 2, 2) terms at station p and q -> (nchunk, N,
        2, 2) sums."""
        s = self.plan.station.sum(torch.cat([gp, gq]))
        return s.reshape(self.plan.nchunk, self.plan.N, 2, 2)

    def _admm_cost(self, x):
        Yc, BZc, rho = self.admm
        d = x - BZc
        return ((Yc.conj() * d).real.sum(dim=(-3, -2, -1))
                + 0.5 * rho * (d.real ** 2 + d.imag ** 2).sum(dim=(-3, -2, -1)))

    def _terms(self, x):
        """The per-row products at ``x``, kept for the Hessian."""
        if self._x is not x:
            Jp, Jq = self._gather(x)
            A = _mm(self.C, _hermitian(Jq))
            B = _mm(Jp, self.C)
            aE = self.a * (self.V - _mm(Jp, A))
            self._x = x
            self._t = (A, _hermitian(A).contiguous(), B, aE,
                       _hermitian(aE).contiguous())
        return self._t

    def cost(self, x):
        """Per-lane cost (nchunk,), the ADMM terms included."""
        Jp, Jq = self._gather(x)
        E = self.V - _mm(Jp, _mm(self.C, _hermitian(Jq)))
        row = (self.a * (E.real ** 2 + E.imag ** 2)).sum(dim=(1, 2, 3))
        c = self.plan.cost.sum(row)
        return c if self.admm is None else c + self._admm_cost(x)

    def egrad(self, x):
        """The data cost's Euclidean gradient, 0.5 (d/dRe + i d/dIm)."""
        _, AH, B, aE, aEH = self._terms(x)
        return self._station_sum(-_mm_f(aE, AH), -_mm_f(aEH, B))

    def grad(self, x):
        """Weighted, projected Riemannian gradient (fns_fgrad)."""
        g = self.egrad(x) * self.iw
        if self.admm is not None:
            Yc, BZc, rho = self.admm
            g = g + 0.5 * (Yc + _lane(rho) * (x - BZc))
        return _project(x, g)

    def hess(self, x, eta):
        """Projected directional derivative of the weighted gradient
        (fns_fhess)."""
        A, AH, B, aE, aEH = self._terms(x)
        ep, eq = self._gather(eta)
        adE = -self.a * (_mm(ep, A) + _mm(B, _hermitian(eq)))
        hp = -_mm_f(adE, AH) - _mm_f(aE, _mm(eq, self.CH))
        hq = -_mm_f(_hermitian(adE), B) - _mm_f(aEH, _mm(ep, self.C))
        h = self._station_sum(hp, hq) * self.iw
        if self.admm is not None:
            h = h + 0.5 * _lane(self.admm[2]) * eta
        return _project(x, h)


def _nz(v):
    return torch.where(v == 0.0, torch.full_like(v, 1e-30), v)


def _keep(mask, new, old):
    """Per-lane select of (nchunk, ...) tensors by a (nchunk,) mask."""
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def _tcg(fns: _Fns, x, grad, Delta, cfg: RTRConfig, live, count=False):
    """Truncated CG (tcg_solve) of every lane in ``live``; the others
    start stopped and return eta = 0.  Returns (eta, Heta, steps): with
    ``count``, each lane's number of CG steps (else None)."""
    r = grad
    z_r = _g(r, r)
    norm_r0 = torch.sqrt(z_r)
    delta = -r
    eta = Heta = torch.zeros_like(x)
    e_Pe = e_Pd = torch.zeros_like(z_r)
    d_Pd = z_r
    stop = ~live
    steps = torch.zeros_like(z_r) if count else None
    Deltasq = Delta * Delta
    j = 0
    while j < cfg.max_inner and host_read((~stop).any()):
        Hxd = fns.hess(x, delta)
        d_Hd = _g(delta, Hxd)
        alpha = z_r / _nz(d_Hd)
        e_Pe_new = e_Pe + 2.0 * alpha * e_Pd + alpha * alpha * d_Pd
        hit = (d_Hd <= 0.0) | (e_Pe_new >= Deltasq)
        disc = e_Pd ** 2 + d_Pd * (Deltasq - e_Pe)
        tau = (-e_Pd + torch.sqrt(torch.clamp(disc, min=0.0))) / _nz(d_Pd)
        step = torch.where(hit, tau, alpha)
        r_new = r + _lane(alpha) * Hxd
        norm_r = torch.sqrt(_g(r_new, r_new))
        kconv = norm_r <= norm_r0 * torch.clamp(norm_r0 ** cfg.theta,
                                                max=cfg.kappa)
        stop_new = hit | kconv
        z_r_new = _g(r_new, r_new)
        beta = z_r_new / _nz(z_r)
        act = ~stop
        if count:
            steps = steps + act.to(steps.dtype)
        eta = _keep(act, eta + _lane(step) * delta, eta)
        Heta = _keep(act, Heta + _lane(step) * Hxd, Heta)
        r = _keep(act & ~stop_new, r_new, r)
        e_Pe = torch.where(act & ~hit, e_Pe_new, e_Pe)
        delta = _keep(act, -r_new + _lane(beta) * delta, delta)
        e_Pd = torch.where(act, beta * (e_Pd + step * d_Pd), e_Pd)
        d_Pd = torch.where(act, z_r_new + beta * beta * d_Pd, d_Pd)
        z_r = torch.where(act, z_r_new, z_r)
        stop = stop | stop_new
        j += 1
    return eta, Heta, steps


def _lane_trace(itmax: int, like):
    """A NaN trace of (itmax, nchunk) rows, ``nu`` included (the layout
    of the reference's per-lane traces after its vmap)."""
    tr = init_trace(itmax, like.shape, like.dtype, like.device)
    return tr._replace(nu=torch.full_like(tr.cost, float("nan")))


def _rtr(fns: _Fns, x0, cfg: RTRConfig, itmax_dyn=None, trace=None):
    """RSD warmup then trust region, every chunk lane in lock-step.
    ``itmax_dyn``: the base iteration budget; the RSD and TR bounds
    become min(static, dyn + 5) and min(static, dyn + 10).  ``trace``:
    an (itmax_rtr, nchunk) trace to fill, one row per TR iteration of
    each live lane."""
    rsd_bound = (cfg.itmax_rsd if itmax_dyn is None
                 else min(cfg.itmax_rsd, int(itmax_dyn) + 5))
    rtr_bound = (cfg.itmax_rtr if itmax_dyn is None
                 else min(cfg.itmax_rtr, int(itmax_dyn) + 10))
    fx0 = fns.cost(x0)

    x = x0
    for _ in range(min(cfg.itmax_rsd, rsd_bound)):
        g = fns.grad(x)
        fx = fns.cost(x)
        gg = _g(g, g)
        beta = torch.ones_like(gg)
        k = torch.zeros_like(gg)
        while True:  # Armijo backtracking
            c = fns.cost(x - _lane(beta) * g)
            back = (k < 12) & (c > fx - 1e-4 * beta * gg)
            if not host_read(back.any()):
                break
            beta = torch.where(back, beta * 0.5, beta)
            k = k + back.to(k.dtype)
        x = _keep(c < fx, x - _lane(beta) * g, x)

    fx = fns.cost(x)
    Delta_bar = torch.clamp(fx, max=0.01)
    Delta = Delta_bar * 0.125
    rho_reg0 = fx * 1e-6
    stop = torch.zeros_like(fx, dtype=torch.bool)
    k = 0
    while k < rtr_bound and host_read((~stop).any()):
        active = ~stop
        g = fns.grad(x)
        eta, Heta, cg_steps = _tcg(fns, x, g, Delta, cfg, active,
                                   count=trace is not None)
        x_prop = x + eta
        fx_prop = fns.cost(x_prop)
        rhonum = fx - fx_prop
        rhoden = -_g(g, eta) - 0.5 * _g(Heta, eta)
        rho_reg = torch.clamp(fx, min=1.0) * rho_reg0
        rho = (rhonum + rho_reg) / _nz(rhoden + rho_reg)
        model_dec = rhoden > 0.0
        accept = active & (rho > cfg.eta1) & model_dec & (fx_prop < fx)
        Delta_new = torch.where(
            rho < cfg.eta1, Delta * cfg.alpha1,
            torch.where((rho > cfg.eta2) & model_dec,
                        torch.minimum(Delta * cfg.alpha2, Delta_bar), Delta))
        x = _keep(accept, x_prop, x)
        fx = torch.where(accept, fx_prop, fx)
        Delta = torch.where(active, Delta_new, Delta)
        gnorm = torch.sqrt(_g(g, g))
        if trace is not None:
            write_trace(trace, k, live=active, cost=fx, grad_norm=gnorm,
                        step=torch.sqrt(torch.clamp(_g(eta, eta), min=0.0)),
                        ls_evals=cg_steps)
        stop = stop | (gnorm < cfg.epsilon)
        k += 1
    better = fx <= fx0
    return _keep(better, x, x0), fx0, torch.where(better, fx, fx0)


def _nsd(fns: _Fns, x0, itmax: int, itmax_dyn=None, trace=None):
    """Nesterov accelerated manifold descent (nsd_solve_nocuda_robust),
    every chunk lane in lock-step; the limit is min(itmax, dyn + 15).
    ``trace``: an (itmax, nchunk) trace to fill, per live lane the cost
    after the step, the gradient norm and the step size used."""
    bound = itmax if itmax_dyn is None else min(itmax, int(itmax_dyn) + 15)
    fx0 = fns.cost(x0)
    g = fns.grad(x0)
    hnrm = torch.sqrt(_sqnorm(fns.hess(x0, x0)))
    t = torch.clamp(1.0 / torch.where(hnrm == 0.0, torch.full_like(hnrm, 1e30),
                                      hnrm), min=1e-6)
    x, z = x0, x0
    theta = torch.ones_like(t)
    done = torch.zeros_like(t, dtype=torch.bool)
    for i in range(min(itmax, bound)):
        if not host_read((~done).any()):
            break
        x1 = z - _lane(t) * g
        gn = torch.sqrt(_sqnorm(g))
        xn = torch.sqrt(_sqnorm(x1))
        done1 = done | (gn * t / torch.clamp(xn, min=1.0) < 1e-6)
        theta1 = 2.0 / (1.0 + torch.sqrt(1.0 + 4.0 / (theta * theta)))
        z1 = _lane(2.0 - theta1) * x1 - _lane(1.0 - theta1) * x
        g1 = fns.grad(z1)
        ydiff = z - z1
        gdiff = g - g1
        ydn = torch.sqrt(_sqnorm(ydiff))
        dot = (ydiff.real * gdiff.real + ydiff.imag * gdiff.imag).sum(
            dim=(-3, -2, -1))
        bad = torch.isnan(dot) | torch.isinf(dot)
        t_hat = 0.5 * ydn * ydn / torch.clamp(dot.abs(), min=1e-30)
        t1 = torch.minimum(1.01 * t, torch.maximum(0.5 * t, t_hat))
        live = ~done if trace is not None else None
        done = done1 | bad
        x, z, g = _keep(done, x, x1), _keep(done, z, z1), _keep(done, g, g1)
        if trace is not None:
            write_trace(trace, i, live=live, cost=fns.cost(x), grad_norm=gn,
                        step=t)
        t = torch.where(done, t, t1)
        theta = torch.where(done, theta, theta1)
    fx = fns.cost(x)
    better = fx <= fx0
    return _keep(better, x, x0), fx0, torch.where(better, fx, fx0)


def _admm_terms(p0, admm_y, admm_bz, admm_rho):
    if admm_y is None:
        return None
    rho = torch.as_tensor(admm_rho, dtype=p0.dtype, device=p0.device)
    return (params_to_jones(admm_y), params_to_jones(admm_bz),
            rho.expand(p0.shape[0]))


def _quality_of(p, vis, coh, mask, ant_p, ant_q, chunk_map, plan,
                sqrt_w=None, nu=None):
    """Quality at the final solution ``p`` through the LM residual (the
    same model per chunk as the lane costs, so ``chi2_chunk`` is the
    solver's final data cost; ADMM terms excluded), robust weights of
    dof 2."""
    e = _residual_flat(p, coh, vis, mask, ant_p, ant_q, chunk_map, sqrt_w)
    return residual_quality(e, p, ant_p, ant_q, chunk_map, p.shape[0], nu=nu,
                            sqrt_w=sqrt_w, mask8=mask[..., None, :],
                            weight_dof=2.0, plan=plan)


def _solve(run, itmax, vis, coh, mask, ant_p, ant_q, chunk_map, p0, sqrt_w,
           plan, admm, collect_trace, collect_quality):
    plan = _plan_for(plan, ant_p, ant_q, chunk_map, p0)
    fns = _Fns(vis, coh, mask, plan, sqrt_w, admm)
    trace = _lane_trace(itmax, p0[:, 0]) if collect_trace else None
    xf, c0, c1 = run(fns, params_to_jones(p0), trace)
    p = jones_to_params(xf)
    quality = (_quality_of(p, vis, coh, mask, ant_p, ant_q, chunk_map, plan,
                           sqrt_w) if collect_quality else None)
    return RTRResult(p=p, cost0=c0, cost=c1, trace=trace, quality=quality)


@true_f32
def rtr_solve(vis, coh, mask, ant_p, ant_q, chunk_map, p0,
              config: RTRConfig = RTRConfig(),
              sqrt_weights: Optional[torch.Tensor] = None, itmax_dynamic=None,
              admm_y=None, admm_bz=None, admm_rho=None,
              collect_trace: bool = False, collect_quality: bool = False,
              plan: Optional[NormalEqPlan] = None) -> RTRResult:
    """RTR solve of every hybrid chunk (``rtr_solve_nocuda``).

    vis, coh (F, 4, rows) complex; mask (F, rows); chunk_map (rows,);
    p0 (nchunk, 8N).  ``sqrt_weights``: robust sqrt-weights broadcasting
    against (F, 4, rows); ``itmax_dynamic``: ``sagefit``'s per-cluster
    budget (an int); ``admm_y``/``admm_bz`` (nchunk, 8N) and scalar
    ``admm_rho``: the consensus-augmented cost; ``plan``: the cluster's
    :class:`NormalEqPlan` (built here when None); ``collect_trace`` /
    ``collect_quality`` as in the module doc."""
    return _solve(lambda f, x0, tr: _rtr(f, x0, config, itmax_dynamic, tr),
                  config.itmax_rtr, vis, coh, mask, ant_p, ant_q, chunk_map,
                  p0, sqrt_weights, plan,
                  _admm_terms(p0, admm_y, admm_bz, admm_rho), collect_trace,
                  collect_quality)


@true_f32
def nsd_solve(vis, coh, mask, ant_p, ant_q, chunk_map, p0, itmax: int = 10,
              sqrt_weights: Optional[torch.Tensor] = None, itmax_dynamic=None,
              admm_y=None, admm_bz=None, admm_rho=None,
              collect_trace: bool = False, collect_quality: bool = False,
              plan: Optional[NormalEqPlan] = None) -> RTRResult:
    """Nesterov steepest descent of every hybrid chunk
    (``nsd_solve_nocuda_robust``); arguments as :func:`rtr_solve`."""
    return _solve(lambda f, x0, tr: _nsd(f, x0, itmax, itmax_dynamic, tr),
                  itmax, vis, coh, mask, ant_p, ant_q, chunk_map, p0,
                  sqrt_weights, plan,
                  _admm_terms(p0, admm_y, admm_bz, admm_rho), collect_trace,
                  collect_quality)


def _robust_weights_and_nu(vis, coh, mask, ant_p, ant_q, chunk_map, p, nu,
                           nulow, nuhigh):
    """Per-baseline Student's-t weights w = (nu+2)/(nu + max_elem |e|^2)
    (the max over the four complex residual elements) and the AECM
    (p = 2) nu update.  Returns (sqrt_w (F, 1, rows), nu)."""
    from sagecal_tpu_torch.solvers.robust import update_nu_aecm

    model = corrupt_flat(params_to_jones(p), coh, ant_p, ant_q, chunk_map)
    res = (vis - model) * mask[..., None, :]
    e2 = (res.real ** 2 + res.imag ** 2).max(dim=-2).values  # (F, rows)
    w = (nu + 2.0) / (nu + e2)
    w = torch.where(mask > 0, w, torch.ones_like(w))
    msum = torch.clamp(mask.sum(), min=1.0)
    logsumw = ((torch.log(w) - w) * mask).sum() / msum
    nu1 = update_nu_aecm(logsumw, nu, p=2, nulow=nulow, nuhigh=nuhigh)
    return torch.sqrt(w)[..., None, :], nu1


def _robust(solve, vis, coh, mask, ant_p, ant_q, chunk_map, p0, nu0, nulow,
            nuhigh, em_iters, plan, collect_trace, collect_quality):
    """The Student's-t EM around ``solve(p, sqrt_w, plan, collect_trace)``.
    Traces stack the EM stages in front, (em_iters, itmax, nchunk), each
    stage's ``nu`` the nu its weights were built with; quality is of the
    weights re-estimated at the final solution."""
    plan = _plan_for(plan, ant_p, ant_q, chunk_map, p0)
    p = p0
    nu = torch.as_tensor(nu0, dtype=p0.dtype).to(p0.device)
    c0s, c1s, traces = [], [], []
    for _ in range(em_iters):
        sqrt_w, nu1 = _robust_weights_and_nu(vis, coh, mask, ant_p, ant_q,
                                             chunk_map, p, nu, nulow, nuhigh)
        out = solve(p, sqrt_w, plan, collect_trace)
        c0s.append(out.cost0)
        c1s.append(out.cost)
        if collect_trace:
            traces.append(with_nu(out.trace, nu1))
        p, nu = out.p, nu1
    # nu re-estimated from the final solution, as the reference does
    sqrt_w, nu = _robust_weights_and_nu(vis, coh, mask, ant_p, ant_q,
                                        chunk_map, p, nu, nulow, nuhigh)
    quality = (_quality_of(p, vis, coh, mask, ant_p, ant_q, chunk_map, plan,
                           sqrt_w, nu) if collect_quality else None)
    trace = stack_traces(traces) if collect_trace else None
    return RTRResult(p=p, cost0=c0s[0], cost=c1s[-1], trace=trace,
                     quality=quality), nu


@true_f32
def rtr_solve_robust(vis, coh, mask, ant_p, ant_q, chunk_map, p0,
                     config: RTRConfig = RTRConfig(), nu0=2.0,
                     nulow: float = 2.0, nuhigh: float = 30.0,
                     em_iters: int = 2, itmax_dynamic=None, admm_y=None,
                     admm_bz=None, admm_rho=None,
                     collect_trace: bool = False,
                     collect_quality: bool = False,
                     plan: Optional[NormalEqPlan] = None):
    """Student's-t EM around RTR (``rtr_solve_nocuda_robust``): E-step
    weights and nu (:func:`_robust_weights_and_nu`), M-step a weighted
    :func:`rtr_solve`, ``em_iters`` times, then nu once more from the
    final solution.  ``nu0`` may be a tensor (``sagefit`` carries nu
    across EM passes).  Returns (RTRResult, nu).  ``collect_trace`` /
    ``collect_quality``: see ``_robust``."""
    return _robust(
        lambda p, sw, pl, ct: rtr_solve(
            vis, coh, mask, ant_p, ant_q, chunk_map, p, config,
            sqrt_weights=sw, itmax_dynamic=itmax_dynamic, admm_y=admm_y,
            admm_bz=admm_bz, admm_rho=admm_rho, collect_trace=ct, plan=pl),
        vis, coh, mask, ant_p, ant_q, chunk_map, p0, nu0, nulow, nuhigh,
        em_iters, plan, collect_trace, collect_quality)


@true_f32
def nsd_solve_robust(vis, coh, mask, ant_p, ant_q, chunk_map, p0,
                     itmax: int = 10, nu0=2.0, nulow: float = 2.0,
                     nuhigh: float = 30.0, em_iters: int = 2,
                     itmax_dynamic=None, admm_y=None, admm_bz=None,
                     admm_rho=None, collect_trace: bool = False,
                     collect_quality: bool = False,
                     plan: Optional[NormalEqPlan] = None):
    """Robust Nesterov descent (``nsd_solve_nocuda_robust``): the
    Student's-t EM of :func:`rtr_solve_robust` around
    :func:`nsd_solve`.  Returns (RTRResult, nu)."""
    return _robust(
        lambda p, sw, pl, ct: nsd_solve(
            vis, coh, mask, ant_p, ant_q, chunk_map, p, itmax,
            sqrt_weights=sw, itmax_dynamic=itmax_dynamic, admm_y=admm_y,
            admm_bz=admm_bz, admm_rho=admm_rho, collect_trace=ct, plan=pl),
        vis, coh, mask, ant_p, ant_q, chunk_map, p0, nu0, nulow, nuhigh,
        em_iters, plan, collect_trace, collect_quality)


# the reference's instrumented_jit entries: call counts (telemetry)
# and value contracts (SAGECAL_CHECKIFY), obs/perf.py
from sagecal_tpu_torch.obs.perf import instrumented  # noqa: E402

rtr_solve = instrumented(rtr_solve, name="rtr_solve")
nsd_solve = instrumented(nsd_solve, name="nsd_solve")
rtr_solve_robust = instrumented(rtr_solve_robust, name="rtr_solve_robust")
nsd_solve_robust = instrumented(nsd_solve_robust, name="nsd_solve_robust")
