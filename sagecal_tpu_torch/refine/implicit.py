"""Differentiating through the inner calibration solve (counterpart of
``sagecal_tpu/refine/implicit.py``).

Two gradient routes for ``d p*(theta) / d theta``:

- **implicit** (default): run the inner solver, then apply the implicit
  function theorem at its fixed point, a ``torch.autograd.Function``
  (the JAX package's ``custom_vjp``).  At ``grad_p f(p*, theta) = 0``
  the adjoint system is ``H v = pbar`` with ``H = d^2f/dp^2``, solved
  matrix-free with CG; the theta cotangent is ``-d/dtheta <grad_p
  f(p*, theta), v>``.  Memory does not grow with the inner iterations.
- **unrolled**: autograd straight through the fixed-iteration inner
  solve (Python loops of fixed length, the ``lax.scan``s' counterpart):
  exact for what the solver computed, at memory linear in the
  iterations.

The inner solver is a damped Gauss-Newton with a fixed budget: each
step solves ``(J^T J + (ridge + damping) I) dp = -grad_p f`` by CG.
``J v`` is the model's exact bilinear directional derivative
(``objective.py::model_jvp``) and ``J^T u`` a reverse-mode product.

Hessian-vector products: ``"hvp"`` (default) is the exact Hessian of
the inner cost, taken by double backward (the gradient with
``create_graph``, then a second reverse pass): the fixed-order gather
of ``core/segment.py`` is a custom autograd function with no
forward-mode formula, so ``torch.func.jvp`` of the gradient is not
used.  ``"jtj"`` is the Gauss-Newton ``J^T J v + ridge v``.  The theta
cotangent of the implicit route is a double backward too.

``MATVEC_COUNTS`` counts the Hessian (or Gauss-Newton) products: the
inner solve's CG steps (``"inner"``) and the adjoint's (``"adjoint"``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sagecal_tpu_torch.refine.objective import (
    RefineProblem, cluster_data_from_theta, gain_rows, inner_cost, model_jvp,
    residual_vec,
)

MATVEC_COUNTS = {"inner": 0, "adjoint": 0}


def cg_solve(matvec: Callable, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-iteration conjugate gradients on an SPD ``matvec``: plain
    tensor ops (reverse-differentiable for the unrolled route), with
    guards that make steps past convergence exact no-ops instead of
    dividing by zero; no host read."""
    x = torch.zeros_like(b)
    r, p = b, b
    rs = torch.dot(b, b)
    tiny = torch.finfo(b.dtype).tiny
    zero, one = b.new_zeros(()), b.new_ones(())
    for _ in range(iters):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        ok = denom > tiny
        alpha = torch.where(ok, rs / torch.where(ok, denom, one), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        rs1 = torch.dot(r, r)
        live = rs > tiny
        beta = torch.where(live, rs1 / torch.where(live, rs, one), zero)
        p = r + beta * p
        rs = rs1
    return x


def _inner_grad(problem: RefineProblem, p, theta, cdata=None,
                create_graph: bool = False):
    """grad_p f(p, theta) (a graph kept with ``create_graph``)."""
    with torch.enable_grad():
        pp = p if p.requires_grad else p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(inner_cost(problem, pp, theta, cdata), pp,
                                   create_graph=create_graph)
    return g


def _hessian_matvec(problem: RefineProblem, p, theta, v, matvec: str,
                    damping: float = 0.0, cdata=None):
    """d^2 f / dp^2 @ v, exact (``"hvp"``, double backward) or
    Gauss-Newton (``"jtj"``)."""
    if cdata is None:
        cdata = cluster_data_from_theta(problem, theta)
    if matvec == "jtj":
        with torch.enable_grad():
            pp = p.detach().requires_grad_(True)
            r = residual_vec(problem, pp, theta, cdata)
            (JtJv,) = torch.autograd.grad(
                r, pp, grad_outputs=model_jvp(problem, p, v, cdata))
        return JtJv + (problem.ridge + damping) * v
    if matvec != "hvp":
        raise ValueError(f"unknown adjoint matvec {matvec!r} "
                         "(expected 'hvp' or 'jtj')")
    with torch.enable_grad():
        pp = p.detach().requires_grad_(True)
        g = _inner_grad(problem, pp, theta, cdata, create_graph=True)
        (Hv,) = torch.autograd.grad(g, pp, grad_outputs=v)
    return Hv + damping * v


def gauss_newton_solve(problem: RefineProblem, theta: torch.Tensor,
                       p0: torch.Tensor, iters: int = 12, cg_iters: int = 32,
                       damping: float = 1e-6,
                       create_graph: Optional[bool] = None) -> torch.Tensor:
    """Damped Gauss-Newton on the inner cost, a fixed iteration budget.

    Each step solves ``(J^T J + (ridge + damping) I) dp = -grad_p f``
    with CG.  ``create_graph`` (default: whether ``theta`` requires a
    gradient) keeps the graph of every step, the unrolled route."""
    if create_graph is None:
        create_graph = theta.requires_grad
    with torch.enable_grad() if create_graph else torch.no_grad():
        cdata = cluster_data_from_theta(problem, theta)
    anchor = problem.anchor()
    p = p0
    for _ in range(iters):
        with torch.enable_grad():
            pp = (p if create_graph and p.requires_grad
                  else p.detach().requires_grad_(True))
            r = residual_vec(problem, pp, theta, cdata)
            (g,) = torch.autograd.grad(r, pp, grad_outputs=r,
                                       create_graph=create_graph,
                                       retain_graph=True)
            g = g + problem.ridge * (pp - anchor)
            # the gathered gains of this step's p, for every CG product
            p_gains = gain_rows(problem, pp if create_graph else pp.detach())

            def mv(v):
                MATVEC_COUNTS["inner"] += 1
                (JtJv,) = torch.autograd.grad(
                    r, pp, grad_outputs=model_jvp(problem, pp, v, cdata,
                                                  p_gains),
                    create_graph=create_graph, retain_graph=True)
                return JtJv + (problem.ridge + damping) * v

            dp = cg_solve(mv, -g, cg_iters)
            p = pp + dp
        if not create_graph:
            p = p.detach()
    return p


class _ImplicitSolve(torch.autograd.Function):
    """``p* = GN(theta, p0)`` whose backward is the IFT adjoint."""

    @staticmethod
    def forward(ctx, theta, p0, problem, iters, cg_iters, damping,
                adjoint_cg_iters, adjoint_matvec):
        pstar = gauss_newton_solve(problem, theta.detach(), p0.detach(),
                                   iters=iters, cg_iters=cg_iters,
                                   damping=damping, create_graph=False)
        ctx.save_for_backward(theta, pstar)
        ctx.problem = problem
        ctx.adjoint = (adjoint_cg_iters, adjoint_matvec)
        return pstar

    @staticmethod
    def backward(ctx, pbar):
        theta, pstar = ctx.saved_tensors
        problem = ctx.problem
        iters, matvec = ctx.adjoint
        theta = theta.detach()
        with torch.no_grad():
            cdata = cluster_data_from_theta(problem, theta)

        def hv(u):
            MATVEC_COUNTS["adjoint"] += 1
            return _hessian_matvec(problem, pstar, theta, u, matvec,
                                   cdata=cdata)

        v = cg_solve(hv, pbar, iters)
        # -(d^2 f / dtheta dp)^T v, as grad_theta of <grad_p f(p*, theta),
        # v> with p* held fixed
        with torch.enable_grad():
            th = theta.requires_grad_(True)
            g = _inner_grad(problem, pstar, th, create_graph=True)
            (gtheta,) = torch.autograd.grad(torch.dot(g, v), th)
        return (-gtheta, torch.zeros_like(pstar), None, None, None, None,
                None, None)


def make_inner_solver(problem: RefineProblem, iters: int = 12,
                      cg_iters: int = 32, damping: float = 1e-6,
                      gradient: str = "implicit",
                      adjoint_cg_iters: int = 64,
                      adjoint_matvec: str = "hvp") -> Callable:
    """``solve(theta, p0) -> p*`` with the chosen gradient route
    (module doc)."""
    if gradient == "unrolled":
        def solve(theta, p0):
            return gauss_newton_solve(problem, theta, p0, iters=iters,
                                      cg_iters=cg_iters, damping=damping)
        return solve
    if gradient != "implicit":
        raise ValueError(f"unknown gradient route {gradient!r} "
                         "(expected 'implicit' or 'unrolled')")
    if adjoint_matvec not in ("hvp", "jtj"):
        raise ValueError(f"unknown adjoint matvec {adjoint_matvec!r} "
                         "(expected 'hvp' or 'jtj')")

    def solve(theta, p0):
        return _ImplicitSolve.apply(theta, p0, problem, iters, cg_iters,
                                    damping, adjoint_cg_iters,
                                    adjoint_matvec)
    return solve
