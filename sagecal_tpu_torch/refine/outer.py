"""The outer refinement loop: LBFGS over sky parameters around the
inner calibration solve (counterpart of ``sagecal_tpu/refine/outer.py``).

Each outer iteration is one ``lbfgs_fit`` step (``itmax=1``) with the
:class:`~sagecal_tpu_torch.solvers.lbfgs.LBFGSMemory` carried across
calls (the minibatch solver's persistent-curvature idiom), so the host
loop appends one trace line per iteration (the JAX package's fields and
the iteration's wall ``seconds``) and can stop anywhere.  The
bilevel value and gradient (inner Gauss-Newton solve, then the IFT
adjoint or the unrolled backward) take the warm-start gains as an
argument.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

import torch

from sagecal_tpu_torch.refine.implicit import make_inner_solver
from sagecal_tpu_torch.refine.objective import RefineProblem, outer_cost
from sagecal_tpu_torch.solvers.lbfgs import LBFGSMemory, lbfgs_fit


class RefineResult(NamedTuple):
    theta: torch.Tensor  # refined sky parameters (flat, SkySpec layout)
    p: torch.Tensor  # inner gains at the final theta, flat (M*8N,)
    cost: float  # outer misfit at the final theta
    gradnorm: float
    iterations: int  # outer iterations actually run
    trace: List[dict]  # one entry per outer iteration
    memory: LBFGSMemory  # outer curvature (resume carry)


def make_outer_value_and_grad(problem: RefineProblem, **inner_kwargs):
    """(solve, vg, cost): ``solve(theta, p0) -> p*``, ``vg(theta, p0) ->
    (h, dh/dtheta)`` with the gradient through the inner fixed point,
    and the cost alone for line searches."""
    solve = make_inner_solver(problem, **inner_kwargs)

    def outer_fn(theta, p0):
        return outer_cost(problem, solve(theta, p0), theta)

    def vg(theta, p0):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            h = outer_fn(th, p0)
            (g,) = torch.autograd.grad(h, th)
        return h.detach(), g

    def cost_only(theta, p0):
        with torch.no_grad():
            return outer_fn(theta.detach(), p0)

    def solve_only(theta, p0):
        with torch.no_grad():
            return solve(theta.detach(), p0)

    return solve_only, vg, cost_only


def run_refine(problem: RefineProblem, theta0: Optional[torch.Tensor] = None,
               outer_iters: int = 10, lbfgs_m: int = 7,
               gradient: str = "implicit", inner_iters: int = 12,
               cg_iters: int = 32, damping: float = 1e-6,
               adjoint_cg_iters: int = 64, adjoint_matvec: str = "hvp",
               warm_start: bool = True, tol: float = 0.0,
               p_start: Optional[torch.Tensor] = None,
               memory: Optional[LBFGSMemory] = None, start_iter: int = 0,
               on_iteration: Optional[Callable] = None,
               fns=None) -> RefineResult:
    """Refine the free sky parameters by outer LBFGS, on the problem's
    device.

    ``on_iteration(it, theta, memory, p_warm, entry)`` fires after every
    outer iteration (the app's trace hook).  ``p_start``/``memory``/
    ``start_iter`` continue an earlier run.  ``warm_start`` feeds each
    iteration's inner gains to the next as its start; the gradient is
    exact either way (the adjoint needs only the fixed point reached).
    ``tol > 0`` stops once the outer gradient norm falls below it.
    ``fns``: an existing ``(solve, vg, cost)`` of
    :func:`make_outer_value_and_grad` (the inner keyword arguments are
    then ignored)."""
    if theta0 is None:
        theta0 = problem.spec.theta0(problem.clusters, problem.tables)
    theta = torch.as_tensor(theta0).to(problem.data.device).detach()
    p_warm = (torch.as_tensor(p_start).to(problem.data.device)
              if p_start is not None else problem.identity_gains())
    mem = (memory if memory is not None
           else LBFGSMemory.init(theta.shape[0], lbfgs_m, theta.dtype,
                                 theta.device))
    solve, vg, cost_only = fns if fns is not None else (
        make_outer_value_and_grad(
            problem, iters=inner_iters, cg_iters=cg_iters, damping=damping,
            gradient=gradient, adjoint_cg_iters=adjoint_cg_iters,
            adjoint_matvec=adjoint_matvec))

    trace: List[dict] = []
    cost = gradnorm = float("nan")
    it = start_iter
    for it in range(start_iter, outer_iters):
        t0 = time.perf_counter()
        p0 = p_warm
        res = lbfgs_fit(lambda th, _p0=p0: cost_only(th, _p0), None, theta,
                        itmax=1, M=lbfgs_m, memory=mem,
                        vg_fn=lambda th, _p0=p0: vg(th, _p0))
        theta, mem = res.p, res.memory
        cost, gradnorm = float(res.cost), float(res.gradnorm)
        pstar = solve(theta, p0)
        if warm_start:
            p_warm = pstar
        entry = {"iter": it, "cost": cost, "gradnorm": gradnorm,
                 "theta": theta.detach().cpu().tolist(),
                 "seconds": time.perf_counter() - t0}
        trace.append(entry)
        if on_iteration is not None:
            on_iteration(it, theta, mem, p_warm, entry)
        if tol > 0.0 and gradnorm < tol:
            break
    pstar = solve(theta, p_warm)
    return RefineResult(theta=theta, p=pstar, cost=cost, gradnorm=gradnorm,
                        iterations=it + 1 - start_iter, trace=trace,
                        memory=mem)
