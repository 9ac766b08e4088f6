"""Bound-constrained limited-memory BFGS (counterpart of
``sagecal_tpu/solvers/lbfgsb.py``).

Minimize f(x) subject to ``lb <= x <= ub`` elementwise:
- the quasi-Newton model is the (s, y) store and two-loop recursion of
  ``solvers/lbfgs.py``;
- the generalized Cauchy point under the diagonal model theta I is
  P(x - g / theta) (on every segment of the projected path the model's
  derivative is proportional to theta t - 1);
- the free variables take the two-loop direction, the bound ones step
  to their Cauchy values; steepest descent when that is not a descent
  direction; projected Armijo backtracking.

``cost_fn`` is whatever it is given; gradients come from autograd (in
``sagefit`` it is the fused objective, whose backward is kernel #4).
The ``scan`` over iterations becomes a Python loop that stops once the
fit is done (nothing changes after that) and reads its decisions from
the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from sagecal_tpu_torch.solvers.lbfgs import (
    LBFGSMemory, _two_loop_direction, _value_and_grad,
)
from sagecal_tpu_torch.utils.precision import true_f32


class LBFGSBResult(NamedTuple):
    p: torch.Tensor
    cost: torch.Tensor
    iterations: int


def _project(x, lb, ub):
    return torch.minimum(torch.maximum(x, lb), ub)


def _cauchy_point(x, g, lb, ub, theta):
    """Generalized Cauchy point P(x - g/theta) of the diagonal model and
    the variables not at a bound there: (xc, free_mask)."""
    xc = _project(x - g / theta, lb, ub)
    eps = 10.0 * torch.finfo(x.dtype).eps
    at_bound = (xc <= lb + eps) | (xc >= ub - eps)
    return xc, ~at_bound


@true_f32
def lbfgsb_fit(cost_fn: Callable, grad_fn: Optional[Callable], p0, lb, ub,
               itmax: int = 50, M: int = 7, factr_tol: float = 1e-12,
               pg_tol: float = 1e-10, max_ls: int = 20) -> LBFGSBResult:
    """Minimize ``cost_fn`` subject to ``lb <= p <= ub`` (scalars or
    tensors broadcasting against ``p0``).  ``grad_fn=None`` takes the
    gradient by autograd."""
    if grad_fn is None:
        vg = _value_and_grad(cost_fn)
    else:
        def vg(x):
            return cost_fn(x), grad_fn(x)

    def cost(x):
        with torch.no_grad():
            return cost_fn(x)

    dtype, dev = p0.dtype, p0.device
    lb = torch.as_tensor(lb, dtype=dtype).to(dev).expand(p0.shape)
    ub = torch.as_tensor(ub, dtype=dtype).to(dev).expand(p0.shape)
    x = _project(p0.detach(), lb, ub)
    mem = LBFGSMemory.init(x.shape[0], M, dtype, dev)
    f, g = vg(x)
    theta = torch.ones((), dtype=dtype, device=dev)
    it = 0
    for _ in range(itmax):
        xc, free = _cauchy_point(x, g, lb, ub, theta)
        d = torch.where(free, _two_loop_direction(g, mem), xc - x)
        if not bool(torch.dot(g, d) < 0.0):
            d = -g
        gx = lambda xt: 1e-4 * torch.dot(g, xt - x)
        alpha, ls_ok, k = 1.0, False, 0
        while k < max_ls and not ls_ok:  # projected Armijo backtracking
            xt = _project(x + alpha * d, lb, ub)
            ls_ok = bool(cost(xt) <= f + gx(xt))
            alpha = alpha if ls_ok else alpha * 0.5
            k += 1
        x1 = _project(x + alpha * d, lb, ub)
        f1, g1 = vg(x1)
        s, y = x1 - x, g1 - g
        sy, yy = torch.dot(s, y), torch.dot(y, y)
        good_pair = bool(sy > 1e-10 * torch.sqrt(torch.dot(s, s))
                         * torch.sqrt(yy))
        if good_pair and ls_ok:
            slot = mem.vacant
            mem.s, mem.y, mem.rho = mem.s.clone(), mem.y.clone(), mem.rho.clone()
            mem.s[slot], mem.y[slot], mem.rho[slot] = s, y, 1.0 / sy
            mem.vacant = (slot + 1) % M
            mem.nfilled = min(mem.nfilled + 1, M)
        if good_pair:
            theta = torch.clamp(yy / torch.where(sy == 0, torch.ones_like(sy),
                                                 sy), 1e-8, 1e12)
        improved = ls_ok and bool(f1 < f)
        f_old = f
        if improved:
            x, f, g = x1, f1, g1
        pg = x - _project(x - g, lb, ub)
        small = bool(pg.abs().max() < pg_tol)
        flat = bool((f_old - f1).abs() <= factr_tol * torch.clamp(
            torch.maximum(f_old.abs(), f1.abs()), min=1.0))
        it += 1
        if small or (improved and flat) or not ls_ok:
            break
    return LBFGSBResult(p=x, cost=f, iterations=it)
