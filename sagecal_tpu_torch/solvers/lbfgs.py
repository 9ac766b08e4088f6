"""LBFGS with persistent memory (counterpart of ``sagecal_tpu/solvers/lbfgs.py``).

``cost_fn(p) -> scalar tensor`` is any torch-differentiable function;
gradients come from ``torch.autograd``.  Reproduced behaviours of the
reference's ``lbfgs_fit`` / ``lbfgs_fit_minibatch``:

- two-loop recursion over an M-slot circular store, newest first;
- Armijo backtracking (c = 1e-4, halving, at most 15 halvings), with the
  first trial evaluated as a fused value-and-gradient;
- minibatch mode: persistent (s, y) memory across calls, the first pair
  after a batch switch not stored, ``y += 1e-6 s`` when ||g|| > 1e-3,
  and the gradient-variance step size
  ``alphabar = 10 / (1 + sum|avg_sq| / ((niter-1) ||g||))``;
- a positive-curvature guard on stored pairs (machine epsilon of the
  running dtype).

The JAX ``while_loop``/``cond`` become Python control flow reading one
scalar per decision.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from sagecal_tpu_torch.utils.precision import true_f32

CLM_STOP_THRESH = 1e-9
CLM_EPSILON = 1e-12
ARMIJO_C = 1e-4


@dataclasses.dataclass
class LBFGSMemory:
    """Persistent LBFGS state (``persistent_data_t``)."""

    s: torch.Tensor  # (M, n) parameter differences
    y: torch.Tensor  # (M, n) gradient differences
    rho: torch.Tensor  # (M,) 1 / (y.s)
    vacant: int = 0  # next slot to fill
    nfilled: int = 0  # number of valid pairs
    niter: int = 0  # iterations across batches
    running_avg: Optional[torch.Tensor] = None  # (n,) mean batch gradient
    running_avg_sq: Optional[torch.Tensor] = None  # (n,) sum sq deviations

    @staticmethod
    def init(n: int, M: int = 7, dtype=torch.float32, device=None) -> "LBFGSMemory":
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
        return LBFGSMemory(s=z(M, n), y=z(M, n), rho=z(M),
                           running_avg=z(n), running_avg_sq=z(n))


def _two_loop_direction(g, mem: LBFGSMemory):
    """-H_k g by the two-loop recursion over the valid pairs."""
    M = mem.s.shape[0]
    slots = [(mem.vacant - 1 - k) % M for k in range(mem.nfilled)]  # newest first
    q = g
    alphas = []
    for i in slots:
        a = mem.rho[i] * torch.dot(mem.s[i], q)
        q = q - a * mem.y[i]
        alphas.append(a)
    gamma = torch.ones((), dtype=g.dtype, device=g.device)
    if mem.nfilled > 0:
        s0, y0 = mem.s[slots[0]], mem.y[slots[0]]
        yy = torch.dot(y0, y0)
        gamma = torch.where(yy > 0.0, torch.dot(s0, y0) / torch.clamp(yy, min=1e-30),
                            gamma)
    r = gamma * q
    for i, a in zip(reversed(slots), reversed(alphas)):  # oldest -> newest
        beta = mem.rho[i] * torch.dot(mem.y[i], r)
        r = r + mem.s[i] * (a - beta)
    return -r


def _armijo_bad(f_new: float, fold: float, alpha: float, product: float) -> bool:
    return f_new != f_new or f_new > fold + alpha * product


class LBFGSResult(NamedTuple):
    p: torch.Tensor
    memory: LBFGSMemory
    cost: torch.Tensor
    gradnorm: torch.Tensor
    iterations: int


def _value_and_grad(cost_fn):
    def vg(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = cost_fn(xg)
            (g,) = torch.autograd.grad(f, xg)
        return f.detach(), g
    return vg


@true_f32
def lbfgs_fit(cost_fn: Callable, grad_fn: Optional[Callable], p0, itmax: int = 50,
              M: int = 7, memory: Optional[LBFGSMemory] = None,
              minibatch: bool = False,
              vg_fn: Optional[Callable] = None) -> LBFGSResult:
    """Generic LBFGS fit.  ``grad_fn`` (optional) supplies the gradient,
    else autograd of ``cost_fn``; ``vg_fn(p) -> (cost, grad)`` overrides
    both.  ``minibatch=True`` with the previous call's ``memory``
    reproduces ``lbfgs_fit_minibatch``."""
    if vg_fn is None:
        if grad_fn is None:
            vg_fn = _value_and_grad(cost_fn)
        else:
            def vg_fn(x):
                return cost_fn(x), grad_fn(x)
    if memory is None:
        memory = LBFGSMemory.init(p0.shape[0], M, p0.dtype, p0.device)
    else:
        memory = dataclasses.replace(memory)

    def cost_value(x):
        with torch.no_grad():
            return float(cost_fn(x))

    x = p0.detach()
    f, g = vg_fn(x)
    gradnrm = torch.linalg.norm(g)

    batch_changed = minibatch and memory.niter > 0
    alphabar = 1.0
    if batch_changed:
        niter1 = memory.niter + 1
        g_min_rold = g - memory.running_avg
        ravg = memory.running_avg + g_min_rold / niter1
        memory.running_avg_sq = memory.running_avg_sq + g_min_rold * (g - ravg)
        memory.running_avg = ravg
        alphabar = float(10.0 / (
            1.0 + memory.running_avg_sq.abs().sum()
            / (max(memory.niter, 1) * torch.clamp(gradnrm, min=1e-30))))

    eps = torch.finfo(p0.dtype).eps
    gn0 = float(gradnrm)
    done = not (gn0 == gn0 and abs(gn0) != float("inf") and gn0 > CLM_STOP_THRESH)
    ck = 0
    while ck < itmax and not done:
        pk = _two_loop_direction(g, memory)
        a0 = alphabar
        f_t, g_t = vg_fn(x + a0 * pk)
        fold = float(f)
        product = ARMIJO_C * float(torch.dot(pk, g))
        if not _armijo_bad(float(f_t), fold, a0, product):
            alphak, f1, g1 = a0, f_t, g_t
        else:
            alphak, fnew, ci = a0, float(f_t), 0
            while ci < 15 and _armijo_bad(fnew, fold, alphak, product):
                alphak = alphak * 0.5
                fnew = cost_value(x + alphak * pk)
                ci += 1
            f1, g1 = vg_fn(x + alphak * pk)
        step_ok = (alphak == alphak and abs(alphak) != float("inf")
                   and abs(alphak) >= CLM_EPSILON)
        x1 = x + alphak * pk
        gradnrm1 = torch.linalg.norm(g1)
        gn1 = float(gradnrm1)
        grad_ok = gn1 == gn1 and abs(gn1) != float("inf") and gn1 > CLM_STOP_THRESH

        store = step_ok and not (batch_changed and ck == 0)
        sk = x1 - x
        yk = g1 - g
        if gn1 > 1e-3:
            yk = yk + 1e-6 * sk
        ys = float(torch.dot(yk, sk))
        curv_ok = ys > eps * float(torch.linalg.norm(yk)) * float(torch.linalg.norm(sk))
        if store and curv_ok:
            slot = memory.vacant
            memory.s = memory.s.clone()
            memory.y = memory.y.clone()
            memory.rho = memory.rho.clone()
            memory.s[slot] = sk
            memory.y[slot] = yk
            memory.rho[slot] = 1.0 / max(ys, 1e-38)
            memory.vacant = (slot + 1) % memory.s.shape[0]
            memory.nfilled = min(memory.nfilled + 1, memory.s.shape[0])
        memory.niter += 1
        if step_ok:
            x, f, g, gradnrm = x1, f1, g1, gradnrm1
        done = (not step_ok) or (not grad_ok)
        ck += 1
    return LBFGSResult(p=x, memory=memory, cost=f, gradnorm=gradnrm,
                       iterations=ck)
