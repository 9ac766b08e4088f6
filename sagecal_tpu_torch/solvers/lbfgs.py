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
scalar per decision.  ``collect_trace`` fills an
``obs.records.IterTrace`` of ``itmax`` rows (cost, gradient norm,
accepted alpha, cost evaluations of the line search) from values the
loop holds already, so it reads nothing more back to the host.
:func:`lbfgs_fit_batched` runs B independent fits in lock-step (one
batched cost and gradient call per step, per-lane masks), the driver of
the batched fused objective.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.obs.records import IterTrace, init_trace, write_trace
from sagecal_tpu_torch.obs.trace import get_tracer, host_read
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
        """Empty store of M pairs of length n on ``device`` (None: CUDA;
        raises without it)."""
        device = resolve_device(device)
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
    trace: Optional[IterTrace] = None  # lbfgs_fit's, when collect_trace


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
              vg_fn: Optional[Callable] = None,
              collect_trace: bool = False) -> LBFGSResult:
    """Generic LBFGS fit.  ``grad_fn`` (optional) supplies the gradient,
    else autograd of ``cost_fn``; ``vg_fn(p) -> (cost, grad)`` overrides
    both.  ``minibatch=True`` with the previous call's ``memory``
    reproduces ``lbfgs_fit_minibatch``.  ``collect_trace``: the result's
    per-iteration trace (module doc)."""
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
            c = cost_fn(x)
        with host_read("lbfgs.f_halving"):
            return float(c)

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
        with host_read("lbfgs.alphabar"):
            alphabar = float(10.0 / (
                1.0 + memory.running_avg_sq.abs().sum()
                / (max(memory.niter, 1) * torch.clamp(gradnrm, min=1e-30))))

    eps = torch.finfo(p0.dtype).eps
    with host_read("lbfgs.gradnorm0"):
        gn0 = float(gradnrm)
    done = not (gn0 == gn0 and abs(gn0) != float("inf") and gn0 > CLM_STOP_THRESH)
    trace = (init_trace(itmax, (), p0.dtype, p0.device) if collect_trace
             else None)
    ck = 0
    tracer = get_tracer()
    while ck < itmax and not done:
        with tracer.span("lbfgs.iter"):
            pk = _two_loop_direction(g, memory)
            a0 = alphabar
            f_t, g_t = vg_fn(x + a0 * pk)
            with host_read("lbfgs.fold"):
                fold = float(f)
            with host_read("lbfgs.product"):
                product = ARMIJO_C * float(torch.dot(pk, g))
            with host_read("lbfgs.f_trial"):
                f_trial = float(f_t)
            if not _armijo_bad(f_trial, fold, a0, product):
                alphak, f1, g1 = a0, f_t, g_t
                ls_evals = 1
            else:
                alphak, fnew, ci = a0, f_trial, 0
                while ci < 15 and _armijo_bad(fnew, fold, alphak, product):
                    alphak = alphak * 0.5
                    fnew = cost_value(x + alphak * pk)
                    ci += 1
                f1, g1 = vg_fn(x + alphak * pk)
                # the first trial, each halving and the value-and-gradient
                ls_evals = 2 + ci
            step_ok = (alphak == alphak and abs(alphak) != float("inf")
                       and abs(alphak) >= CLM_EPSILON)
            x1 = x + alphak * pk
            gradnrm1 = torch.linalg.norm(g1)
            with host_read("lbfgs.gradnorm"):
                gn1 = float(gradnrm1)
            grad_ok = (gn1 == gn1 and abs(gn1) != float("inf")
                       and gn1 > CLM_STOP_THRESH)

            store = step_ok and not (batch_changed and ck == 0)
            sk = x1 - x
            yk = g1 - g
            if gn1 > 1e-3:
                yk = yk + 1e-6 * sk
            with host_read("lbfgs.curvature"):
                ys = float(torch.dot(yk, sk))
            with host_read("lbfgs.norm_y"):
                norm_y = float(torch.linalg.norm(yk))
            with host_read("lbfgs.norm_s"):
                norm_s = float(torch.linalg.norm(sk))
            curv_ok = ys > eps * norm_y * norm_s
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
            if trace is not None:
                write_trace(trace, ck, cost=f, grad_norm=gradnrm, step=alphak,
                            ls_evals=ls_evals)
            done = (not step_ok) or (not grad_ok)
            ck += 1
    return LBFGSResult(p=x, memory=memory, cost=f, gradnorm=gradnrm,
                       iterations=ck, trace=trace)


# ------------------------------------------------- batched (lock-step) LBFGS


def _bdot(a, b):
    """Per-lane dot: (B, n) x (B, n) -> (B,)."""
    return (a * b).sum(-1)


def _bnorm(a):
    return torch.sqrt(_bdot(a, a))


def batched_memory(B: int, n: int, M: int = 7, dtype=torch.float32,
                   device=None) -> LBFGSMemory:
    """Fresh :class:`LBFGSMemory` whose every field carries a leading
    batch axis ``B``: ``s``/``y`` (B, M, n), ``rho`` (B, M), and
    ``vacant``/``nfilled``/``niter`` as (B,) int64 tensors — the per-lane
    curvature store of :func:`lbfgs_fit_batched`.  ``device`` None means
    CUDA (raises without it)."""
    device = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    zi = torch.zeros((B,), dtype=torch.int64, device=device)
    return LBFGSMemory(s=z(B, M, n), y=z(B, M, n), rho=z(B, M),
                       vacant=zi, nfilled=zi.clone(), niter=zi.clone(),
                       running_avg=z(B, n), running_avg_sq=z(B, n))


def _two_loop_direction_batched(g, mem: LBFGSMemory):
    """Per-lane -H_k g: the two-loop recursion with a leading batch axis
    on ``g`` (B, n) and on every memory field, all lanes in lock-step
    over the M slots (newest first, then oldest first); each lane's
    circular slots are gathered by index and its unfilled slots masked."""
    B, M, _ = mem.s.shape
    k = torch.arange(M, device=g.device)
    newest_first = torch.remainder(mem.vacant[:, None] - 1 - k[None, :], M)
    valid = k[None, :] < mem.nfilled[:, None]  # (B, M)
    s = torch.gather(mem.s, 1, newest_first[:, :, None].expand_as(mem.s))
    y = torch.gather(mem.y, 1, newest_first[:, :, None].expand_as(mem.y))
    rho = torch.gather(mem.rho, 1, newest_first)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    q, alphas = g, []
    for i in range(M):
        a = torch.where(valid[:, i], rho[:, i] * _bdot(s[:, i], q), zero)
        q = q - a[:, None] * y[:, i]
        alphas.append(a)
    y0, s0 = y[:, 0], s[:, 0]
    yy = _bdot(y0, y0)
    gamma = torch.where((mem.nfilled > 0) & (yy > 0.0),
                        _bdot(s0, y0) / torch.clamp(yy, min=1e-30),
                        torch.ones_like(yy))
    r = gamma[:, None] * q
    for i in reversed(range(M)):  # oldest -> newest
        beta = torch.where(valid[:, i], rho[:, i] * _bdot(y[:, i], r), zero)
        r = r + s[:, i] * torch.where(valid[:, i], alphas[i] - beta,
                                      zero)[:, None]
    return -r


def _armijo_bad_batched(f_new, fold, alpha, product):
    return torch.isnan(f_new) | (f_new > fold + alpha * product)


def _armijo_rest_batched(cost_fn, x, p, a0, fold, f_a0, product, live):
    """Per-lane Armijo halving: each live lane halves while its own test
    fails (at most 15 times), frozen once it passes; the loop runs while
    any live lane still fails (one host read per round).  Returns
    (alpha (B,), halvings (B,))."""
    ci = torch.zeros(a0.shape, dtype=torch.int64, device=a0.device)
    alpha, fnew = a0, f_a0
    while True:
        bad = live & (ci < 15) & _armijo_bad_batched(fnew, fold, alpha,
                                                     product)
        if not bool(bad.any()):
            return alpha, ci
        alpha = torch.where(bad, alpha * 0.5, alpha)
        with torch.no_grad():
            f1 = cost_fn(x + alpha[:, None] * p)
        ci = torch.where(bad, ci + 1, ci)
        fnew = torch.where(bad, f1, fnew)


def _batched_value_and_grad(cost_fn):
    """(B, n) -> ((B,) costs, (B, n) gradient): the pullback of ones,
    per-lane exact because lane b's cost depends on row b only."""
    def vg(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            costs = cost_fn(xg)
            (g,) = torch.autograd.grad(costs, xg, torch.ones_like(costs))
        return costs.detach(), g
    return vg


def _where_lanes(mask, a, b):
    """Per-lane select of two (B, ...) tensors by a (B,) mask."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def _select_memory(mask, a: LBFGSMemory, b: LBFGSMemory) -> LBFGSMemory:
    return LBFGSMemory(**{f.name: _where_lanes(mask, getattr(a, f.name),
                                               getattr(b, f.name))
                          for f in dataclasses.fields(LBFGSMemory)})


@true_f32
def lbfgs_fit_batched(cost_fn: Callable, p0, itmax: int = 50, M: int = 7,
                      memory: Optional[LBFGSMemory] = None,
                      minibatch: bool = False,
                      vg_fn: Optional[Callable] = None) -> LBFGSResult:
    """``B`` independent LBFGS fits advancing in lock-step, so that every
    cost and gradient evaluation is one batched call (counterpart of the
    reference's ``lbfgs_fit_batched``, the driver of the batched fused
    objective).

    ``cost_fn``: (B, n) -> (B,) per-lane costs; lane b's cost must depend
    on row b only.  ``p0``: (B, n).  ``memory``: per-lane
    :class:`LBFGSMemory` (:func:`batched_memory`).  Per lane the
    predicates are those of :func:`lbfgs_fit`: backtracking only when a
    live lane fails its Armijo test (halvings applied only to failing
    lanes, at most 15); the store / curvature / step / gradient tests and
    ``y += 1e-6 s`` when ||g|| > 1e-3 per lane; a lane whose own test
    ends it keeps its whole carry while the others run.  The loop reads
    ``any(active)`` and ``any(need_bt)`` from the device once each per
    iteration.  ``iterations`` of the result is a (B,) tensor."""
    B, n = p0.shape
    if vg_fn is None:
        vg_fn = _batched_value_and_grad(cost_fn)
    if memory is None:
        memory = batched_memory(B, n, M, p0.dtype, p0.device)
    else:
        memory = dataclasses.replace(memory)
    x = p0.detach()
    f, g = vg_fn(x)
    gradnrm = _bnorm(g)

    if minibatch:
        batch_changed = memory.niter > 0
        g_min_rold = g - memory.running_avg
        ravg = memory.running_avg + g_min_rold / (memory.niter + 1).to(
            p0.dtype)[:, None]
        ravg_sq = memory.running_avg_sq + g_min_rold * (g - ravg)
        memory.running_avg = _where_lanes(batch_changed, ravg,
                                          memory.running_avg)
        memory.running_avg_sq = _where_lanes(batch_changed, ravg_sq,
                                             memory.running_avg_sq)
        alphabar = torch.where(
            batch_changed,
            10.0 / (1.0 + memory.running_avg_sq.abs().sum(-1)
                    / (torch.clamp(memory.niter, min=1).to(p0.dtype)
                       * torch.clamp(gradnrm, min=1e-30))),
            torch.ones_like(gradnrm))
    else:
        batch_changed = torch.zeros((B,), dtype=torch.bool, device=x.device)
        alphabar = torch.ones((B,), dtype=p0.dtype, device=x.device)

    eps = torch.finfo(p0.dtype).eps
    zero = torch.zeros((), dtype=p0.dtype, device=x.device)
    reg = torch.full((), 1e-6, dtype=p0.dtype, device=x.device)
    ck = torch.zeros((B,), dtype=torch.int64, device=x.device)
    done = ~(torch.isfinite(gradnrm) & (gradnrm > CLM_STOP_THRESH))
    mem = memory
    nslots = mem.s.shape[1]
    bidx = torch.arange(B, device=x.device)
    while True:
        active = (ck < itmax) & ~done
        if not bool(active.any()):
            break
        pk = _two_loop_direction_batched(g, mem)
        a0 = alphabar
        f_t, g_t = vg_fn(x + a0[:, None] * pk)
        product = ARMIJO_C * _bdot(pk, g)
        need_bt = active & _armijo_bad_batched(f_t, f, a0, product)
        if bool(need_bt.any()):
            alphak, _ = _armijo_rest_batched(cost_fn, x, pk, a0, f, f_t,
                                             product, need_bt)
            fb, gb = vg_fn(x + alphak[:, None] * pk)
            f1 = torch.where(need_bt, fb, f_t)
            g1 = _where_lanes(need_bt, gb, g_t)
        else:
            alphak, f1, g1 = a0, f_t, g_t
        step_ok = torch.isfinite(alphak) & (alphak.abs() >= CLM_EPSILON)
        x1 = x + alphak[:, None] * pk
        gradnrm1 = _bnorm(g1)
        grad_ok = torch.isfinite(gradnrm1) & (gradnrm1 > CLM_STOP_THRESH)

        sk = x1 - x
        yk = g1 - g
        yk = yk + torch.where(gradnrm1 > 1e-3, reg, zero)[:, None] * sk
        ys = _bdot(yk, sk)
        curv_ok = ys > eps * _bnorm(yk) * _bnorm(sk)
        store = step_ok & ~(batch_changed & (ck == 0)) & curv_ok
        rho_k = torch.where(curv_ok, 1.0 / torch.clamp(ys, min=1e-38), zero)
        slot = mem.vacant
        stored = dataclasses.replace(
            mem, s=mem.s.clone(), y=mem.y.clone(), rho=mem.rho.clone(),
            vacant=torch.remainder(slot + 1, nslots),
            nfilled=torch.clamp(mem.nfilled + 1, max=nslots))
        stored.s[bidx, slot] = sk
        stored.y[bidx, slot] = yk
        stored.rho[bidx, slot] = rho_k
        mem1 = _select_memory(store, stored, mem)
        mem1.niter = mem.niter + 1
        # frozen lanes keep their whole carry
        mem = _select_memory(active, mem1, mem)
        adv = active & step_ok
        x = _where_lanes(adv, x1, x)
        f = torch.where(adv, f1, f)
        g = _where_lanes(adv, g1, g)
        gradnrm = torch.where(adv, gradnrm1, gradnrm)
        done = torch.where(active, ~step_ok | ~grad_ok, done)
        ck = torch.where(active, ck + 1, ck)
    return LBFGSResult(p=x, memory=mem, cost=f, gradnorm=gradnrm,
                       iterations=ck)


# the reference's instrumented_jit entries: call counts (telemetry)
# and value contracts (SAGECAL_CHECKIFY), obs/perf.py
from sagecal_tpu_torch.obs.perf import instrumented  # noqa: E402

lbfgs_fit = instrumented(lbfgs_fit, name="lbfgs_fit")
lbfgs_fit_batched = instrumented(lbfgs_fit_batched, name="lbfgs_fit_batched")
