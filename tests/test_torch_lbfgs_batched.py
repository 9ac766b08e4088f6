"""Port vs JAX package: the lock-step batched LBFGS (solvers/lbfgs.py,
``lbfgs_fit_batched``), on the CPU at f64.

Four lanes, each its own objective, chosen so that the per-lane
predicates all fire in one run: lane 0 starts at its minimum (done before
the first iteration), lane 1 accepts the first trial and stops on its
gradient, lane 2 needs Armijo backtracking in the same iteration, lane 3
(Rosenbrock) runs until ``itmax``.

Tolerance: 1e-10 relative on every lane's parameters and cost, and equal
iteration counts.  Both sides take the same two-loop directions and
Armijo steps in f64; their reductions round differently by an ulp, which
these smooth problems do not amplify.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torch_port_common import to_np

TOL = 1e-10
N = 6
X0 = np.array([[0.3, -0.2, 0.5, 0.1, -0.4, 0.2],
               [-1.0, 0.5, 0.2, 0.8, -0.3, 1.1],
               [0.9, -0.6, 0.4, -1.2, 0.7, 0.3],
               [-1.2, 1.0, -0.5, 0.8, 1.3, -0.9]])
C = np.linspace(-0.5, 0.5, N)


def _costs(X, lib, shift=0.0):
    """Per-lane objectives of a (4, n) batch in ``lib`` (jnp or torch)."""
    as_arr = jnp.asarray if lib is jnp else torch.from_numpy
    x0, c = as_arr(X0[0]), as_arr(C + shift)
    r = X[3] + shift
    rosen = lib.sum(100.0 * (r[1:] - r[:-1] ** 2) ** 2 + (1.0 - r[:-1]) ** 2)
    return lib.stack([
        lib.sum((X[0] - x0) ** 2),
        0.5 * lib.sum((X[1] - c) ** 2),
        5.0 * lib.sum((X[2] - c) ** 2),
        rosen,
    ])


def _close(got, want):
    got, want = to_np(got), np.asarray(want)
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("itmax", [1, 3, 8])
def test_lbfgs_fit_batched_matches_jax(itmax):
    from sagecal_tpu.solvers.lbfgs import lbfgs_fit_batched as jfit
    from sagecal_tpu_torch.solvers.lbfgs import lbfgs_fit_batched

    rj = jfit(lambda X: _costs(X, jnp), jnp.asarray(X0), itmax=itmax, M=5)
    rt = lbfgs_fit_batched(lambda X: _costs(X, torch),
                           torch.from_numpy(X0.copy()), itmax=itmax, M=5)
    _close(rt.p, rj.p)
    _close(rt.cost, rj.cost)
    assert rt.iterations.tolist() == np.asarray(rj.iterations).tolist()
    assert rt.memory.nfilled.tolist() == np.asarray(rj.memory.nfilled).tolist()
    _close(rt.memory.s, rj.memory.s)
    if itmax == 8:
        iters = rt.iterations.tolist()
        assert iters[0] == 0  # started converged
        assert iters[1] == 1 and float(rt.gradnorm[1]) <= 1e-9
        assert iters[3] == itmax  # ran out of iterations


def test_backtracking_lane_halves_while_first_trial_lane_accepts():
    """At the first iteration lane 2 fails its Armijo test and halves
    three times (alpha 1/8), while lane 1 keeps alpha 1."""
    from sagecal_tpu_torch.solvers.lbfgs import (
        ARMIJO_C, _armijo_rest_batched, _bdot,
    )

    x = torch.from_numpy(X0.copy())
    cost = lambda X: _costs(X, torch)
    xg = x.clone().requires_grad_(True)
    f = cost(xg)
    (g,) = torch.autograd.grad(f, xg, torch.ones_like(f))
    p, a0 = -g, torch.ones(4, dtype=x.dtype)
    f_t = cost(x + p)
    live = torch.tensor([False, True, True, False])
    bad = live & (f_t > f.detach() + a0 * ARMIJO_C * _bdot(p, g))
    assert bad.tolist() == [False, False, True, False]
    alpha, halvings = _armijo_rest_batched(
        cost, x, p, a0, f.detach(), f_t, ARMIJO_C * _bdot(p, g), bad)
    assert alpha.tolist() == [1.0, 1.0, 0.125, 1.0]
    assert halvings.tolist() == [0, 0, 3, 0]


def test_lbfgs_fit_batched_minibatch_carried_memory_matches_jax():
    """Two minibatch calls, the second on shifted objectives with the
    first call's per-lane memory: no pair stored on the first iteration
    after the switch, and the gradient-variance step size per lane."""
    from sagecal_tpu.solvers.lbfgs import lbfgs_fit_batched as jfit
    from sagecal_tpu_torch.solvers.lbfgs import lbfgs_fit_batched

    mj = mt = None
    pj, pt = jnp.asarray(X0), torch.from_numpy(X0.copy())
    for shift in (0.0, 0.2):
        rj = jfit(lambda X: _costs(X, jnp, shift), pj, itmax=4, M=3,
                  memory=mj, minibatch=True)
        rt = lbfgs_fit_batched(lambda X: _costs(X, torch, shift), pt,
                               itmax=4, M=3, memory=mt, minibatch=True)
        mj, mt, pj, pt = rj.memory, rt.memory, rj.p, rt.p
        _close(rt.p, rj.p)
        _close(mt.s, mj.s)
        _close(mt.y, mj.y)
        _close(mt.running_avg, mj.running_avg)
        _close(mt.running_avg_sq, mj.running_avg_sq)
        assert mt.niter.tolist() == np.asarray(mj.niter).tolist()
        assert mt.vacant.tolist() == np.asarray(mj.vacant).tolist()
        assert rt.iterations.tolist() == np.asarray(rj.iterations).tolist()


def test_two_loop_direction_batched_matches_jax():
    from sagecal_tpu.solvers.lbfgs import (
        _two_loop_direction_batched as jdir, batched_memory as jmem,
    )
    from sagecal_tpu_torch.solvers.lbfgs import (
        _two_loop_direction_batched, batched_memory,
    )

    rng = np.random.default_rng(0)
    B, n, M = 3, 9, 4
    s, y = rng.standard_normal((B, M, n)), rng.standard_normal((B, M, n))
    y = y + 3.0 * s  # positive curvature
    rho = 1.0 / np.einsum("bmn,bmn->bm", s, y)
    g = rng.standard_normal((B, n))
    vacant, nfilled = np.array([0, 2, 1]), np.array([0, 2, 4])
    jm = jmem(B, n, M, jnp.float64).replace(
        s=jnp.asarray(s), y=jnp.asarray(y), rho=jnp.asarray(rho),
        vacant=jnp.asarray(vacant, jnp.int32),
        nfilled=jnp.asarray(nfilled, jnp.int32))
    tm = batched_memory(B, n, M, torch.float64, device="cpu")
    tm.s, tm.y, tm.rho, tm.vacant, tm.nfilled = map(
        torch.from_numpy, (s, y, rho, vacant, nfilled))
    _close(_two_loop_direction_batched(torch.from_numpy(g), tm),
           jdir(jnp.asarray(g), jm))
