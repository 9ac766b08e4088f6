"""Port vs JAX package: LBFGS with persistent memory (solvers/lbfgs.py), on
the CPU, iterate by iterate on the Rosenbrock function at f64.

Tolerance: 1e-10 relative on every iterate.  Both sides take the same
two-loop directions and Armijo steps in f64; gradients come from
``jax.grad`` and ``torch.autograd`` respectively and round differently
by an ulp, which the iteration does not amplify on this smooth problem.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torch_port_common import to_np

TOL = 1e-10
X0 = np.array([-1.2, 1.0, -0.5, 0.8, 1.3, -0.9])


def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen_t(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _close(got, want):
    got, want = to_np(got), np.asarray(want)
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("M", [3, 7])
def test_lbfgs_iterates_match_jax(M):
    from sagecal_tpu.solvers.lbfgs import lbfgs_fit as jfit
    from sagecal_tpu_torch.solvers.lbfgs import lbfgs_fit

    for k in range(1, 13):
        rj = jfit(_rosen_j, None, jnp.asarray(X0), itmax=k, M=M)
        rt = lbfgs_fit(_rosen_t, None, torch.from_numpy(X0.copy()), itmax=k,
                       M=M)
        _close(rt.p, rj.p)
        _close(rt.cost, rj.cost)
        assert rt.iterations == int(rj.iterations)
        assert rt.memory.nfilled == int(rj.memory.nfilled)
        assert rt.memory.vacant == int(rj.memory.vacant)


def test_lbfgs_minibatch_persistent_memory_matches_jax():
    """Two minibatch calls on different objectives, memory carried: the
    batch-switch rules (no pair stored first, gradient-variance step)
    apply on the second call."""
    from sagecal_tpu.solvers.lbfgs import lbfgs_fit as jfit
    from sagecal_tpu_torch.solvers.lbfgs import lbfgs_fit

    shift = np.linspace(0.0, 0.3, X0.size)
    obj_j = [_rosen_j, lambda x: _rosen_j(x + jnp.asarray(shift))]
    obj_t = [_rosen_t, lambda x: _rosen_t(x + torch.from_numpy(shift))]
    mj = mt = None
    pj, pt = jnp.asarray(X0), torch.from_numpy(X0.copy())
    for fj, ft in zip(obj_j, obj_t):
        rj = jfit(fj, None, pj, itmax=5, M=4, memory=mj, minibatch=True)
        rt = lbfgs_fit(ft, None, pt, itmax=5, M=4, memory=mt, minibatch=True)
        mj, mt, pj, pt = rj.memory, rt.memory, rj.p, rt.p
        _close(rt.p, rj.p)
        _close(mt.s, mj.s)
        _close(mt.y, mj.y)
        _close(mt.running_avg, mj.running_avg)
        assert mt.niter == int(mj.niter)


def test_two_loop_direction_matches_jax():
    from sagecal_tpu.solvers.lbfgs import LBFGSMemory as JMem
    from sagecal_tpu.solvers.lbfgs import _two_loop_direction as jdir
    from sagecal_tpu_torch.solvers.lbfgs import LBFGSMemory, _two_loop_direction

    rng = np.random.default_rng(0)
    n, M = 9, 4
    s, y = rng.standard_normal((M, n)), rng.standard_normal((M, n))
    y = y + 3.0 * s  # positive curvature
    rho = 1.0 / np.einsum("mn,mn->m", s, y)
    g = rng.standard_normal(n)
    for nfilled, vacant in ((0, 0), (2, 2), (4, 1)):
        jm = JMem.init(n, M, jnp.float64).replace(
            s=jnp.asarray(s), y=jnp.asarray(y), rho=jnp.asarray(rho),
            vacant=jnp.asarray(vacant, jnp.int32),
            nfilled=jnp.asarray(nfilled, jnp.int32))
        tm = LBFGSMemory.init(n, M, torch.float64, device="cpu")
        tm.s, tm.y, tm.rho = map(torch.from_numpy, (s, y, rho))
        tm.vacant, tm.nfilled = vacant, nfilled
        _close(_two_loop_direction(torch.from_numpy(g), tm),
               jdir(jnp.asarray(g), jm))
