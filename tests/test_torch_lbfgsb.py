"""Port vs JAX package: bound-constrained LBFGS-B (``solvers/lbfgsb.py``)
and ``sagefit`` with ``param_bound > 0``.

Mirrors ``tests/test_lbfgsb.py``: the bounded Rosenbrock of the
reference's demo.  With a loose box the global minimum is reached; with
``ub = 0.8`` the even coordinates sit on the bound, and the port's
iterate, cost and iteration count match the JAX package's at f64 (1e-8
relative: both take the same steps, differing in f64 rounding only);
a start outside the box is projected.  ``sagefit`` with ``param_bound``
on the ``__graft_entry__`` tile (f32), fused and torch-op joint cost:
``res_1`` and ``p`` within the 5e-3 bar of ``tests/test_torch_sage.py``,
every ``|p| <= param_bound`` exactly, and the bound active.
"""

import numpy as np
import pytest
import torch

from torch_port_common import jax_entry_tile, rel, to_np

BOUND = 1.1


def rosenbrock(x):
    return (100.0 * (x[1::2] - x[0::2] ** 2) ** 2 + (1.0 - x[0::2]) ** 2).sum()


def _fit(x0, lb, ub, **kw):
    from sagecal_tpu_torch.solvers.lbfgsb import lbfgsb_fit

    return lbfgsb_fit(rosenbrock, None, torch.as_tensor(x0), lb=lb, ub=ub,
                      **kw)


def test_unconstrained_box_reaches_global_minimum():
    res = _fit(np.full(8, -1.2), -10.0, 10.0, itmax=300, M=7)
    np.testing.assert_allclose(to_np(res.p), np.ones(8), atol=0.02)
    assert float(res.cost) < 1e-4


@pytest.mark.parametrize("itmax", [5, 400], ids=["early", "converged"])
def test_active_bound_matches_jax(itmax):
    import jax.numpy as jnp

    from sagecal_tpu.solvers import lbfgsb_fit as jfit

    x0, lb, ub = np.full(6, 0.2), -2.0, 0.8
    want = jfit(lambda x: jnp.sum(100.0 * (x[1::2] - x[0::2] ** 2) ** 2
                                  + (1.0 - x[0::2]) ** 2),
                None, jnp.asarray(x0), lb=lb, ub=ub, itmax=itmax, M=7)
    got = _fit(x0, lb, ub, itmax=itmax, M=7)
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(to_np(got.p), np.asarray(want.p), rtol=1e-8,
                               atol=1e-12)
    assert rel(got.cost, want.cost) <= 1e-8
    assert float(got.p.max()) <= ub


def test_start_outside_box_is_projected():
    res = _fit(np.full(4, 5.0), -1.5, 1.5, itmax=200, M=5)
    p = to_np(res.p)
    assert np.all(p <= 1.5) and np.all(p >= -1.5)
    np.testing.assert_allclose(p, np.ones(4), atol=0.05)


@pytest.fixture(scope="module")
def tile():
    return jax_entry_tile(np.float32)


@pytest.mark.parametrize("fused", [False, True], ids=["torch-ops", "fused"])
def test_sagefit_param_bound_matches_jax(tile, fused):
    from sagecal_tpu.solvers.sage import SageConfig as JCfg, sagefit as jfit
    from sagecal_tpu_torch.interop import result_to_numpy, tile_from_numpy
    from sagecal_tpu_torch.solvers.sage import SageConfig, sagefit

    data, cdata, p0, arrays = tile
    kw = dict(max_emiter=1, max_iter=5, max_lbfgs=8, lbfgs_m=5,
              solver_mode=1, param_bound=BOUND, use_fused_predict=fused)
    want = jfit(data, cdata, p0, JCfg(**kw))
    td, tc, tp = tile_from_numpy(arrays, device="cpu")
    got = result_to_numpy(sagefit(td, tc, tp, SageConfig(**kw),
                                  device="cpu"))
    assert rel(got["res_1"], want.res_1) <= 5e-3
    assert np.abs(got["p"] - np.asarray(want.p)).max() <= 5e-3
    assert np.abs(got["p"]).max() <= np.float32(BOUND)
    assert (np.abs(got["p"]) == np.float32(BOUND)).any()  # the bound acts
    assert float(got["res_1"]) < float(got["res_0"])
