"""Port vs JAX package: the ADMM x-step (``parallel/admm.py``).

The band is tests/test_admm_mesh.py's: 8 stations, 2 point-source
clusters, tilesz 2, one channel, made by the JAX package and carried
across as numpy.  Bars: 1e-8 relative (of the largest magnitude) at f64
in the LM modes, robust NSD and the RTR modes before their trust region
reaches the rounding floor; past it, the RTR modes within the JAX
package's own spread under a 1e-13 move of p0.  The consensus ADMM
over bands is tests/test_torch_mesh.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_admm_mesh import _one_band
from torch_port_common import free_jax_programs, tile_arrays  # noqa: F401

TOL = 1e-8
M, N = 2, 8


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    err = float(np.max(np.abs(a - b))) / scale
    assert err < tol, err


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _identity_p0():
    from sagecal_tpu.core.types import jones_to_params
    from sagecal_tpu.io.simulate import random_jones

    return jones_to_params(random_jones(M, N, seed=500, amp=0.0,
                                        dtype=np.complex128))[:, None, :]


def _band_problem(Nf, seed=11):
    """Nf JAX bands with gains linear in frequency, their p0s, and the
    ordinary Npoly=2 basis."""
    from sagecal_tpu.parallel import consensus as jc

    freqs = np.linspace(120e6, 180e6, Nf)
    f0 = 150e6
    rng = np.random.default_rng(seed)
    eye = np.eye(2)[None, None]
    Z0 = eye + 0.25 * (rng.standard_normal((M, N, 2, 2))
                       + 1j * rng.standard_normal((M, N, 2, 2)))
    Z1 = 0.15 * (rng.standard_normal((M, N, 2, 2))
                 + 1j * rng.standard_normal((M, N, 2, 2)))
    bands = []
    for f in range(Nf):
        frat = (freqs[f] - f0) / f0
        d, c = _one_band(f0, jnp.asarray(Z0 + frat * Z1), seed=f)
        bands.append((d.replace(freqs=jnp.asarray([freqs[f]])), c))
    p0s = [_identity_p0() for _ in range(Nf)]
    B = np.asarray(jc.setup_polynomials(freqs, f0, 2, jc.POLY_ORDINARY))
    return bands, p0s, B


def _port_band(data, cdata, p0):
    from sagecal_tpu_torch.interop import tile_from_numpy

    return tile_from_numpy(tile_arrays(data, cdata, p0), device="cpu")


# ------------------------------------------------------------- x-step


def _xstep_inputs(seed=3, near=False):
    """One band, p0, Y and BZ.  ``near``: p0 within 0.01 of the true
    gains, BZ within 0.01 of them and Y of 0.01, the later ADMM rounds'
    regime; else p0 the identity, Y of 0.05 and BZ unrelated gains."""
    from sagecal_tpu.core.types import jones_to_params
    from sagecal_tpu.io.simulate import random_jones

    jones = random_jones(M, N, seed=seed, amp=0.2, dtype=np.complex128)
    data, cdata = _one_band(150e6, jones)
    rng = np.random.default_rng(seed)
    if near:
        truth = np.asarray(jones_to_params(jones))[:, None, :]
        p0 = truth + 0.01 * rng.standard_normal(truth.shape)
        Y = 0.01 * rng.standard_normal(truth.shape)
        return data, cdata, p0, Y, truth + 0.01 * rng.standard_normal(
            truth.shape)
    p0 = _identity_p0()
    Y = 0.05 * rng.standard_normal(p0.shape)
    BZ = np.asarray(jones_to_params(random_jones(
        M, N, seed=seed + 7, amp=0.15, dtype=np.complex128)))[:, None, :]
    return data, cdata, p0, Y, BZ


def _both_xsteps(rho, emiter=1, itmax=6, near=False, **kw):
    """admm_sagefit of both packages on the same band: (jax, port)."""
    from sagecal_tpu.parallel.admm import admm_sagefit as jfit
    from sagecal_tpu.solvers.lm import LMConfig as JLM
    from sagecal_tpu_torch.parallel.admm import admm_sagefit
    from sagecal_tpu_torch.solvers.lm import LMConfig

    data, cdata, p0, Y, BZ = _xstep_inputs(near=near)
    rho = np.asarray(rho, np.float64)
    oj = jfit(data, cdata, p0, jnp.asarray(Y), jnp.asarray(BZ),
              jnp.asarray(rho), max_emiter=emiter,
              lm_config=JLM(itmax=itmax), **kw)
    d, c, pt = _port_band(data, cdata, p0)
    ot = admm_sagefit(d, c, pt, torch.as_tensor(Y), torch.as_tensor(BZ),
                      torch.as_tensor(rho), max_emiter=emiter,
                      lm_config=LMConfig(itmax=itmax), **kw)
    return oj, ot


def test_xstep_zero_rho_is_the_plain_solve():
    """rho = 0 and Y = 0: the augmented terms vanish; the x-step
    converges like the plain EM (tests/test_admm_mesh.py's bar) and
    matches the JAX package."""
    from sagecal_tpu.parallel.admm import admm_sagefit as jfit
    from sagecal_tpu.solvers.lm import LMConfig as JLM
    from sagecal_tpu_torch.parallel.admm import admm_sagefit
    from sagecal_tpu_torch.solvers.lm import LMConfig

    data, cdata, p0, _, _ = _xstep_inputs()
    z = np.zeros_like(np.asarray(p0))
    oj = jfit(data, cdata, p0, jnp.asarray(z), jnp.asarray(z),
              jnp.zeros((M,)), max_emiter=2, lm_config=JLM(itmax=15))
    d, c, pt = _port_band(data, cdata, p0)
    zt = torch.zeros_like(pt)
    ot = admm_sagefit(d, c, pt, zt, zt, torch.zeros(M, dtype=torch.float64),
                      max_emiter=2, lm_config=LMConfig(itmax=15))
    assert float(ot.res_1) < 0.2 * float(ot.res_0)
    _close(_np(ot.p), oj.p)
    _close(_np(ot.res_1), oj.res_1)


def test_xstep_large_rho_pins_solution_to_consensus():
    oj, ot = _both_xsteps(np.full((M,), 1e8), itmax=10)
    _, _, _, _, BZ = _xstep_inputs()
    assert float(np.max(np.abs(_np(ot.p) - BZ))) < 1e-3
    _close(_np(ot.p), oj.p)


@pytest.mark.parametrize("mode,robust_nu", [
    (1, None), (1, 5.0), (6, None),
], ids=["lm", "robust_lm", "robust_nsd"])
def test_xstep_modes_match_jax(mode, robust_nu):
    """LM (plain and IRLS-weighted) and robust NSD with the ADMM terms,
    two EM passes."""
    oj, ot = _both_xsteps(np.asarray([20.0, 8.0]), emiter=2, itmax=4,
                          near=True, solver_mode=mode, robust_nu=robust_nu)
    _close(_np(ot.p), oj.p)
    _close(_np(ot.res_0), oj.res_0)
    _close(_np(ot.res_1), oj.res_1)


@pytest.mark.parametrize("mode", [4, 5], ids=["rtr", "robust_rtr"])
def test_xstep_rtr_modes_match_jax(mode):
    """RTR and robust RTR with the ADMM terms, one EM pass, before the
    trust region reaches the rounding floor.  admm_sagefit runs itmax+5
    steepest-descent and itmax+10 trust-region steps a cluster solve;
    itmax=-4 is 1 and 6, where the JAX package's own p moves by under
    1e-12 when p0 moves by 1e-13 (tests/rtr_admm_sensitivity.py).  Held
    to 1e-8 in p, res_0 and res_1."""
    oj, ot = _both_xsteps(np.asarray([20.0, 8.0]), emiter=1, itmax=-4,
                          near=True, solver_mode=mode)
    _, _, p0, _, _ = _xstep_inputs(near=True)
    assert float(np.max(np.abs(_np(ot.p) - p0))) > 1e-3  # the solve moved
    assert float(ot.res_1) < float(ot.res_0)
    _close(_np(ot.p), oj.p)
    _close(_np(ot.res_0), oj.res_0)
    _close(_np(ot.res_1), oj.res_1)


def _jax_rtr_spread(mode, itmax, eps=1e-13):
    """The JAX x-step at p0 and at p0 (1 +- eps): (p at p0, the largest
    relative move of p)."""
    from sagecal_tpu.parallel.admm import admm_sagefit as jfit
    from sagecal_tpu.solvers.lm import LMConfig as JLM

    data, cdata, p0, Y, BZ = _xstep_inputs(near=True)
    ps = [np.asarray(jfit(data, cdata, jnp.asarray(p0 * (1 + e)),
                          jnp.asarray(Y), jnp.asarray(BZ),
                          jnp.asarray([20.0, 8.0]), max_emiter=2,
                          lm_config=JLM(itmax=itmax), solver_mode=mode).p)
          for e in (0.0, eps, -eps)]
    scale = float(np.max(np.abs(ps[0])))
    return ps[0], max(float(np.max(np.abs(q - ps[0]))) / scale
                      for q in ps[1:])


@pytest.mark.parametrize("mode", [4, 5], ids=["rtr", "robust_rtr"])
def test_xstep_rtr_past_the_floor_stays_within_jax_spread(mode):
    """At itmax=4 (9 and 14 steps) the trust-region steps reach the
    rounding floor and the JAX package does not reproduce itself: a
    1e-13 move of p0, the size of the two packages' rounding
    differences, moves its p by far more than 1e-8.  The port lands
    within twice that spread of it, and res_0 within 1e-8."""
    pj, spread = _jax_rtr_spread(mode, itmax=4)
    assert spread > 1e-7, spread
    oj, ot = _both_xsteps(np.asarray([20.0, 8.0]), emiter=2, itmax=4,
                          near=True, solver_mode=mode)
    np.testing.assert_array_equal(np.asarray(oj.p), pj)
    _close(_np(ot.res_0), oj.res_0)
    assert float(ot.res_1) < float(ot.res_0)
    _close(_np(ot.p), pj, 2 * spread)


def test_xstep_cluster_slice_solves_only_its_clusters():
    oj, ot = _both_xsteps(np.asarray([20.0, 8.0]), itmax=4,
                          cluster_slice=(1, 1))
    _, _, p0, _, _ = _xstep_inputs()
    np.testing.assert_array_equal(_np(ot.p)[0], np.asarray(p0)[0])
    _close(_np(ot.p), oj.p)


def test_dual_update_and_schedules_match_jax():
    from sagecal_tpu.parallel import admm as ja
    from sagecal_tpu_torch.parallel import admm as ta

    rng = np.random.default_rng(0)
    Y, p, BZ = (rng.standard_normal((2, 1, 16)) for _ in range(3))
    rho = np.asarray([2.0, 4.0])
    _close(_np(ta.admm_dual_update(*(torch.as_tensor(x)
                                      for x in (Y, p, BZ, rho)))),
           ja.admm_dual_update(*(jnp.asarray(x) for x in (Y, p, BZ, rho))))
    for kw in (dict(), dict(slot_rows=[3.0, 1.0, 0.0, 2.0]),
               dict(slot_rows=[1, 2, 3, 4, 5, 6, 7, 8], cluster_groups=2)):
        assert ta.round_work_weights(9, 4, 2, 1, **kw) == \
            ja.round_work_weights(9, 4, 2, 1, **kw)
    for kw in (dict(), dict(cluster_groups=2, ndev=2),
               dict(cluster_groups=2, ndev=2,
                    band_weights=[3.0, 1.0, 0.5, 2.0, 1.0, 1.0])):
        for a, b in zip(ta.factor_schedule(11, 3, **kw),
                        ja.factor_schedule(11, 3, **kw)):
            np.testing.assert_array_equal(a, b)
