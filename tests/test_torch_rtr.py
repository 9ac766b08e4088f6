"""Port vs JAX package: the RTR/NSD manifold solvers (``solvers/rtr.py``)
and the SAGE modes 4-6 that run them.

Mirrors ``tests/test_rtr.py``: the projection is idempotent and
horizontal and annihilates vertical directions, the metric.  Then the
same tile (8 stations, 3 timeslots, 2 channels, two hybrid chunks,
f64, built by the JAX package from a numpy seed) goes through each
solver of both packages: ``p`` and the per-chunk costs within 1e-8
relative (the two differ by f64 rounding in another summation order).
The explicit Wirtinger gradient is held to autograd of the cost and
the explicit Hessian-vector product to central differences of that
gradient, and both to the JAX package's ``jax.grad``/``jax.jvp``.
``sagefit`` in modes 4-6 is in ``tests/test_torch_rtr_sage.py``.
"""

import numpy as np
import pytest
import torch

from torch_port_common import tile_arrays, to_np

F64_TOL = 1e-8


def _rand_c(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def problem():
    """One cluster of two point sources (one spectral) on 8 stations,
    3 timeslots x 2 channels, 2 hybrid chunks, noise 1e-3, a few
    flagged rows; the JAX tile as numpy."""
    import jax.numpy as jnp

    from sagecal_tpu.core.types import jones_to_params
    from sagecal_tpu.io.simulate import (
        corrupt_and_observe, make_visdata, random_jones,
    )
    from sagecal_tpu.ops.rime import point_source_batch
    from sagecal_tpu.solvers.sage import build_cluster_data

    data = make_visdata(nstations=8, tilesz=3, nchan=2, dtype=np.float64,
                        seed=3)
    src = point_source_batch([0.0, 0.01], [0.0, -0.005], [2.0, 1.0],
                             dtype=jnp.float64)
    clusters = [src, point_source_batch([-0.02], [0.01], [1.5],
                                        dtype=jnp.float64)]
    jones = random_jones(2, 8, seed=5, amp=0.25, dtype=np.complex128)
    data = corrupt_and_observe(data, clusters, jones=jones, noise_sigma=1e-3,
                               seed=6)
    mask = np.ones(data.mask.shape)
    mask[:, [3, 17, 40]] = 0.0
    data = data.replace(mask=jnp.asarray(mask))
    cdata = build_cluster_data(data, clusters, [2, 1])
    p0 = jones_to_params(random_jones(2, 8, seed=99, amp=0.05,
                                      dtype=np.complex128))
    p0 = jnp.stack([p0, p0], axis=1)  # (M, 2 chunks, 8N)
    return data, cdata, p0, tile_arrays(data, cdata, p0)


def _solver_args(arrays, k=0):
    """Cluster k's solver arguments: (numpy tuple, torch tuple)."""
    keys = ("vis", "coh", "mask", "ant_p", "ant_q", "chunk_map", "p0")
    np_args = (arrays["vis"], arrays["coh"][k], arrays["mask"],
               arrays["ant_p"], arrays["ant_q"], arrays["chunk_map"][k],
               arrays["p0"][k])
    t_args = tuple(
        torch.from_numpy(np.array(a)).long() if key in ("ant_p", "ant_q",
                                                         "chunk_map")
        else torch.from_numpy(np.array(a)) for key, a in zip(keys, np_args))
    return np_args, t_args


def _close(got_p, got_c0, got_c, want, tol=F64_TOL):
    want_p = np.asarray(want.p)
    assert np.abs(to_np(got_p) - want_p).max() <= tol * np.abs(want_p).max()
    for g, w in ((got_c0, want.cost0), (got_c, want.cost)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=tol, atol=0)


class TestGeometry:
    def test_projection_is_idempotent_and_horizontal(self):
        from sagecal_tpu_torch.solvers.rtr import _project

        rng = np.random.default_rng(0)
        N = 6
        x = torch.from_numpy(_rand_c(rng, (3, N, 2, 2)))
        z = torch.from_numpy(_rand_c(rng, (3, N, 2, 2)))
        h = _project(x, z)
        np.testing.assert_allclose(to_np(_project(x, h)), to_np(h), atol=1e-8)
        for b in range(3):
            X = to_np(x[b]).reshape(2 * N, 2)
            S = np.conj(X.T) @ to_np(h[b]).reshape(2 * N, 2)
            np.testing.assert_allclose(S, np.conj(S.T), atol=1e-8)

    def test_projection_matches_jax_and_kills_vertical(self):
        import jax.numpy as jnp

        from sagecal_tpu.solvers.rtr import _project as jproject
        from sagecal_tpu_torch.solvers.rtr import _project

        rng = np.random.default_rng(1)
        N = 5
        x, z = _rand_c(rng, (N, 2, 2)), _rand_c(rng, (N, 2, 2))
        want = np.asarray(jproject(jnp.asarray(x), jnp.asarray(z)))
        got = to_np(_project(torch.from_numpy(x)[None],
                             torch.from_numpy(z)[None])[0])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        Om = _rand_c(rng, (2, 2))
        Om = Om - np.conj(Om.T)  # skew-Hermitian: a gauge direction
        v = (x.reshape(2 * N, 2) @ Om).reshape(N, 2, 2)
        h = _project(torch.from_numpy(x)[None], torch.from_numpy(v)[None])
        assert float(h.abs().max()) < 1e-8

    def test_metric(self):
        from sagecal_tpu_torch.solvers.rtr import _g

        a = torch.tensor([[[[1.0 + 1j, 0], [0, 0]]]])
        assert float(_g(a, a)[0]) == pytest.approx(4.0)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "robust"])
def test_explicit_gradient_and_hessian(problem, weighted):
    """The closed-form data gradient is autograd's (in the metric's
    convention, 0.5 (d/dRe + i d/dIm)); the Hessian-vector product is
    the central difference of that gradient."""
    from sagecal_tpu_torch.solvers.lm import NormalEqPlan
    from sagecal_tpu_torch.solvers.rtr import _Fns, _project

    _, (vis, coh, mask, ant_p, ant_q, cmap, _) = _solver_args(problem[3])
    rng = np.random.default_rng(2)
    sqrt_w = (torch.from_numpy(rng.uniform(0.5, 1.5, (2, 1, vis.shape[-1])))
              if weighted else None)
    plan = NormalEqPlan(ant_p, ant_q, cmap, 2, 8)
    fns = _Fns(vis, coh, mask, plan, sqrt_w)
    x = torch.from_numpy(_rand_c(rng, (2, 8, 2, 2)) * 0.3
                         + np.eye(2)[None, None])
    xri = torch.view_as_real(x).clone().requires_grad_(True)
    cost = fns.cost(torch.view_as_complex(xri)).sum()
    (gri,) = torch.autograd.grad(cost, xri)
    want = 0.5 * torch.view_as_complex(gri)
    got = fns.egrad(x)
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())

    eta = torch.from_numpy(_rand_c(rng, (2, 8, 2, 2)))
    h = 1e-5
    fd = (fns.egrad(x + h * eta) - fns.egrad(x - h * eta)) / (2 * h)
    # hess() projects the iw-weighted derivative; the projection is linear
    want = _project(x, fd * fns.iw)
    got = fns.hess(x, eta)
    assert float((got - want).abs().max()) <= 1e-7 * float(want.abs().max())


def test_hessian_matches_jax_jvp(problem):
    """The port's projected Hessian-vector product is the JAX package's
    ``hess_fn`` (jvp through grad) on one chunk lane."""
    import jax.numpy as jnp

    from sagecal_tpu.solvers.rtr import _make_fns, _station_iw
    from sagecal_tpu_torch.solvers.lm import NormalEqPlan
    from sagecal_tpu_torch.solvers.rtr import _Fns

    np_args, (vis, coh, mask, ant_p, ant_q, cmap, _) = _solver_args(
        problem[3])
    rng = np.random.default_rng(4)
    x = _rand_c(rng, (2, 8, 2, 2)) * 0.3 + np.eye(2)[None, None]
    eta = _rand_c(rng, (2, 8, 2, 2))
    fns = _Fns(vis, coh, mask, NormalEqPlan(ant_p, ant_q, cmap, 2, 8))
    got_h = to_np(fns.hess(torch.from_numpy(x), torch.from_numpy(eta)))
    got_g = to_np(fns.grad(torch.from_numpy(x)))
    for c in range(2):
        rowmask = np_args[2] * (np_args[5] == c)[None, :]
        _, grad_fn, hess_fn = _make_fns(
            jnp.asarray(np_args[0]), jnp.asarray(np_args[1]),
            jnp.asarray(rowmask), jnp.asarray(np_args[3]),
            jnp.asarray(np_args[4]), None)
        iw = _station_iw(jnp.asarray(rowmask), jnp.asarray(np_args[3]),
                         jnp.asarray(np_args[4]), 8)
        want_h = np.asarray(hess_fn(jnp.asarray(x[c]), jnp.asarray(eta[c]), iw))
        want_g = np.asarray(grad_fn(jnp.asarray(x[c]), iw))
        np.testing.assert_allclose(got_h[c], want_h, rtol=0,
                                   atol=1e-10 * np.abs(want_h).max())
        np.testing.assert_allclose(got_g[c], want_g, rtol=0,
                                   atol=1e-10 * np.abs(want_g).max())


SOLVERS = {
    "rtr": lambda m: (m.rtr_solve, dict(config=m.RTRConfig(
        itmax_rsd=4, itmax_rtr=8, max_inner=6)), False),
    "nsd": lambda m: (m.nsd_solve, dict(itmax=12), False),
    "rtr_robust": lambda m: (m.rtr_solve_robust, dict(config=m.RTRConfig(
        itmax_rsd=3, itmax_rtr=6, max_inner=6), nu0=4.0, em_iters=2), True),
    "nsd_robust": lambda m: (m.nsd_solve_robust, dict(itmax=10, nu0=4.0,
                                                      em_iters=2), True),
    "rtr_dynamic": lambda m: (m.rtr_solve, dict(config=m.RTRConfig(
        itmax_rsd=9, itmax_rtr=14), itmax_dynamic=2), False),
}


@pytest.mark.parametrize("name", list(SOLVERS))
def test_solver_matches_jax(problem, name):
    import jax.numpy as jnp

    import sagecal_tpu.solvers.rtr as jr
    import sagecal_tpu_torch.solvers.rtr as tr

    np_args, t_args = _solver_args(problem[3])
    jfn, jkw, robust = SOLVERS[name](jr)
    tfn, tkw, _ = SOLVERS[name](tr)
    want = jfn(*map(jnp.asarray, np_args), **jkw)
    got = tfn(*t_args, **tkw)
    if robust:
        (want, want_nu), (got, got_nu) = want, got
        assert float(got_nu) == float(want_nu)
    _close(got.p, got.cost0, got.cost, want)
    assert float(got.cost.sum()) < float(got.cost0.sum())


def test_admm_terms_match_jax(problem):
    import jax.numpy as jnp

    import sagecal_tpu.solvers.rtr as jr
    import sagecal_tpu_torch.solvers.rtr as tr

    np_args, t_args = _solver_args(problem[3])
    rng = np.random.default_rng(8)
    y = 0.1 * rng.standard_normal(np_args[-1].shape)
    bz = np_args[-1] + 0.05 * rng.standard_normal(np_args[-1].shape)
    kw = dict(itmax=8)
    want = jr.nsd_solve(*map(jnp.asarray, np_args), admm_y=jnp.asarray(y),
                        admm_bz=jnp.asarray(bz), admm_rho=2.0, **kw)
    got = tr.nsd_solve(*t_args, admm_y=torch.from_numpy(y),
                       admm_bz=torch.from_numpy(bz), admm_rho=2.0, **kw)
    _close(got.p, got.cost0, got.cost, want)
    cfg = dict(config=jr.RTRConfig(itmax_rsd=3, itmax_rtr=5, max_inner=5))
    want = jr.rtr_solve(*map(jnp.asarray, np_args), admm_y=jnp.asarray(y),
                        admm_bz=jnp.asarray(bz), admm_rho=2.0, **cfg)
    got = tr.rtr_solve(*t_args, tr.RTRConfig(itmax_rsd=3, itmax_rtr=5,
                                             max_inner=5),
                       admm_y=torch.from_numpy(y),
                       admm_bz=torch.from_numpy(bz), admm_rho=2.0)
    _close(got.p, got.cost0, got.cost, want)


def test_rtr_counts_host_reads_and_refuses_traces(problem):
    import sagecal_tpu_torch.solvers.rtr as tr

    _, t_args = _solver_args(problem[3])
    cfg = tr.RTRConfig(itmax_rsd=2, itmax_rtr=3)
    before = tr.host_read.count
    plain = tr.rtr_solve(*t_args, cfg)
    reads = tr.host_read.count - before
    assert reads > 0
    # traces and quality, refused until they were ported, now run and
    # read nothing more back to the host
    for kw in (dict(collect_trace=True), dict(collect_quality=True)):
        before = tr.host_read.count
        out = tr.rtr_solve(*t_args, cfg, **kw)
        assert tr.host_read.count - before == reads
        assert torch.equal(out.p, plain.p)
