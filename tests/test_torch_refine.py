"""Port vs JAX package: sky-model refinement (``refine/``,
``apps/refine.py``).

The problem is tests/test_refine.py's (a 5-station ``make_sky`` tile,
one flux perturbed by 15%), fed to both packages through
``interop.refine_problem_from_numpy``.  Bars at f64: ``cg_solve``,
``gauss_newton_solve`` and the inner-solver routes' values and theta
gradients within 1e-8; the port's implicit gradient within 1e-3 of a
central finite difference (the JAX package's pin).

The route gradients are held to 1e-8 or to twice the JAX package's own
spread, whichever is larger: a 1e-14 move of its inner start moves the
exact-HVP adjoint's gradient by ~1e-7 relative (the Gauss-Newton and
adjoint CG amplify rounding), so the test measures that spread.  The
Gauss-Newton adjoint (``--adjoint-matvec jtj``) stays within ~1e-9, and
the app's synthetic theta trajectory runs on it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import free_jax_programs, to_np  # noqa: F401

INNER = dict(iters=6, cg_iters=32, damping=1e-6, adjoint_cg_iters=64)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the problem is tiny and per-op pool overhead
    dominates the CPU runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problems():
    from sagecal_tpu.data import make_sky, perturb_flux
    from sagecal_tpu.refine import RefineProblem, SkySpec
    from sagecal_tpu_torch.interop import refine_problem_from_numpy

    sky = make_sky(nstations=5, tilesz=2, noise_sigma=0.0, seed=3,
                   dtype=np.float64)
    clusters = perturb_flux(sky, factor=1.15, cluster=0, source=0)
    jp = RefineProblem(data=sky.data, clusters=clusters,
                       tables=sky.shapelet_tables,
                       spec=SkySpec(flux=[(0, 0)]), ridge=1e-2)
    return sky, jp, refine_problem_from_numpy(jp, device="cpu")


def _theta(jp):
    th = jp.spec.theta0(jp.clusters, jp.tables)
    return th, torch.tensor(np.asarray(th))


def _rel(a, b):
    a, b = to_np(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_skyspec_matches_jax(problems):
    from sagecal_tpu.refine import SkySpec as JSpec
    from sagecal_tpu_torch.interop import sky_spec_from_numpy

    sky, jp, tp = problems
    js = JSpec(flux=[(0, 0), (1, 0)], spec=[(0, 2)], pos=[(0, 1)])
    ts = sky_spec_from_numpy(js)
    assert repr(ts) == repr(js) and ts.nparams == js.nparams == 5
    jth = js.theta0(jp.clusters)
    tth = ts.theta0(tp.clusters)
    np.testing.assert_array_equal(tth.numpy(), np.asarray(jth))
    moved = np.asarray(jth) + np.asarray([0.1, -0.2, 0.3, 0.05, -0.04])
    jc, _ = js.apply(jnp.asarray(moved), jp.clusters)
    tc, _ = ts.apply(torch.tensor(moved), tp.clusters)
    for a, b in zip(tc, jc):
        for f in ("sI0", "spec_idx", "ll", "mm", "nn"):
            np.testing.assert_allclose(getattr(a, f).numpy(),
                                       np.asarray(getattr(b, f)),
                                       rtol=1e-15, atol=1e-15)
    with pytest.raises(ValueError, match="no ShapeletTable"):
        type(ts)(modes=[(0, 0)]).theta0(tp.clusters, None)


def test_require_xla_predict_raises_fused_sky_gradient_error():
    from sagecal_tpu_torch.ops.rime_kernel import FusedSkyGradientError
    from sagecal_tpu_torch.refine import require_xla_predict

    require_xla_predict(False)
    with pytest.raises(FusedSkyGradientError, match="--fused"):
        require_xla_predict(True)


def test_objectives_and_cg_match_jax(problems):
    from sagecal_tpu.refine import (
        cg_solve as jcg, inner_cost as jinner, outer_cost as jouter,
        residual_vec as jres,
    )
    from sagecal_tpu_torch.refine import (
        cg_solve, inner_cost, outer_cost, residual_vec,
    )

    _, jp, tp = problems
    th, tth = _theta(jp)
    rng = np.random.default_rng(4)
    p = np.asarray(jp.identity_gains()) + 0.05 * rng.standard_normal(
        jp.nparams_p)
    tpp = torch.tensor(p)
    assert _rel(residual_vec(tp, tpp, tth), jres(jp, jnp.asarray(p), th)) \
        <= 1e-12
    for t, j in ((outer_cost, jouter), (inner_cost, jinner)):
        assert _rel(t(tp, tpp, tth), j(jp, jnp.asarray(p), th)) <= 1e-12
    A = rng.standard_normal((30, 30))
    A = A @ A.T + 0.1 * np.eye(30)
    b = rng.standard_normal(30)
    for iters in (5, 40):
        xj = jcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), iters)
        xt = cg_solve(lambda v: torch.tensor(A) @ v, torch.tensor(b), iters)
        assert _rel(xt, xj) <= 1e-8


def test_gauss_newton_matches_jax(problems):
    from sagecal_tpu.refine import gauss_newton_solve as jgn
    from sagecal_tpu_torch.refine import gauss_newton_solve

    _, jp, tp = problems
    th, tth = _theta(jp)
    pj = jgn(jp, th, jp.identity_gains(), iters=4)
    pt = gauss_newton_solve(tp, tth, tp.identity_gains(), iters=4)
    assert _rel(pt, pj) <= 1e-8
    # the steps approach the fixed point: the inner gradient shrinks
    from sagecal_tpu_torch.refine.implicit import _inner_grad

    g0 = _inner_grad(tp, tp.identity_gains(), tth).norm()
    assert float(_inner_grad(tp, pt, tth).norm()) < 1e-2 * float(g0)


@pytest.fixture(scope="module")
def jax_routes(problems):
    """The JAX package's (solve, vg, cost) of each route, compiled once
    for the module."""
    from sagecal_tpu.refine import make_outer_value_and_grad as jmk

    _, jp, _ = problems
    return {r: jmk(jp, gradient=g, adjoint_matvec=m, **_inner(r))
            for r, (g, m) in ROUTES.items()}


ROUTES = {"jtj": ("implicit", "jtj"), "hvp": ("implicit", "hvp"),
          "unrolled": ("unrolled", "hvp")}


def _inner(route):
    """The unrolled route keeps the graph of every step: a shorter
    solve keeps its test cheap."""
    if route == "unrolled":
        return dict(INNER, iters=3, cg_iters=16)
    return INNER


@pytest.mark.parametrize("route", ["jtj", "hvp", "unrolled"])
def test_inner_routes_value_and_gradient_match_jax(problems, jax_routes,
                                                   route):
    from sagecal_tpu_torch.refine import make_outer_value_and_grad

    _, jp, tp = problems
    th, tth = _theta(jp)
    g, m = ROUTES[route]
    _, jvg, _ = jax_routes[route]
    ts, tvg, tc = make_outer_value_and_grad(tp, gradient=g,
                                            adjoint_matvec=m, **_inner(route))
    p0j, p0t = jp.identity_gains(), tp.identity_gains()
    hj, gj = jvg(th, p0j)
    ht, gt = tvg(tth, p0t)
    # 1e-8, or twice the JAX package's own spread under a 1e-14 move of
    # its inner start where that is larger
    h2, g2 = jvg(th, p0j + 1e-14)
    assert _rel(ht, hj) <= max(1e-8, 2.0 * _rel(h2, hj))
    bar = max(1e-8, 2.0 * _rel(g2, gj))
    assert _rel(gt, gj) <= bar, (_rel(gt, gj), bar)
    if route != "unrolled":
        eps = 1e-5
        fd = (float(tc(tth + eps, p0t)) - float(tc(tth - eps, p0t))) / (2 * eps)
        assert abs(float(gt[0]) - fd) / abs(fd) <= 1e-3


def test_synthetic_app_trajectory_matches_jax(tmp_path, problems,
                                              jax_routes):
    """``refine --synthetic 5`` (the Gauss-Newton adjoint) against the
    JAX package's ``run_refine`` on the same sky (its first outer
    iteration: each JAX one recompiles its LBFGS loop): theta within
    1e-8; the app's third iteration brings the flux back within 1%; the
    app's files."""
    from sagecal_tpu.refine import run_refine as jrun
    from sagecal_tpu_torch.apps.refine import main

    sky, jp, _ = problems
    out = tmp_path / "r"
    argv = ["--synthetic", "5", "--outer-iters", "3", "--inner-iters",
            str(INNER["iters"]), "--cg-iters", str(INNER["cg_iters"]),
            "--adjoint-cg-iters", str(INNER["adjoint_cg_iters"]),
            "--adjoint-matvec", "jtj", "--seed", "3", "-o", str(out)]
    assert main(argv, device="cpu") == 0
    jres = jrun(jp, outer_iters=1, fns=jax_routes["jtj"])
    trace = [json.loads(line) for line in open(f"{out}.trace.jsonl")]
    assert len(trace) == 3
    for a, b in zip(trace, jres.trace):
        np.testing.assert_allclose(a["theta"], b["theta"], rtol=1e-8)
        # the misfit at the inner solve's end is 1e-3 of its start: its
        # rounding shows at ~1e-6 relative
        np.testing.assert_allclose(a["cost"], b["cost"], rtol=1e-5)
    summary = json.load(open(f"{out}.json"))
    true_flux = float(sky.true_flux[0][0])
    assert summary["flux_err"] < 1e-2
    assert abs(summary["true_flux"] - true_flux) <= 1e-12 * true_flux
    z = np.load(f"{out}.npz")
    np.testing.assert_array_equal(z["theta"], trace[-1]["theta"])
    assert z["p"].shape == (jp.nparams_p,)


def test_dataset_mode_loads_the_jax_problem_and_runs(tmp_path):
    """Dataset mode: the tile and the catalog the JAX app would refine
    (``_build_problem``), then one outer iteration that lowers the
    misfit."""
    from sagecal_tpu.apps.config import RefineConfig as JCfg
    from sagecal_tpu.apps.refine import _build_problem as jbuild
    from sagecal_tpu.refine import SkySpec as JSpec
    from sagecal_tpu.io.simulate import random_jones
    from sagecal_tpu_torch.apps.config import RefineConfig
    from sagecal_tpu_torch.apps.refine import _build_problem, main
    from sagecal_tpu_torch.refine import SkySpec
    from test_apps import CLUSTER, SKY, _make_dataset

    (tmp_path / "t.sky.txt").write_text(SKY)
    (tmp_path / "t.sky.txt.cluster").write_text(CLUSTER)
    jones = random_jones(2, 7, seed=6, amp=0.1, dtype=np.complex128)
    _make_dataset(tmp_path / "d.h5", ntime=2, nchan=1, jones=jones)
    kw = dict(dataset=str(tmp_path / "d.h5"),
              sky_model=str(tmp_path / "t.sky.txt"),
              cluster_file=str(tmp_path / "t.sky.txt.cluster"), tilesz=2)
    jp, _ = jbuild(JCfg(**kw), JSpec(flux=[(0, 0)]), print)
    tp, _ = _build_problem(RefineConfig(**kw), SkySpec(flux=[(0, 0)]),
                           print, torch.device("cpu"))
    for f in ("u", "v", "w", "vis", "mask", "freqs"):
        np.testing.assert_array_equal(getattr(tp.data, f).numpy(),
                                      np.asarray(getattr(jp.data, f)))
    for a, b in zip(tp.clusters, jp.clusters):
        np.testing.assert_allclose(a.sI0.numpy(), np.asarray(b.sI0),
                                   rtol=1e-15)
    out = tmp_path / "ds"
    assert main(["-d", kw["dataset"], "-s", kw["sky_model"], "-o", str(out),
                 "--outer-iters", "1", "--inner-iters", "4",
                 "--adjoint-matvec", "jtj"], device="cpu") == 0
    summary = json.load(open(f"{out}.json"))
    assert summary["outer_iters"] == 1 and np.isfinite(summary["cost"])
    assert "flux_err" not in summary
