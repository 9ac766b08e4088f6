"""Port vs JAX package: the quality reductions of ``ops/quality.py``.

Random f64 inputs made with numpy from a seed go through the JAX
package's function and the port's: every output within 1e-12 of its
largest magnitude (the two sum in other orders; the histogram counts
are exact).  The reference's invariants hold in the port:
``sum(chi2_station) == 2 * sum(chi2_chunk)`` and
``sum(chi2_baseline) == sum(chi2_chunk)`` to 1e-12, and the solver plan
gives the same sums as a plan built from the indices.  The host side
(``obs/quality.py``): the same verdict and summary as the JAX package's
on the same numbers, and heatmap files with the same bytes.
"""

import numpy as np
import pytest
import torch

from torch_port_common import to_np

TOL = 1e-12
N, NCHUNK, F, ROWS = 6, 3, 2, 45


def _close(got, want):
    g, w = to_np(got).astype(np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1e-300)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    ap, aq = np.triu_indices(N, 1)
    rep = -(-ROWS // ap.size)
    ant_p = np.tile(ap, rep)[:ROWS]
    ant_q = np.tile(aq, rep)[:ROWS]
    chunk = np.sort(rng.integers(0, NCHUNK, ROWS))
    e = rng.standard_normal((F, 8, ROWS))
    e[:, :, [4, 20]] = 0.0  # masked rows carry a zero residual
    p = rng.standard_normal((2, NCHUNK, 8 * N)) * 0.3
    p[..., 0::8] += 1.0
    p[..., 6::8] += 1.0
    mask8 = (rng.uniform(size=(F, 1, ROWS)) > 0.2).astype(np.float64)
    sqrt_w = np.sqrt(rng.uniform(0.05, 1.2, (F, 8, ROWS)))
    return dict(e=e, ant_p=ant_p, ant_q=ant_q, chunk=chunk, p=p,
                mask8=mask8, sqrt_w=sqrt_w, nu=np.float64(4.5))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_row_chi2_and_chi2_scatter_match_jax(inputs):
    import jax.numpy as jnp

    from sagecal_tpu.ops import quality as jq
    from sagecal_tpu_torch.ops import quality as tq

    row_j = jq.row_chi2(jnp.asarray(inputs["e"]))
    row_t = tq.row_chi2(_t(inputs["e"]))
    _close(row_t, row_j)
    want = jq.chi2_scatter(row_j, jnp.asarray(inputs["ant_p"]),
                           jnp.asarray(inputs["ant_q"]),
                           jnp.asarray(inputs["chunk"]), N, NCHUNK)
    got = tq.chi2_scatter(row_t, _t(inputs["ant_p"]), _t(inputs["ant_q"]),
                          _t(inputs["chunk"]), N, NCHUNK)
    for g, w in zip(got, want):
        _close(g, w)
    st, bl, ch = (to_np(x) for x in got)
    tot = ch.sum()
    assert abs(st.sum() - 2.0 * tot) <= TOL * tot
    assert abs(bl.sum() - tot) <= TOL * tot
    assert abs(tot - float(row_t.sum())) <= TOL * tot


def test_chi2_scatter_on_the_solver_plan(inputs):
    """The solver's NormalEqPlan (the route inside a solve) gives the
    sums of a plan built from the indices, and one total for a single
    chunk."""
    from sagecal_tpu_torch.ops import quality as tq
    from sagecal_tpu_torch.solvers.lm import NormalEqPlan

    args = (_t(inputs["ant_p"]), _t(inputs["ant_q"]), _t(inputs["chunk"]))
    row = tq.row_chi2(_t(inputs["e"]))
    plan = NormalEqPlan(*args, NCHUNK, N)
    own = tq.chi2_scatter(row, *args, N, NCHUNK)
    for g, w in zip(tq.chi2_scatter(row, *args, N, NCHUNK, plan), own):
        _close(g, w)
    st, bl, ch = tq.chi2_scatter(row, *args, N, 1, plan)
    _close(st, own[0])
    _close(bl, own[1])
    _close(ch, own[2].sum().reshape(1))


@pytest.mark.parametrize("dof", [1.0, 2.0])
def test_weight_stats_match_jax(inputs, dof):
    import jax.numpy as jnp

    from sagecal_tpu.ops import quality as jq
    from sagecal_tpu_torch.ops import quality as tq

    want = jq.weight_stats(jnp.asarray(inputs["sqrt_w"]),
                           jnp.asarray(inputs["nu"]),
                           jnp.asarray(inputs["mask8"]), dof=dof)
    got = tq.weight_stats(_t(inputs["sqrt_w"]), _t(inputs["nu"]),
                          _t(inputs["mask8"]), dof=dof)
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[0].sum()) == float(inputs["mask8"].sum()) * 8
    assert tq.WEIGHT_HIST_BINS == jq.WEIGHT_HIST_BINS
    assert tq.DOWNWEIGHT_THRESH == jq.DOWNWEIGHT_THRESH


@pytest.mark.parametrize("poison", [False, True], ids=["finite", "nan"])
def test_gain_health_matches_jax(inputs, poison):
    import jax.numpy as jnp

    from sagecal_tpu.ops import quality as jq
    from sagecal_tpu_torch.ops import quality as tq

    p = inputs["p"].copy()
    if poison:
        p[0, 1, 3] = np.nan
        p[1, 0, 17] = np.inf
    want = jq.gain_health(jnp.asarray(p))
    got = tq.gain_health(_t(p))
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[0]) == (2.0 if poison else 0.0)


@pytest.mark.parametrize("robust", [False, True], ids=["plain", "robust"])
def test_residual_quality_matches_jax(inputs, robust):
    import jax.numpy as jnp

    from sagecal_tpu.ops import quality as jq
    from sagecal_tpu_torch.ops import quality as tq

    kw_j, kw_t = {}, {}
    if robust:
        kw_j = dict(nu=jnp.asarray(inputs["nu"]),
                    sqrt_w=jnp.asarray(inputs["sqrt_w"]),
                    mask8=jnp.asarray(inputs["mask8"]), weight_dof=2.0)
        kw_t = dict(nu=_t(inputs["nu"]), sqrt_w=_t(inputs["sqrt_w"]),
                    mask8=_t(inputs["mask8"]), weight_dof=2.0)
    p = inputs["p"][0]
    want = jq.residual_quality(
        jnp.asarray(inputs["e"]), jnp.asarray(p),
        jnp.asarray(inputs["ant_p"]), jnp.asarray(inputs["ant_q"]),
        jnp.asarray(inputs["chunk"]), NCHUNK, **kw_j)
    got = tq.residual_quality(_t(inputs["e"]), _t(p), _t(inputs["ant_p"]),
                              _t(inputs["ant_q"]), _t(inputs["chunk"]),
                              NCHUNK, **kw_t)
    assert got._fields == want._fields
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        assert (g is None) == (w is None), name
        if w is not None:
            _close(g, w)


def test_watchdog_and_heatmaps_match_jax(inputs, tmp_path):
    """The host side: verdict and summary of a port SolveQuality equal
    the JAX package's on the same numbers, and the heatmap writers write
    the reference's bytes."""
    import jax.numpy as jnp

    from sagecal_tpu.obs import quality as jw
    from sagecal_tpu.ops import quality as jq
    from sagecal_tpu_torch.obs import quality as tw
    from sagecal_tpu_torch.ops import quality as tq

    p = inputs["p"][0].copy()
    p[0, 5] = np.nan
    args = (inputs["e"], p, inputs["ant_p"], inputs["ant_q"],
            inputs["chunk"])
    want = jq.residual_quality(*map(jnp.asarray, args), NCHUNK)
    got = tq.residual_quality(*map(_t, args), NCHUNK)
    wd, gd = jw.quality_to_host(want), tw.quality_to_host(got)
    assert gd.keys() == wd.keys()
    assert tw.assess_quality(gd) == jw.assess_quality(wd)
    assert tw.assess_quality(gd)[0] == "diverged"
    gs, ws = tw.quality_summary(gd), jw.quality_summary(wd)
    assert gs.keys() == ws.keys()
    for k in ws:
        _close(gs[k], ws[k])
    for name, fn in (("station", "write_station_heatmap"),
                     ("baseline", "write_baseline_heatmap")):
        a = np.abs(inputs["e"][0, :N, :N]) if name == "baseline" else \
            np.abs(inputs["e"][:, 0, :N])
        getattr(tw, fn)(a, str(tmp_path / f"t{name}.ppm"), min_px=32)
        getattr(jw, fn)(a, str(tmp_path / f"j{name}.ppm"), min_px=32)
        assert (tmp_path / f"t{name}.ppm").read_bytes() == \
            (tmp_path / f"j{name}.ppm").read_bytes()
