"""Port vs JAX package: the hierarchical sky predict (``sky/``).

Same numpy skies and rows into both packages (tests/test_sky_hier.py's
clustered wide field and compact 30 MHz array, where the far field is
active).  Bars: tree, routing and plan arrays exactly equal; moments,
``far_field_tile``, ``near_field_tiles`` and ``predict_coherencies_hier``
(npol 1 and 4) within 1e-12 of the largest magnitude at f64; flux
gradients 1e-10; the port's hierarchical gradient within 1e-3 of its
exact one (the JAX package's pin); ``sampled_error_estimate`` the same
rows and ``rel_err`` within 1e-10; ``check_hier_predict`` the same
verdicts and events.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sky_hier import _compact_obs, _exact, _wide_sky
from torch_port_common import free_jax_programs, to_np  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _rows(d):
    return _t(d.u), _t(d.v), _t(d.w), _t(d.freqs)


def _src(src):
    from sagecal_tpu_torch.interop import sources_from_numpy

    return sources_from_numpy(src, device="cpu")


def _close(a, b, tol):
    a, b = to_np(a), np.asarray(b)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    assert float(np.max(np.abs(a - b))) <= tol * scale, (
        float(np.max(np.abs(a - b))) / scale)


@pytest.fixture(scope="module")
def scene():
    return _wide_sky(S=400), _compact_obs(nstations=12)


def test_tree_routing_and_partition_equal_jax(scene):
    from sagecal_tpu.sky.tree import (
        build_source_tree as jtree, partition_by_tree as jpart,
        route_tiles as jroute,
    )
    from sagecal_tpu_torch.sky.tree import (
        build_source_tree, choose_depth, partition_by_tree, route_tiles,
    )
    from sagecal_tpu.sky.tree import choose_depth as jdepth

    src, d = scene
    pos = [np.asarray(x, np.float64) for x in (src.ll, src.mm, src.nn)]
    for leaf in (8, 32):
        a, b = build_source_tree(*pos, leaf_size=leaf), jtree(*pos,
                                                              leaf_size=leaf)
        assert a.depth == b.depth
        for f in ("level_offset", "node_center", "node_radius", "node_count",
                  "node_of_source", "perm", "leaf_start", "leaf_count"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        for k in (1, 4, 9):
            ga, gb = partition_by_tree(a, k), jpart(b, k)
            assert len(ga) == len(gb)
            for x, y in zip(ga, gb):
                np.testing.assert_array_equal(x, y)
        uvw = [np.asarray(x, np.float64) for x in (d.u, d.v, d.w)]
        for theta in (0.0, 0.7, 1.5):
            ra = route_tiles(a, *uvw, 30e6, theta, tile_rows=64)
            rb = jroute(b, *uvw, 30e6, theta, tile_rows=64)
            for f in ("far_idx", "far_valid", "near_src", "near_valid"):
                np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
            assert (ra.ntiles, ra.tile_rows, ra.rows, ra.far_pairs,
                    ra.near_sources_total) == (
                rb.ntiles, rb.tile_rows, rb.rows, rb.far_pairs,
                rb.near_sources_total)
    assert [choose_depth(n, 32) for n in (1, 33, 5000, 10 ** 6)] == [
        jdepth(n, 32) for n in (1, 33, 5000, 10 ** 6)]


@pytest.mark.parametrize("polarized", [False, True])
def test_plan_arrays_equal_jax(scene, polarized):
    from sagecal_tpu.sky import build_hier_plan as jplan
    from sagecal_tpu_torch.sky import build_hier_plan

    src, d = scene
    if polarized:
        src = _wide_sky(S=400, polarized=True)
    pj = jplan(d.u, d.v, d.w, d.freqs, src, theta=1.5, tile_rows=64)
    pt = build_hier_plan(*_rows(d), _src(src), theta=1.5, tile_rows=64)
    assert pt.npol == pj.npol == (4 if polarized else 1)
    assert pt.used_levels == pj.used_levels and pt.stats() == pj.stats()
    for f in ("node_of_source", "node_center", "far_idx", "far_valid",
              "near_src", "near_valid", "row_perm", "row_inv"):
        np.testing.assert_array_equal(to_np(getattr(pt, f)),
                                      np.asarray(getattr(pj, f)), f)


@pytest.mark.parametrize("npol", [1, 4])
def test_moments_and_far_field_tile_match_jax(scene, npol):
    from sagecal_tpu.sky import build_hier_plan as jplan
    from sagecal_tpu.sky.farfield import (
        far_field_tile as jfar, multipole_table as jtable,
        node_moments as jmom,
    )
    from sagecal_tpu_torch.interop import hier_plan_from_numpy
    from sagecal_tpu_torch.sky.farfield import (
        far_field_tile, multipole_table, node_moments,
    )

    src = _wide_sky(S=400, polarized=npol == 4)
    d = _compact_obs(nstations=12)
    pj = jplan(d.u, d.v, d.w, d.freqs, src, theta=1.5, tile_rows=64)
    pt = hier_plan_from_numpy(pj, device="cpu")
    assert pt.use_far
    for order in (3, 8):
        abc, inv, deg = multipole_table(order)
        ntile = 2 if order == 8 else 1
        for x, y in zip((abc, inv, deg), jtable(order)):
            np.testing.assert_array_equal(x, y)
        mj = jmom(src, d.freqs, pj.node_of_source, pj.node_center,
                  pj.nnodes, abc, npol=npol)
        mt = node_moments(_src(src), _t(d.freqs), pt.node_of_source,
                          pt.node_center, pt.nnodes, abc, npol=npol)
        _close(mt, mj, 1e-12)
        u, v, w, f = _rows(d)
        for t in range(ntile):
            sl = pj.row_perm[t * 64:(t + 1) * 64]
            if sl.shape[0] < 64:
                continue
            cj = jfar(d.u[sl], d.v[sl], d.w[sl], d.freqs, pj.node_center, mj,
                      pj.far_idx[t], pj.far_valid[t], abc, inv, deg)
            ix = torch.as_tensor(np.array(sl))
            ct = far_field_tile(u[ix], v[ix], w[ix], f, pt.node_center, mt,
                                pt.far_idx[t], pt.far_valid[t], abc, inv, deg)
            _close(ct, cj, 1e-12)


def test_near_field_tiles_match_jax_and_pads_are_inert(scene):
    from sagecal_tpu.sky.nearfield import near_field_tiles as jnear
    from sagecal_tpu_torch.sky.nearfield import (
        gather_near_batch, near_field_tiles,
    )

    src, d = scene
    rows = int(d.u.shape[0])
    R = rows // 2
    u_t, v_t, w_t = (np.asarray(x)[:2 * R].reshape(2, R)
                     for x in (d.u, d.v, d.w))
    rng = np.random.default_rng(5)
    near_src = rng.integers(0, 400, (2, 96))
    near_valid = (rng.uniform(size=(2, 96)) < 0.7).astype(np.float64)
    cj = jnear(jnp.asarray(u_t), jnp.asarray(v_t), jnp.asarray(w_t), d.freqs,
               src, jnp.asarray(near_src, jnp.int32), jnp.asarray(near_valid),
               0.0, 32)
    st = _src(src)
    ct = near_field_tiles(_t(u_t), _t(v_t), _t(w_t), _t(d.freqs), st,
                          _t(near_src), _t(near_valid), 0.0, 32)
    _close(ct, cj, 1e-12)
    # an all-invalid gather contributes exactly zero; pad ids do not matter
    zero = near_field_tiles(_t(u_t[:1]), _t(v_t[:1]), _t(w_t[:1]),
                            _t(d.freqs), st, torch.zeros((1, 32), dtype=torch.long),
                            torch.zeros((1, 32), dtype=torch.float64))
    assert bool((zero == 0).all())
    ids = torch.arange(16)
    a = near_field_tiles(_t(u_t[:1]), _t(v_t[:1]), _t(w_t[:1]), _t(d.freqs),
                         st, torch.cat([ids, torch.zeros(16, dtype=torch.long)])[None],
                         torch.cat([torch.ones(16), torch.zeros(16)]).double()[None],
                         0.0, 16)
    b = near_field_tiles(_t(u_t[:1]), _t(v_t[:1]), _t(w_t[:1]), _t(d.freqs),
                         st, torch.cat([ids, torch.full((48,), 63)])[None],
                         torch.cat([torch.ones(16), torch.zeros(48)]).double()[None],
                         0.0, 16)
    assert torch.equal(a, b)
    g = gather_near_batch(st, torch.cat([ids, torch.full((48,), 63)])[None],
                          torch.cat([torch.ones(16), torch.zeros(48)])[None])
    assert bool((g.sI0[0, 16:] == 0).all())
    assert bool((g.shapelet_idx[0, 16:] == -1).all())


@pytest.mark.parametrize("polarized,order,fdelta", [
    (False, 8, 0.0), (True, 6, 0.0), (False, 4, 2e5)])
def test_predict_hier_matches_jax(polarized, order, fdelta):
    from sagecal_tpu.sky import predict_coherencies_hier as jhier
    from sagecal_tpu_torch.sky import predict_coherencies_hier

    src = _wide_sky(S=400, polarized=polarized)
    d = _compact_obs(nstations=12, nchan=2)
    cj = jhier(d.u, d.v, d.w, d.freqs, src, order=order, theta=1.5,
               tile_rows=64, fdelta=fdelta)
    ct, plan = predict_coherencies_hier(*_rows(d), _src(src), order=order,
                                        theta=1.5, tile_rows=64,
                                        fdelta=fdelta, return_plan=True)
    assert plan.use_far and plan.use_near
    _close(ct, cj, 1e-12)
    # the plan is reusable: a second call with it gives the same bits
    again = predict_coherencies_hier(*_rows(d), _src(src), order=order,
                                     fdelta=fdelta, plan=plan)
    assert torch.equal(again, ct)


def test_theta_nonpositive_equals_the_exact_predict(scene):
    from sagecal_tpu_torch.ops.rime import predict_coherencies
    from sagecal_tpu_torch.sky import predict_coherencies_hier

    src, d = scene
    st = _src(src)
    coh, plan = predict_coherencies_hier(*_rows(d), st, theta=0.0,
                                         return_plan=True)
    assert not plan.use_far
    exact = predict_coherencies(*_rows(d), st, 0.0, 32)
    _close(coh, exact, 1e-12)
    _close(coh, _exact(d, src), 1e-12)


def test_flux_gradients_match_jax_and_the_exact_gradient(scene):
    from sagecal_tpu.sky import build_hier_plan as jplan
    from sagecal_tpu.sky import predict_coherencies_hier as jhier
    from sagecal_tpu_torch.ops.rime import predict_coherencies
    from sagecal_tpu_torch.sky import build_hier_plan, predict_coherencies_hier

    src, d = scene
    pj = jplan(d.u, d.v, d.w, d.freqs, src, theta=1.5)
    target = _exact(d, src) * 1.02

    def jloss(flux):
        coh = jhier(d.u, d.v, d.w, d.freqs, src.replace(sI0=flux), order=6,
                    theta=1.5, plan=pj)
        return jnp.sum(jnp.abs(coh - jnp.asarray(target)) ** 2)

    gj = np.asarray(jax.grad(jloss)(src.sI0))
    st = _src(src)
    rows = _rows(d)
    plan = build_hier_plan(*rows, st, theta=1.5)
    tt = _t(target)

    def grad(predict):
        flux = st.sI0.clone().requires_grad_(True)
        coh = predict(st.replace(sI0=flux))
        (g,) = torch.autograd.grad(((coh - tt).abs() ** 2).sum(), flux)
        return g.numpy()

    gh = grad(lambda s: predict_coherencies_hier(*rows, s, order=6,
                                                 plan=plan))
    ge = grad(lambda s: predict_coherencies(*rows, s, 0.0, 32))
    _close(gh, gj, 1e-10)
    assert np.linalg.norm(gh - ge) / np.linalg.norm(ge) <= 1e-3


def test_sampled_error_estimate_matches_jax(scene):
    from sagecal_tpu.sky import (
        predict_coherencies_hier as jhier, sampled_error_estimate as jest,
    )
    from sagecal_tpu_torch.sky import (
        apriori_rel_bound, predict_coherencies_hier, sampled_error_estimate,
    )

    src, d = scene
    cj = jhier(d.u, d.v, d.w, d.freqs, src, order=8, theta=1.5)
    ct = predict_coherencies_hier(*_rows(d), _src(src), order=8, theta=1.5)
    for seed, ns in ((0, 32), (7, 5), (3, 10 ** 6)):
        ej = jest(d.u, d.v, d.w, d.freqs, src, cj, nsample=ns, seed=seed)
        et = sampled_error_estimate(*_rows(d), _src(src), ct, nsample=ns,
                                    seed=seed)
        np.testing.assert_array_equal(et["rows"], ej["rows"])
        assert et["nsample"] == ej["nsample"]
        assert abs(et["rel_err"] - ej["rel_err"]) <= 1e-10
        assert et["rel_err"] < apriori_rel_bound(8, 1.5)


def test_rejects_non_point_batches(scene):
    from sagecal_tpu_torch.sky import build_hier_plan

    src, d = scene
    st = _src(src)
    st = st.replace(stype=torch.ones_like(st.stype))
    with pytest.raises(ValueError, match="point-source"):
        build_hier_plan(*_rows(d), st)


@pytest.mark.parametrize("rel_err,bound", [
    (1e-5, 1e-4), (2e-4, 1e-4), (float("nan"), 1e-4)])
def test_check_hier_predict_matches_jax(tmp_path, rel_err, bound):
    from sagecal_tpu.obs.events import EventLog as JLog, read_events as jread
    from sagecal_tpu.obs.quality import check_hier_predict as jcheck
    from sagecal_tpu.obs.registry import (
        get_registry as jreg, set_telemetry as jset,
    )
    from sagecal_tpu_torch.obs.events import EventLog, read_events
    from sagecal_tpu_torch.obs.quality import check_hier_predict
    from sagecal_tpu_torch.obs.registry import get_registry, set_telemetry

    jset(True)
    set_telemetry(True)
    cname = "sagecal_quality_watchdog_total"
    c0 = (get_registry().get_counter(cname, verdict="degraded"),
          jreg().get_counter(cname, verdict="degraded"))

    jl, tl = JLog(str(tmp_path / "j.jsonl")), EventLog(str(tmp_path / "t.jsonl"))
    lj, lt = [], []
    vj = jcheck(jl, rel_err, bound, log=lj.append, tile=3, app="widefield")
    vt = check_hier_predict(tl, rel_err, bound, log=lt.append, tile=3,
                            app="widefield")
    jl.close(), tl.close()
    assert vt == vj and lt == lj
    ej = [(e["type"], e.get("verdict"), e.get("reasons"), e.get("tile"))
          for e in jread(str(tmp_path / "j.jsonl"))]
    et = [(e["type"], e.get("verdict"), e.get("reasons"), e.get("tile"))
          for e in read_events(str(tmp_path / "t.jsonl"))]
    assert et == ej
    try:
        name = "sagecal_hier_predict_error"
        assert get_registry().get_gauge(name) == jreg().get_gauge(name)
        nt = get_registry().get_counter(cname, verdict="degraded") - c0[0]
        nj = jreg().get_counter(cname, verdict="degraded") - c0[1]
        assert nt == nj == (0 if vj[0] == "ok" else 1)
    finally:
        jset(None)
        set_telemetry(None)
