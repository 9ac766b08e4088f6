"""Port vs JAX package: per-cluster solvers (solvers/lm.py, solvers/robust.py)
on the CPU, at f64 on the 2-cluster ``entry()`` tile.

Tolerance: 1e-8 relative (to the largest parameter / cost).  Both sides
run the same LM iterations in f64; the port builds the per-row Jacobian
in closed form where JAX differentiates with ``jacfwd``, and sums in
another order, so iterates differ by rounding only (~1e-13 measured);
1e-8 leaves room for a few damping decisions made on ~1e-15 gain-ratio
differences.  OS-LM gets the same row permutation on both sides.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_common import jax_entry_tile, to_np

TOL = 1e-8


def _close(got, want):
    got, want = to_np(got), np.asarray(want)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


def _problem(nchunks):
    """Cluster 0 of the f64 entry tile against the full visibilities."""
    from sagecal_tpu_torch.interop import tile_from_numpy

    data, cdata, p0, arrays = jax_entry_tile(np.float64)
    if nchunks != [1, 1]:
        from sagecal_tpu.solvers.sage import build_cluster_data
        from sagecal_tpu.ops.rime import point_source_batch

        clusters = [
            point_source_batch([0.0], [0.0], [2.0], dtype=jnp.float64),
            point_source_batch([0.02], [-0.01], [1.0], dtype=jnp.float64),
        ]
        cdata = build_cluster_data(data, clusters, nchunks)
        arrays.update(coh=np.array(cdata.coh),
                      chunk_map=np.array(cdata.chunk_map),
                      nchunk=np.array(cdata.nchunk))
    p0k = np.repeat(np.array(p0[0]), nchunks[0], axis=0)
    arrays["p0"] = p0k[None]
    td, tc, tp = tile_from_numpy(arrays, device="cpu")
    jargs = (data.vis, cdata.coh[0], data.mask, data.ant_p, data.ant_q,
             cdata.chunk_map[0], jnp.asarray(p0k))
    targs = (td.vis, tc.coh[0], td.mask, td.ant_p, td.ant_q, tc.chunk_map[0],
             tp[0])
    return jargs, targs


@pytest.mark.parametrize("nchunks", [[1, 1], [2, 1]], ids=["nc1", "nc2"])
def test_lm_solve_matches_jax(nchunks):
    from sagecal_tpu.solvers.lm import LMConfig as JCfg, lm_solve as jlm
    from sagecal_tpu_torch.solvers.lm import LMConfig, lm_solve

    jargs, targs = _problem(nchunks)
    rj = jlm(*jargs, JCfg(itmax=6))
    rt = lm_solve(*targs, LMConfig(itmax=6))
    _close(rt.p, rj.p)
    _close(rt.cost0, rj.cost0)
    _close(rt.cost, rj.cost)
    assert rt.iterations == int(rj.iterations)


def test_lm_solve_dynamic_itmax_matches_jax():
    from sagecal_tpu.solvers.lm import LMConfig as JCfg, lm_solve as jlm
    from sagecal_tpu_torch.solvers.lm import LMConfig, lm_solve

    jargs, targs = _problem([1, 1])
    rj = jlm(*jargs, JCfg(itmax=6), itmax_dynamic=jnp.asarray(2))
    rt = lm_solve(*targs, LMConfig(itmax=6), itmax_dynamic=2)
    assert rt.iterations == int(rj.iterations) == 2
    _close(rt.p, rj.p)


def test_os_lm_solve_same_perm_matches_jax():
    from sagecal_tpu.solvers.lm import LMConfig as JCfg, os_lm_solve as jos
    from sagecal_tpu_torch.solvers.lm import LMConfig, os_lm_solve

    jargs, targs = _problem([1, 1])
    key = jax.random.PRNGKey(11)
    rows = jargs[0].shape[-1]
    perm = np.array(jax.random.permutation(key, rows))
    rj = jos(*jargs, JCfg(itmax=6), nsubsets=2, key=key)
    rt = os_lm_solve(*targs, LMConfig(itmax=6), nsubsets=2, perm=perm)
    _close(rt.p, rj.p)
    _close(rt.cost0, rj.cost0)
    _close(rt.cost, rj.cost)


def test_os_lm_solve_draws_perm_from_generator():
    from sagecal_tpu_torch.solvers.lm import LMConfig, os_lm_solve

    _, targs = _problem([1, 1])
    runs = [os_lm_solve(*targs, LMConfig(itmax=4), nsubsets=2,
                        generator=torch.Generator().manual_seed(3)).p
            for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


def test_robust_lm_solve_matches_jax():
    from sagecal_tpu.solvers.lm import LMConfig as JCfg
    from sagecal_tpu.solvers.robust import robust_lm_solve as jrob
    from sagecal_tpu_torch.solvers.lm import LMConfig
    from sagecal_tpu_torch.solvers.robust import robust_lm_solve

    jargs, targs = _problem([1, 1])
    rj, nuj = jrob(*jargs, nu0=2.0, em_iters=2, config=JCfg(itmax=5))
    rt, nut = robust_lm_solve(*targs, nu0=2.0, em_iters=2,
                              config=LMConfig(itmax=5))
    _close(rt.p, rj.p)
    _close(rt.cost, rj.cost)
    assert float(nut) == float(nuj)


def test_nu_updates_match_jax():
    from sagecal_tpu.solvers import robust as jr
    from sagecal_tpu_torch.solvers import robust as tr

    rng = np.random.default_rng(3)
    ed = rng.standard_t(4.0, (2, 8, 50))
    mask = (rng.random((2, 1, 50)) > 0.2).astype(np.float64)
    for m in (None, mask):
        sw_j, nu_j = jr.update_w_and_nu(
            jnp.asarray(ed), jnp.asarray(3.0), mask=None if m is None
            else jnp.asarray(m))
        sw_t, nu_t = tr.update_w_and_nu(
            torch.from_numpy(ed), torch.tensor(3.0, dtype=torch.float64),
            mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(to_np(sw_t), np.asarray(sw_j), rtol=1e-12)
        assert float(nu_t) == float(nu_j)
    for lsw in (-1.3, -2.0, -4.5):
        nu_old = torch.tensor(5.0, dtype=torch.float64)
        assert float(tr.update_nu_aecm(lsw, nu_old)) == pytest.approx(
            float(jr.update_nu_aecm(jnp.asarray(lsw), jnp.asarray(5.0))),
            abs=1e-12)


# ---------------------------------------- fixed-order sums (core/segment)


def _index_add_normal_eq(p_all, coh, vis, mask, ant_p, ant_q, chunk_map,
                         nchunk):
    """The LM assembly with float ``index_add_`` scatters: the reference
    the fixed-order sums replace."""
    from sagecal_tpu_torch.solvers.lm import _residual_flat, _row_jacobians

    N = p_all.shape[-1] // 8
    F, rows = vis.shape[-3], ant_p.shape[0]
    e = _residual_flat(p_all, coh, vis, mask, ant_p, ant_q, chunk_map, None)
    cost = torch.zeros(nchunk, dtype=e.dtype).index_add_(
        0, chunk_map, (e * e).sum(dim=(0, 1)))
    pblk = p_all.reshape(nchunk * N, 8)
    Jp, Jq = _row_jacobians(pblk[chunk_map * N + ant_p],
                            pblk[chunk_map * N + ant_q],
                            coh.permute(2, 0, 1).reshape(rows, F, 2, 2))
    w = mask.transpose(0, 1).repeat_interleave(8, dim=1)[..., None]
    Jp, Jq = Jp * w, Jq * w
    erow = e.permute(2, 0, 1).reshape(rows, F * 8)
    JTJ = torch.zeros((nchunk * N * N, 8, 8), dtype=e.dtype)
    base = chunk_map * N * N
    JTJ.index_add_(0, base + ant_p * N + ant_p, Jp.mT @ Jp)
    JTJ.index_add_(0, base + ant_p * N + ant_q, Jp.mT @ Jq)
    JTJ.index_add_(0, base + ant_q * N + ant_p, Jq.mT @ Jp)
    JTJ.index_add_(0, base + ant_q * N + ant_q, Jq.mT @ Jq)
    JTe = torch.zeros((nchunk * N, 8), dtype=e.dtype)
    JTe.index_add_(0, chunk_map * N + ant_p, torch.einsum("rki,rk->ri", Jp, erow))
    JTe.index_add_(0, chunk_map * N + ant_q, torch.einsum("rki,rk->ri", Jq, erow))
    JTJ = JTJ.reshape(nchunk, N, N, 8, 8).permute(0, 1, 3, 2, 4)
    return JTJ.reshape(nchunk, 8 * N, 8 * N), JTe.reshape(nchunk, 8 * N), cost


@pytest.mark.parametrize("nchunks", [[1, 1], [2, 1]], ids=["nc1", "nc2"])
def test_fixed_order_assembly_matches_index_add(nchunks):
    """At f64 the segment sums give the index_add_ assembly to 1e-12."""
    from sagecal_tpu_torch.solvers.lm import NormalEqPlan, _assemble_normal_eq

    _, targs = _problem(nchunks)
    vis, coh, mask, ant_p, ant_q, cmap, p0 = targs
    p = p0 + 0.05 * torch.from_numpy(
        np.random.default_rng(1).standard_normal(tuple(p0.shape)))
    plan = NormalEqPlan(ant_p, ant_q, cmap, p.shape[0], p.shape[-1] // 8)
    got = _assemble_normal_eq(p, coh, vis, mask, ant_p, ant_q, cmap, plan,
                              None)
    want = _index_add_normal_eq(p, coh, vis, mask, ant_p, ant_q, cmap,
                                p.shape[0])
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())


def test_segment_plan_sums_in_item_order():
    """Per destination, the sum of its items; empty destinations get 0;
    the same bits on every call."""
    from sagecal_tpu_torch.core.segment import SegmentPlan

    rng = np.random.default_rng(4)
    dest = torch.from_numpy(rng.integers(0, 7, 300))
    dest[dest == 5] = 6  # destination 5 gets no item
    vals = torch.from_numpy(rng.standard_normal((300, 3, 2)))
    plan = SegmentPlan(dest, 9)
    got = plan.sum(vals)
    want = torch.zeros((9, 3, 2), dtype=vals.dtype).index_add_(0, dest, vals)
    assert got.shape == (9, 3, 2)
    assert float((got - want).abs().max()) <= 1e-12
    assert torch.equal(got[5], torch.zeros(3, 2, dtype=vals.dtype))
    assert torch.equal(got, plan.sum(vals))
    with pytest.raises(ValueError):
        plan.sum(vals[:10])


def test_gather_rows_backward_is_index_select_backward():
    from sagecal_tpu_torch.core.segment import gather_rows

    rng = np.random.default_rng(5)
    tab = torch.from_numpy(rng.standard_normal((6, 4))
                           + 1j * rng.standard_normal((6, 4)))
    idx = torch.from_numpy(rng.integers(0, 6, 40))
    g = torch.from_numpy(rng.standard_normal((40, 4))
                         + 1j * rng.standard_normal((40, 4)))
    a = tab.clone().requires_grad_(True)
    b = tab.clone().requires_grad_(True)
    out = gather_rows(a, idx)
    assert torch.equal(out, tab.index_select(0, idx))
    (ga,) = torch.autograd.grad(out, a, g)
    (gb,) = torch.autograd.grad(b.index_select(0, idx), b, g)
    assert float((ga - gb).abs().max()) <= 1e-12
