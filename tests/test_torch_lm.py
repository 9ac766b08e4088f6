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
