"""Port vs JAX package: minibatch joint LBFGS (``solvers/batchmode.py``,
``solvers/batched.py::lbfgs_minibatch_batch``) and the fullbatch app's
``-b`` (``per_channel``) path, on the CPU at f64.

Tiles: the ``__graft_entry__`` tile (8 stations, 2 clusters, 2
timeslots x 2 channels) built by the JAX package with several seeds.
Each fit runs two minibatches (a second tile, the memory carried), so
the batch-switch rules apply on the second call.  Bars: 1e-8 relative
(of the largest magnitude) on ``p`` and on every memory field, and the
same slot counters; the ``-b`` residual column within 1e-8 of its
largest magnitude, with the per-tile res and solutions as the fullbatch
tests hold them.  Both sides take the same LBFGS steps at f64; their
gradients (autodiff and autograd) differ by rounding only.
"""

import math

import numpy as np
import pytest

from torch_port_common import jax_entry_tile, to_np

TOL = 1e-8


def _close(got, want):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1e-300)


def _tiles(seeds):
    """[(JAX (data, cdata, p0), port (data, cdata, p0))] per seed."""
    from sagecal_tpu_torch.interop import tile_from_numpy

    out = []
    for s in seeds:
        data, cdata, p0, arrays = jax_entry_tile(np.float64, seed=s)
        out.append(((data, cdata, p0), tile_from_numpy(arrays, "cpu")))
    return out


def _memory_close(mt, mj, lanes=False):
    for k in ("s", "y", "rho", "running_avg", "running_avg_sq"):
        _close(getattr(mt, k), getattr(mj, k))
    for k in ("vacant", "nfilled", "niter"):
        got = getattr(mt, k)
        got = got.tolist() if lanes else got
        assert got == np.asarray(getattr(mj, k)).tolist(), k


@pytest.mark.parametrize("robust_nu", [None, 5.0], ids=["gaussian", "robust"])
def test_bfgsfit_minibatch_matches_jax(robust_nu):
    import jax.numpy as jnp

    from sagecal_tpu.solvers.batchmode import bfgsfit_minibatch as jfit
    from sagecal_tpu_torch.solvers.batchmode import bfgsfit_minibatch

    tiles = _tiles([0, 1])
    pj, pt = jnp.asarray(tiles[0][0][2]), tiles[0][1][2]
    mj = mt = None
    for (jd, jc, _), (td, tc, _) in tiles:
        pj, mj = jfit(jd, jc, pj, memory=mj, itmax=6, lbfgs_m=4,
                      robust_nu=robust_nu)
        pt, mt = bfgsfit_minibatch(td, tc, pt, memory=mt, itmax=6,
                                   lbfgs_m=4, robust_nu=robust_nu)
        _close(pt, pj)
        _memory_close(mt, mj)
    assert mt.niter > 6  # both minibatches iterated


def test_bfgsfit_minibatch_consensus_matches_jax():
    import jax.numpy as jnp
    import torch

    from sagecal_tpu.solvers.batchmode import (
        bfgsfit_minibatch_consensus as jfit,
    )
    from sagecal_tpu_torch.solvers.batchmode import (
        bfgsfit_minibatch_consensus,
    )

    tiles = _tiles([0, 2])
    p0 = np.asarray(tiles[0][0][2])
    rng = np.random.default_rng(5)
    Y = 0.01 * rng.standard_normal(p0.shape)
    BZ = p0 + 0.05 * rng.standard_normal(p0.shape)
    rho = np.array([2.0, 0.5])
    pj, pt = jnp.asarray(p0), torch.from_numpy(p0.copy())
    mj = mt = None
    for (jd, jc, _), (td, tc, _) in tiles:
        pj, mj = jfit(jd, jc, pj, jnp.asarray(Y), jnp.asarray(BZ),
                      jnp.asarray(rho), memory=mj, itmax=6, lbfgs_m=5)
        pt, mt = bfgsfit_minibatch_consensus(
            td, tc, pt, torch.from_numpy(Y), torch.from_numpy(BZ),
            torch.from_numpy(rho), memory=mt, itmax=6, lbfgs_m=5)
        _close(pt, pj)
        _memory_close(mt, mj)


def test_lbfgs_minibatch_batch_matches_jax():
    """Three lanes, two minibatches: the JAX vmap and the port's lane by
    lane fits give the same ``p`` and per-lane memories (the batched
    memory layout: every field with the lane axis)."""
    import jax
    import jax.numpy as jnp

    from sagecal_tpu.solvers.batched import lbfgs_minibatch_batch as jbatch
    from sagecal_tpu_torch.solvers.batched import (
        lbfgs_minibatch_batch, stack_lanes,
    )

    stack = lambda *xs: jnp.stack(xs)
    pj = pt = mj = mt = None
    for seeds in ([0, 1, 2], [3, 4, 5]):
        tiles = _tiles(seeds)
        jd = jax.tree_util.tree_map(stack, *[t[0][0] for t in tiles])
        jc = jax.tree_util.tree_map(stack, *[t[0][1] for t in tiles])
        td, tc, tp0 = stack_lanes([t[1] for t in tiles])
        if pj is None:
            pj, pt = jnp.asarray(np.asarray(tp0)), tp0
        pj, mj = jbatch(jd, jc, pj, memory=mj, itmax=5, lbfgs_m=4)
        pt, mt = lbfgs_minibatch_batch(td, tc, pt, memory=mt, itmax=5,
                                       lbfgs_m=4)
        _close(pt, pj)
        _memory_close(mt, mj, lanes=True)


@pytest.fixture()
def work(tmp_path):
    import shutil

    from sagecal_tpu.io.simulate import random_jones
    from test_apps import CLUSTER, SKY, _make_dataset

    (tmp_path / "t.sky.txt").write_text(SKY)
    (tmp_path / "t.sky.txt.cluster").write_text(CLUSTER)
    jones = random_jones(2, 7, seed=3, amp=0.15, dtype=np.complex128)
    _make_dataset(tmp_path / "j.h5", ntime=4, nchan=2, jones=jones)
    shutil.copy(tmp_path / "j.h5", tmp_path / "t.h5")
    return tmp_path


def test_fullbatch_per_channel_residuals_match_jax(work):
    """``-b``: each channel re-fit by a joint LBFGS from the averaged
    solution, its residuals with its own solution: the residual column
    of both apps within 1e-8 of its largest magnitude."""
    import h5py

    from sagecal_tpu.apps.config import RunConfig as JCfg
    from sagecal_tpu.apps.fullbatch import run_fullbatch as jrun
    from sagecal_tpu.io import solutions as solio
    from sagecal_tpu_torch.apps.config import RunConfig
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch

    common = dict(sky_model=str(work / "t.sky.txt"),
                  cluster_file=str(work / "t.sky.txt.cluster"), tilesz=2,
                  max_emiter=2, max_iter=4, max_lbfgs=6, lbfgs_m=5,
                  solver_mode=1, per_channel=True)
    want = jrun(JCfg(dataset=str(work / "j.h5"),
                     out_solutions=str(work / "j.sol"), **common),
                log=lambda *a: None)
    got = run_fullbatch(RunConfig(dataset=str(work / "t.h5"),
                                  out_solutions=str(work / "t.sol"),
                                  **common),
                        log=lambda *a: None, device="cpu")
    for (g0, g1), (w0, w1) in zip(got, want):
        assert math.isclose(g0, w0, rel_tol=TOL)
        assert math.isclose(g1, w1, rel_tol=TOL)
    _close(solio.read_solutions(str(work / "t.sol"))[1],
           solio.read_solutions(str(work / "j.sol"))[1])
    cols = []
    for name in ("t.h5", "j.h5"):
        with h5py.File(str(work / name), "r") as f:
            cols.append((np.asarray(f["corrected"]), np.asarray(f["vis"])))
    (gres, vis), (wres, _) = cols
    _close(gres, wres)
    # the channels were re-fit: not the averaged solution's residuals
    assert not np.allclose(gres[:, :, 0], gres[:, :, 1])
    assert np.abs(gres).max() < np.abs(vis).max()
