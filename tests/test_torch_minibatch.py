"""Port vs JAX package: the minibatch app (``apps/minibatch.py``, the
``-N`` mode), plain and in band consensus with staleness (the command
lines, in consensus: tests/test_torch_minibatch_consensus.py).

One ``vis.h5`` (tests/test_apps.py's geometry: 7 stations, the 2-cluster
sky, 4 channels, 4 timeslots) is made by the JAX package and copied;
each package runs on its own copy.  Compared: the per-band (res_0,
res_1), the solutions file and the ``corrected`` column, within 1e-8
relative (the column also within 1e-8 of the data's largest magnitude:
a residual is a cancellation) at f64.
"""

import shutil

import h5py
import numpy as np
import pytest

from test_apps import CLUSTER, SKY, _make_dataset
from torch_port_common import free_jax_programs  # noqa: F401

TOL = 1e-8


@pytest.fixture()
def twins(tmp_path):
    """The JAX-made dataset at j.h5 and t.h5, with the sky files."""
    from sagecal_tpu.io.simulate import random_jones

    (tmp_path / "t.sky.txt").write_text(SKY)
    (tmp_path / "t.sky.txt.cluster").write_text(CLUSTER)
    jones = random_jones(2, 7, seed=5, amp=0.1, dtype=np.complex128)
    _make_dataset(tmp_path / "j.h5", ntime=4, nchan=4, jones=jones)
    # flag half of channel 0's rows, so the bands' unflagged rows differ
    # (the staleness periods are built from them)
    with h5py.File(tmp_path / "j.h5", "r+") as f:
        flag = np.asarray(f["flag"])
        flag[:, ::2, 0] = True
        f["flag"][...] = flag
    shutil.copy(tmp_path / "j.h5", tmp_path / "t.h5")
    return tmp_path


def _close(a, b, tol=TOL, atol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    err = float(np.max(np.abs(a - b)))
    assert err < tol * scale or err < atol, (err / scale, err)


def _cfgs(work, **kw):
    from sagecal_tpu.apps.config import RunConfig as JCfg
    from sagecal_tpu_torch.apps.config import RunConfig

    common = dict(sky_model=str(work / "t.sky.txt"),
                  cluster_file=str(work / "t.sky.txt.cluster"),
                  max_lbfgs=6, lbfgs_m=5, **{"solver_mode": 1, **kw})
    return (JCfg(dataset=str(work / "j.h5"),
                 out_solutions=str(work / "j.sol"), **common),
            RunConfig(dataset=str(work / "t.h5"),
                      out_solutions=str(work / "t.sol"), **common))


def _compare(work, rj, rt):
    from sagecal_tpu_torch.io import solutions as solio

    _close(np.asarray(rt), np.asarray(rj))
    mj, sj = solio.read_solutions(str(work / "j.sol"))
    mt, st = solio.read_solutions(str(work / "t.sol"))
    assert mt == mj
    _close(st, sj)
    with h5py.File(work / "j.h5", "r") as fj, h5py.File(work / "t.h5",
                                                        "r") as ft:
        scale = float(np.max(np.abs(np.asarray(fj["vis"]))))
        _close(np.asarray(ft["corrected"]), np.asarray(fj["corrected"]),
               TOL, TOL * scale)


def _run_case(twins, case):
    from sagecal_tpu.apps.minibatch import run_minibatch as jrun
    from sagecal_tpu_torch.apps.minibatch import run_minibatch

    kw = dict(epochs=1, minibatches=2, bands=2)
    if case == "stale_robust":
        kw.update(bands=4, admm_iters=2, npoly=2, poly_type=0, admm_rho=2.0,
                  solver_mode=2, consensus_staleness=1,
                  consensus_staleness_discount=0.5)
    jcfg, tcfg = _cfgs(twins, **kw)
    quiet = lambda *a: None  # noqa: E731
    rj = jrun(jcfg, log=quiet)
    rt = run_minibatch(tcfg, log=quiet, device="cpu")
    assert len(rt) == kw["bands"]
    for r0, r1 in rt:
        assert r1 < r0
    _compare(twins, rj, rt)


@pytest.mark.parametrize("case", ["plain", "stale_robust"])
def test_minibatch_matches_jax(twins, case):
    """-w 2 without consensus; -w 4 -A 2 in consensus with
    Student's-t (-j 2) and --consensus-staleness 1 at discount 0.5: band
    0 has half the unflagged rows of the others, so they refresh every
    other round."""
    _run_case(twins, case)
