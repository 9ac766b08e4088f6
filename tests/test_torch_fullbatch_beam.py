"""Port vs JAX package: the fullbatch app with the beam (``-B``,
``--element-coeffs``) and the influence diagnostics (``-i``), and the
``/beam`` group of ``vis.h5`` (``io/dataset.py``, ``io/memh5.py``).

One ``vis.h5`` with a ``/beam`` group is made by the JAX package
(``simulate_dataset(with_beam=True)``: 7 stations of 24 random dipoles,
``tests/test_apps.py``'s 2-cluster sky, 2 channels, 4 timeslots) and
copied; both apps run on their own copy with ``tilesz`` 2 (two tiles).

Bars: at float64 the per-tile res_0/res_1, the solutions file and the
residual column within 1e-8 relative (of the largest magnitude for
arrays), as ``test_torch_fullbatch.py``.  ``-B 1`` (the array factor
only) is the branch where the JAX package rounds the beam to complex64
(ROADMAP.md, Queue C): its coherencies differ by ~1e-7 relative, and
the residual column by up to 3.5e-6 of its largest magnitude (res_1
2.9e-7, the solutions 7.3e-8, measured), so its bar is 1e-5.  ``-i``:
the influence column per correlation and tile as multisets (an optimal
one-to-one matching: numpy's eigenvalue order is the implementation's)
within 1e-4 of the largest |lambda|, as ``test_torch_diagnostics.py``.
"""

import math
import shutil

import numpy as np
import pytest

from test_apps import CLUSTER, SKY, _make_dataset

TOL = 1e-8
ARRAY_TOL = 1e-5
EIG_TOL = 1e-4
BASE = dict(tilesz=2, max_emiter=2, max_iter=4, max_lbfgs=6, lbfgs_m=5,
            solver_mode=1)


@pytest.fixture()
def work(tmp_path):
    from sagecal_tpu.io.simulate import random_jones

    (tmp_path / "t.sky.txt").write_text(SKY)
    (tmp_path / "t.sky.txt.cluster").write_text(CLUSTER)
    jones = random_jones(2, 7, seed=3, amp=0.15, dtype=np.complex128)
    _make_dataset(tmp_path / "j.h5", ntime=4, nchan=2, jones=jones,
                  with_beam=True)
    shutil.copy(tmp_path / "j.h5", tmp_path / "t.h5")
    return tmp_path


def _run_both(work, **kw):
    from sagecal_tpu.apps.config import RunConfig as JCfg
    from sagecal_tpu.apps.fullbatch import run_fullbatch as jrun
    from sagecal_tpu_torch.apps.config import RunConfig
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch

    common = dict(sky_model=str(work / "t.sky.txt"),
                  cluster_file=str(work / "t.sky.txt.cluster"),
                  **dict(BASE, **kw))
    want = jrun(JCfg(dataset=str(work / "j.h5"),
                     out_solutions=str(work / "j.sol"), **common),
                log=lambda *a: None)
    got = run_fullbatch(RunConfig(dataset=str(work / "t.h5"),
                                  out_solutions=str(work / "t.sol"), **common),
                        log=lambda *a: None, device="cpu")
    return got, want


def _column(path, name):
    import h5py

    with h5py.File(str(path), "r") as f:
        return np.asarray(f[name])


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


def _solutions(path):
    from sagecal_tpu.io import solutions as solio

    return solio.read_solutions(str(path))


@pytest.mark.parametrize("beam,coeffs", [(1, None), (2, None), (3, None),
                                         (2, "hba")],
                         ids=["B1", "B2", "B3", "B2-hba"])
def test_beam_modes_match_jax(work, beam, coeffs):
    tol = ARRAY_TOL if beam == 1 else TOL
    got, want = _run_both(work, beam_mode=beam, element_coeffs=coeffs)
    assert len(got) == len(want) == 2
    for (g0, g1), (w0, w1) in zip(got, want):
        assert abs(g0 - w0) <= tol * w0 and abs(g1 - w1) <= tol * w1
        assert g1 < g0
    gm, gsol = _solutions(work / "t.sol")
    wm, wsol = _solutions(work / "j.sol")
    assert gm == wm and gsol.shape == wsol.shape == (2, 2, 7, 2, 2)
    _close(gsol, wsol, tol)
    _close(_column(work / "t.h5", "corrected"),
           _column(work / "j.h5", "corrected"), tol)


def _multiset_gap(got, want) -> float:
    from scipy.optimize import linear_sum_assignment

    cost = np.abs(got[:, None] - want[None, :])
    r, c = linear_sum_assignment(cost)
    return float(cost[r, c].max())


def test_influence_matches_jax(work):
    got, want = _run_both(work, beam_mode=2, influence=True)
    for (g0, g1), (w0, w1) in zip(got, want):
        assert abs(g0 - w0) <= TOL * w0 and abs(g1 - w1) <= TOL * w1
    _close(_solutions(work / "t.sol")[1], _solutions(work / "j.sol")[1], TOL)
    gi = _column(work / "t.h5", "influence")  # (ntime, nbase, nchan, 2, 2)
    wi = _column(work / "j.h5", "influence")
    assert gi.shape == wi.shape == (4, 21, 2, 2, 2)
    assert np.isfinite(gi).all()
    for t in range(4):
        for corr in range(4):
            g = gi[t, :, 0].reshape(21, 4)[:, corr]
            w = wi[t, :, 0].reshape(21, 4)[:, corr]
            assert _multiset_gap(g, w) <= EIG_TOL * np.abs(w).max()
        # every channel carries the same values
        np.testing.assert_array_equal(gi[t, :, 0], gi[t, :, 1])
    # -i writes the influence column in place of the residuals
    import h5py

    with h5py.File(str(work / "t.h5"), "r") as f:
        assert "corrected" not in f


def test_cli_runs_beam_and_influence(work):
    """``-B 2 --element-coeffs hba -i`` through the port's command line
    (exit 0, the influence column written)."""
    import h5py

    from sagecal_tpu_torch.apps.cli import main

    rc = main(["-d", str(work / "t.h5"), "-s", str(work / "t.sky.txt"),
               "-p", str(work / "t.sol"), "-t", "2", "-e", "1", "-g", "2",
               "-l", "2", "-j", "1", "-B", "2", "--element-coeffs", "hba",
               "-i"], device="cpu")
    assert rc == 0
    with h5py.File(str(work / "t.h5"), "r") as f:
        assert np.isfinite(np.asarray(f["influence"])).all()


def test_beam_without_group_refuses(tmp_path):
    from sagecal_tpu_torch.apps.config import RunConfig
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch

    (tmp_path / "t.sky.txt").write_text(SKY)
    (tmp_path / "t.sky.txt.cluster").write_text(CLUSTER)
    _make_dataset(tmp_path / "t.h5", ntime=2, nchan=1)
    cfg = RunConfig(dataset=str(tmp_path / "t.h5"),
                    sky_model=str(tmp_path / "t.sky.txt"),
                    cluster_file=str(tmp_path / "t.sky.txt.cluster"),
                    out_solutions=str(tmp_path / "t.sol"), beam_mode=2,
                    **BASE)
    with pytest.raises(ValueError, match="no /beam group"):
        run_fullbatch(cfg, log=lambda *a: None, device="cpu")


def _geometry_arrays(geom):
    from torch_port_common import to_np

    return {k: to_np(getattr(geom, k)) for k in
            ("longitude", "latitude", "x", "y", "z", "elem_mask")}


def test_beam_group_written_alike_and_loaded_from_memfile(tmp_path):
    """The port's ``simulate_dataset(with_beam=True)`` writes the JAX
    package's ``/beam`` group (same seed, same draws), and ``load_beam``
    gives the same geometry and pointing from an h5py file and from a
    ``MemFile``, and the JAX package's from its own file."""
    import h5py

    from sagecal_tpu.io.dataset import VisDataset as JDataset
    from sagecal_tpu.io.dataset import simulate_dataset as jsim
    from sagecal_tpu_torch.io.dataset import VisDataset, simulate_dataset
    from sagecal_tpu_torch.io.memh5 import MemFile, remove

    kw = dict(nstations=6, ntime=3, nchan=2, seed=5, dec0=0.8)
    jsim(str(tmp_path / "j.h5"), with_beam=True, nelem=12, **kw)
    simulate_dataset(str(tmp_path / "t.h5"), with_beam=True, nelem=12,
                     device="cpu", **kw)
    mem = str(tmp_path / "m.h5")
    simulate_dataset(mem, with_beam=True, nelem=12, device="cpu",
                     open_file=MemFile, **kw)
    with h5py.File(str(tmp_path / "j.h5"), "r") as fj, \
            h5py.File(str(tmp_path / "t.h5"), "r") as ft:
        gj, gt = fj["beam"], ft["beam"]
        assert sorted(gj.keys()) == sorted(gt.keys())
        for k in gj.keys():
            np.testing.assert_array_equal(np.asarray(gt[k]), np.asarray(gj[k]))
        assert dict(gt.attrs) == dict(gj.attrs)
    with VisDataset(str(tmp_path / "t.h5"), "r") as ds:
        geom_h5, point_h5 = ds.load_beam(device="cpu")
    with VisDataset(mem, "r", MemFile) as ds:
        geom_mem, point_mem = ds.load_beam(device="cpu")
        assert ds.time_jd(1, 2).shape == (2,)
    jgeom, jpoint = JDataset(str(tmp_path / "j.h5"), "r").load_beam()
    assert point_h5 == point_mem == tuple(jpoint)
    assert geom_h5.bf_type == geom_mem.bf_type == jgeom.bf_type == 1
    a, b = _geometry_arrays(geom_h5), _geometry_arrays(geom_mem)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], np.asarray(getattr(jgeom, k)))
    remove(mem)
    # a dataset without the group has no beam
    simulate_dataset(mem, device="cpu", open_file=MemFile, **kw)
    with VisDataset(mem, "r", MemFile) as ds:
        assert ds.load_beam(device="cpu") is None
    remove(mem)


def test_memfile_groups_behave_like_h5py(tmp_path):
    import h5py

    from sagecal_tpu_torch.io.memh5 import MemFile, MemGroup, remove

    path = str(tmp_path / "g.h5")
    for opener in (h5py.File, MemFile):
        with opener(path, "w") as f:
            g = f.create_group("beam")
            g.create_dataset("x", data=np.arange(6.0).reshape(2, 3))
            g.attrs["bf_type"] = 2
            g.attrs["b_dec0"] = math.pi / 4
            with pytest.raises(ValueError):
                f.create_group("beam")
        with opener(path, "r") as f:
            assert "beam" in f and "x" in f["beam"] and "y" not in f["beam"]
            assert list(f["beam"].keys()) == ["x"]
            np.testing.assert_array_equal(f["beam"]["x"][1], [3.0, 4.0, 5.0])
            assert int(f["beam"].attrs["bf_type"]) == 2
            assert f["beam"].attrs.get("missing", 7) == 7
            if opener is MemFile:
                assert isinstance(f["beam"], MemGroup)
                with pytest.raises(OSError):
                    f["beam"].create_dataset("y", data=[1.0])
    remove(path)
