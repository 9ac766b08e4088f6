"""Port vs JAX package: the ``vis.h5`` reader and writer
(``io/dataset.py``), the tile prefetcher and the in-memory ``MemFile``.

The file is the JAX package's ``simulate_dataset`` (7 stations, the
2-cluster sky of tests/test_apps.py, 3 channels, 4 timeslots, one
flagged channel pattern added).  Loading is numpy up to the tensors in
both packages, so ``meta`` and every ``load_tile`` array are equal bit
for bit.  The port's ``simulate_dataset`` from the same seed gives the
same geometry bit for bit and the same visibilities within 1e-12 of
their largest magnitude (the predict sums in another order), read by
the JAX ``VisDataset``.  ``MemFile`` reads and writes what ``h5py`` does,
bit for bit.
"""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_apps import _make_dataset
from torch_port_common import VIS_FIELDS, to_np

STATIC = ("freq0", "deltaf", "deltat", "tilesz", "nbase", "nstations")


@pytest.fixture()
def h5(tmp_path):
    """A JAX-made dataset with some flags (channel 1 of every third row,
    every channel of row 5)."""
    import h5py

    from sagecal_tpu.io.simulate import random_jones

    path = tmp_path / "d.h5"
    jones = random_jones(2, 7, seed=3, amp=0.1, dtype=np.complex128)
    _make_dataset(path, ntime=4, nchan=3, jones=jones)
    with h5py.File(str(path), "r+") as f:
        flag = np.asarray(f["flag"])
        flag[:, ::3, 1] = True
        flag[:, 5, :] = True
        f["flag"][...] = flag
        f.create_dataset("corrected", data=np.asarray(f["vis"]) * 0.5)
    return path


def _same_tile(got, want):
    for k in VIS_FIELDS:
        g, w = to_np(getattr(got, k)), np.asarray(getattr(want, k))
        assert g.dtype.kind == w.dtype.kind, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    for k in STATIC:
        assert getattr(got, k) == getattr(want, k), k


LOADS = {
    "averaged": dict(average_channels=True),
    "raw": dict(average_channels=False),
    "uvcut": dict(average_channels=True, min_uvcut=60.0, max_uvcut=900.0),
    "f32": dict(average_channels=True, dtype=np.float32),
    "column": dict(average_channels=False, column="corrected"),
}


@pytest.mark.parametrize("case", list(LOADS))
def test_meta_and_load_tile_match_jax(h5, case):
    from sagecal_tpu.io.dataset import VisDataset as JDs
    from sagecal_tpu_torch.io.dataset import VisDataset

    with JDs(str(h5)) as jd, VisDataset(str(h5)) as td:
        jm, tm = jd.meta, td.meta
        for k in ("nstations", "nbase", "ntime", "nchan", "freq0", "deltaf",
                  "deltat", "ra0", "dec0", "time_jd0"):
            assert getattr(tm, k) == getattr(jm, k), k
        np.testing.assert_array_equal(tm.freqs, jm.freqs)
        np.testing.assert_array_equal(td.time_jd(1, 2), jd.time_jd(1, 2))
        assert list(td.tiles(3)) == list(jd.tiles(3))
        for t0 in (0, 3):  # a full tile and the short last one
            _same_tile(td.load_tile(t0, 3, device="cpu", **LOADS[case]),
                       jd.load_tile(t0, 3, **LOADS[case]))
    if case == "uvcut":
        with VisDataset(str(h5)) as td:
            m = td.load_tile(0, 3, device="cpu", **LOADS[case]).mask
            assert 0 < float(m.sum()) < m.numel()


def test_write_tile_matches_jax(h5, tmp_path):
    import shutil

    import h5py

    from sagecal_tpu.io.dataset import VisDataset as JDs
    from sagecal_tpu_torch.io.dataset import VisDataset

    other = tmp_path / "o.h5"
    shutil.copy(h5, other)
    rng = np.random.default_rng(2)
    block = rng.standard_normal((2 * 21, 3, 2, 2)) + 0j
    with JDs(str(h5), "r+") as jd:
        jd.write_tile(2, block, column="resid")
    with VisDataset(str(other), "r+") as td:
        td.write_tile(2, torch.from_numpy(block), column="resid")
    with h5py.File(str(h5)) as a, h5py.File(str(other)) as b:
        assert a["resid"].dtype == b["resid"].dtype
        np.testing.assert_array_equal(np.asarray(a["resid"]),
                                      np.asarray(b["resid"]))


def test_load_tile_needs_cuda_by_default(h5, monkeypatch):
    from sagecal_tpu_torch.io.dataset import VisDataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with VisDataset(str(h5)) as td:
        with pytest.raises(RuntimeError, match="CUDA"):
            td.load_tile(0, 2)


def test_prefetcher_order_cancel_and_open_failure(h5, tmp_path):
    import time

    from sagecal_tpu_torch.io.dataset import (
        _ACTIVE_PREFETCHERS, TilePrefetcher, VisDataset, cancel_active_prefetchers,
    )

    with VisDataset(str(h5)) as ds:
        t0s = list(ds.tiles(1))
        want = [ds.load_tile(t, 1, device="cpu") for t in t0s]
    spec = [dict(average_channels=True), dict(average_channels=False)]
    with TilePrefetcher(str(h5), t0s, spec, 1) as pf:
        got = list(pf)
    assert [t for t, _ in got] == t0s
    for (_, tiles), w in zip(got, want):
        assert len(tiles) == 2 and tiles[0].device.type == "cpu"
        _same_tile(tiles[0], w)

    pf2 = TilePrefetcher(str(h5), t0s, spec, 1)
    with pf2 as p:
        next(iter(p))  # consume one tile, then tear down
    t = time.time()
    pf2._thread.join(timeout=5.0)
    assert not pf2._thread.is_alive() and time.time() - t < 5.0
    assert pf2 not in _ACTIVE_PREFETCHERS

    pf3 = TilePrefetcher(str(h5), t0s, spec, 1).__enter__()
    assert pf3 in _ACTIVE_PREFETCHERS
    cancel_active_prefetchers()
    assert not pf3._thread.is_alive()
    pf3.close()

    with TilePrefetcher(str(tmp_path / "missing.h5"), [0], [dict()], 2) as pf:
        with pytest.raises(Exception):
            next(iter(pf))


def test_memfile_reads_and_writes_what_h5py_does(tmp_path):
    """The same create_dataset, loads and write_tile through h5py and
    through MemFile give the same bits."""
    import h5py

    from sagecal_tpu_torch.io import memh5
    from sagecal_tpu_torch.io.dataset import VisDataset, create_dataset

    rng = np.random.default_rng(5)
    nt, nb, nc = 4, 6, 2
    geo = dict(
        u=rng.standard_normal((nt, nb)) * 300,
        v=rng.standard_normal((nt, nb)) * 300,
        w=rng.standard_normal((nt, nb)),
        ant_p=[0, 0, 0, 1, 1, 2], ant_q=[1, 2, 3, 2, 3, 3],
        vis=rng.standard_normal((nt, nb, nc, 2, 2))
        + 1j * rng.standard_normal((nt, nb, nc, 2, 2)),
        flag=rng.uniform(size=(nt, nb, nc)) > 0.8,
        freqs=[149.9e6, 150.1e6], nstations=4, deltaf=2e5, deltat=10.0,
        ra0=0.1, dec0=0.9, time_jd0=2460000.5)
    disk = str(tmp_path / "m.h5")
    mem = str(tmp_path / "mem.h5")
    create_dataset(disk, **geo)
    create_dataset(mem, open_file=memh5.MemFile, **geo)
    block = rng.standard_normal((2 * nb, nc, 2, 2)) + 0j
    with VisDataset(disk, "r+") as a, \
            VisDataset(mem, "r+", open_file=memh5.MemFile) as b:
        assert a.meta.__dict__.keys() == b.meta.__dict__.keys()
        for k, v in a.meta.__dict__.items():
            np.testing.assert_array_equal(getattr(b.meta, k), v)
        for kw in (dict(), dict(average_channels=False),
                   dict(dtype=np.float32, min_uvcut=10.0)):
            _same_tile(b.load_tile(1, 2, device="cpu", **kw),
                       a.load_tile(1, 2, device="cpu", **kw))
        a.write_tile(2, block, column="out")
        b.write_tile(2, block, column="out")
        assert ("out" in b._f) and sorted(b._f.keys()) == sorted(a._f.keys())
    with h5py.File(disk) as f:
        for k in f.keys():
            got = memh5.MemFile(mem, "r")[k]
            assert got.dtype == f[k].dtype and got.shape == f[k].shape, k
            np.testing.assert_array_equal(np.asarray(got), np.asarray(f[k]))
        for k, v in f.attrs.items():
            got = memh5.MemFile(mem, "r").attrs[k]
            assert type(got) is type(v) and got == v, k
    ro = memh5.MemFile(mem, "r")
    with pytest.raises(OSError):
        ro["out"][0] = 0.0
    with pytest.raises(FileNotFoundError):
        memh5.MemFile(str(tmp_path / "none.h5"), "r")
    memh5.remove(mem)


def test_simulate_dataset_matches_jax(tmp_path):
    """Same seed, same file: the JAX VisDataset reads the port's."""
    import h5py

    from sagecal_tpu.io.dataset import VisDataset as JDs
    from sagecal_tpu.io.dataset import simulate_dataset as jsim
    from sagecal_tpu.io.simulate import random_jones as jrj
    from sagecal_tpu.io.skymodel import load_sky as jload
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.skymodel import load_sky
    from test_apps import CLUSTER, SKY

    (tmp_path / "s.txt").write_text(SKY)
    (tmp_path / "s.txt.cluster").write_text(CLUSTER)
    sky = str(tmp_path / "s.txt")
    dec0 = math.radians(51.0)
    jcl, _, _ = jload(sky, sky + ".cluster", 0.0, dec0, dtype=np.float64)
    tcl, _, _ = load_sky(sky, sky + ".cluster", 0.0, dec0,
                         dtype=torch.float64, device="cpu")
    jones = jrj(2, 7, seed=3, amp=0.1, dtype=np.complex128)
    kw = dict(nstations=7, ntime=3, nchan=2, noise_sigma=1e-3, seed=4,
              dec0=dec0)
    jsim(str(tmp_path / "j.h5"), clusters=jcl, jones=jones, **kw)
    simulate_dataset(str(tmp_path / "t.h5"), clusters=tcl,
                     jones=torch.from_numpy(np.array(jones)), device="cpu",
                     **kw)
    with h5py.File(str(tmp_path / "j.h5")) as a, \
            h5py.File(str(tmp_path / "t.h5")) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        assert dict(a.attrs) == dict(b.attrs)
        for k in a.keys():
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            if k == "vis":
                assert np.abs(x - y).max() <= 1e-12 * np.abs(x).max()
            else:
                np.testing.assert_array_equal(x, y, err_msg=k)
    with JDs(str(tmp_path / "t.h5")) as jd:
        tile = jd.load_tile(0, 3)
        assert np.isfinite(np.asarray(tile.vis)).all()


def test_fullbatch_imports_without_h5py():
    code = ("import sys\n"
            "sys.modules['h5py'] = None\n"
            "import sagecal_tpu_torch.apps.fullbatch\n"
            "import sagecal_tpu_torch.apps.cli\n"
            "import sagecal_tpu_torch.io.dataset as d\n"
            "from sagecal_tpu_torch.io.memh5 import MemFile\n"
            "d.create_dataset('x.h5', [[0.]], [[0.]], [[0.]], [0], [1],\n"
            "                 [[[[[1, 0], [0, 1]]]]], [[[False]]], [1.5e8],\n"
            "                 2, 1e5, open_file=MemFile)\n"
            "assert d.VisDataset('x.h5', open_file=MemFile).meta.nbase == 1\n"
            "try:\n"
            "    d.VisDataset('x.h5')\n"
            "except ImportError:\n"
            "    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"
