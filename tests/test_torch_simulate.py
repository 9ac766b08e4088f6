"""Port vs JAX package: synthetic data (io/simulate.py), sky and cluster
files (io/skymodel.py) and solution files (io/solutions.py), on the CPU.

Tolerances: arrays that numpy makes (layout, uvw, random gains, noise)
are bit-equal, since both packages draw from ``default_rng(seed)`` in the
same order; predicted visibilities agree to 1e-12 at f64 (summation
order only).  Solution files are byte-identical.
"""

import io

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torch_port_common import to_np

TOL = 1e-12


def test_make_visdata_bit_equal():
    from sagecal_tpu.io.simulate import make_visdata as jmake
    from sagecal_tpu_torch.io.simulate import make_visdata as tmake

    for dtype in (np.float32, np.float64):
        j = jmake(nstations=7, tilesz=3, nchan=2, seed=3, dtype=dtype)
        t = tmake(nstations=7, tilesz=3, nchan=2, seed=3, dtype=dtype,
                  device="cpu")
        for k in ("u", "v", "w", "ant_p", "ant_q", "vis", "mask", "freqs",
                  "time_idx"):
            a, b = to_np(getattr(t, k)), np.asarray(getattr(j, k))
            assert a.dtype.kind == b.dtype.kind, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        for k in ("freq0", "deltaf", "deltat", "tilesz", "nbase", "nstations"):
            assert getattr(t, k) == getattr(j, k), k


def test_random_jones_bit_equal():
    from sagecal_tpu.io.simulate import random_jones as jrj
    from sagecal_tpu_torch.io.simulate import random_jones as trj

    for dt in (np.complex64, np.complex128):
        np.testing.assert_array_equal(
            to_np(trj(3, 5, seed=7, amp=0.2, dtype=dt, device="cpu")),
            np.asarray(jrj(3, 5, seed=7, amp=0.2, dtype=dt)))


def test_corrupt_and_observe_matches_jax():
    from sagecal_tpu.io.simulate import corrupt_and_observe as jco
    from sagecal_tpu.io.simulate import make_visdata as jmake
    from sagecal_tpu.io.simulate import random_jones as jrj
    from sagecal_tpu.ops.rime import point_source_batch as jpsb
    from sagecal_tpu_torch.io.simulate import corrupt_and_observe as tco
    from sagecal_tpu_torch.io.simulate import make_visdata as tmake
    from sagecal_tpu_torch.io.simulate import random_jones as trj
    from sagecal_tpu_torch.ops.rime import point_source_batch as tpsb

    srcs = [([0.0, 0.01], [0.0, -0.02], [2.0, 0.5]), ([0.02], [-0.01], [1.0])]
    jd = jmake(nstations=6, tilesz=2, nchan=2, seed=1, dtype=np.float64)
    td = tmake(nstations=6, tilesz=2, nchan=2, seed=1, dtype=np.float64,
               device="cpu")
    jd = jco(jd, [jpsb(*s, dtype=jnp.float64) for s in srcs],
             jones=jrj(2, 6, seed=2, dtype=np.complex128), noise_sigma=1e-3,
             seed=5)
    td = tco(td, [tpsb(*s, dtype=torch.float64, device="cpu") for s in srcs],
             jones=trj(2, 6, seed=2, dtype=np.complex128, device="cpu"),
             noise_sigma=1e-3, seed=5)
    want = np.asarray(jd.vis)
    np.testing.assert_allclose(to_np(td.vis), want, rtol=0,
                               atol=TOL * np.abs(want).max())


SKY = """# name h m s d m s I Q U V si RM eX eY eP f0
P1 0 0 0.0 51 30 0.0 2.0 0 0 0 0.0 0 0 0 0 150e6
P2 0 1 12.0 51 10 5.0 1.2 0.1 0 0 -0.7 0 0 0 0 140e6
P3 23 59 10.0 52 2 0.0 -0.8 0 0.05 0 0.3 0 0 0 0 150e6
"""
CLUSTERS = """# id chunks sources
1 1 P1
-2 2 P2 P3
"""


def _write_sky(tmp_path):
    (tmp_path / "sky.txt").write_text(SKY)
    (tmp_path / "sky.txt.cluster").write_text(CLUSTERS)
    return str(tmp_path / "sky.txt"), str(tmp_path / "sky.txt.cluster")


def test_load_sky_matches_jax(tmp_path):
    from sagecal_tpu.io.skymodel import load_sky as jload
    from sagecal_tpu_torch.io.skymodel import load_sky as tload

    sky, clus = _write_sky(tmp_path)
    ra0, dec0 = 0.0, 0.9
    jb, jcd, jtab = jload(sky, clus, ra0, dec0, dtype=np.float64)
    tb, tcd, ttab = tload(sky, clus, ra0, dec0, dtype=torch.float64,
                          device="cpu")
    assert jtab is None and ttab is None
    assert [(c.cluster_id, c.nchunk, c.source_names, c.subtract)
            for c in tcd] == [(c.cluster_id, c.nchunk, c.source_names,
                               c.subtract) for c in jcd]
    for a, b in zip(tb, jb):
        for k in ("ll", "mm", "nn", "sI0", "sQ0", "sU0", "sV0", "f0",
                  "spec_idx", "stype", "shapelet_idx"):
            np.testing.assert_array_equal(to_np(getattr(a, k)),
                                          np.asarray(getattr(b, k)), err_msg=k)


def test_shapelet_sky_refuses(tmp_path):
    """An S-type source needs its ``.fits.modes`` file: without it
    ``load_sky`` raises instead of predicting a point."""
    from sagecal_tpu_torch.io.skymodel import load_sky

    (tmp_path / "s.txt").write_text(
        "S1 0 0 0.0 51 30 0.0 2.0 0 0 0 0.0 0 1 1 0 150e6\n")
    (tmp_path / "s.cl").write_text("1 1 S1\n")
    with pytest.raises(FileNotFoundError, match="S1.fits.modes"):
        load_sky(str(tmp_path / "s.txt"), str(tmp_path / "s.cl"), 0.0, 0.9,
                 device="cpu")


def test_solution_files_byte_identical(tmp_path):
    from sagecal_tpu.io import solutions as js
    from sagecal_tpu_torch.io import solutions as ts

    rng = np.random.default_rng(8)
    cols = [rng.standard_normal((3, 5, 2, 2)) + 1j * rng.standard_normal(
        (3, 5, 2, 2)) for _ in range(2)]
    bufs = []
    for mod in (js, ts):
        fh = io.StringIO()
        mod.write_header(fh, 150e6, 180e3, 10.0, 5, 2, 3)
        for c in cols:
            mod.append_solutions(fh, c)
        bufs.append(fh.getvalue())
    assert bufs[0] == bufs[1]
    path = tmp_path / "sol.txt"
    path.write_text(bufs[1])
    meta_t, jones_t = ts.read_solutions(str(path))
    meta_j, jones_j = js.read_solutions(str(path))
    assert meta_t == meta_j
    np.testing.assert_array_equal(jones_t, jones_j)
    np.testing.assert_allclose(jones_t, np.stack(cols), rtol=1e-6)
