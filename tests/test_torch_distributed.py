"""Port vs JAX package: the multi-band consensus-ADMM app
(``apps/distributed.py``, the ``-f`` mode).

The band datasets are tests/test_distributed.py's (7 stations, the
2-cluster sky, one channel, gains linear in frequency over 130-170
MHz), made by the JAX package and copied, so each package runs on its
own copy of the same files.  The JAX package shards over
``min(#devices, Nf)`` of the conftest's 8 CPU devices; the port's
``nshards`` is set to the same count.  Compared: the global-Z file, the
per-band solution files, every band's ``corrected`` column and the
returned (dual, primal) traces.  Bars: 1e-8 relative (of the largest
magnitude) at f64, the traces also 1e-12 absolute and the residual
columns also 1e-8 of the data's largest magnitude; at f32, where the
port's residuals go through the plain version of kernel #1 and the JAX
package's through XLA, 5e-3 (tests/test_rime_kernel.py:250-254).
"""

import shutil

import h5py
import jax
import numpy as np
import pytest

from test_distributed import CLUSTER, _make_bands
from torch_port_common import free_jax_programs  # noqa: F401

TOL = 1e-8
F32_TOL = 5e-3
BASE = dict(tilesz=2, max_emiter=1, max_iter=4, npoly=2, admm_iters=3,
            admm_rho=10.0, solver_mode=1)


def _close(a, b, tol, atol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    err = float(np.max(np.abs(a - b)))
    assert err < tol * scale or err < atol, (err / scale, err)


def _twins(tmp_path, make):
    """``make(dir)`` writes the bands and sky into ``dir``; returns the
    JAX directory and the port's copy."""
    jdir = tmp_path / "j"
    jdir.mkdir()
    make(jdir)
    tdir = tmp_path / "t"
    shutil.copytree(jdir, tdir)
    return jdir, tdir


def _cfgs(jdir, tdir, cluster_file=None, **kw):
    from sagecal_tpu.apps.config import RunConfig as JCfg
    from sagecal_tpu_torch.apps.config import RunConfig

    out = []
    for d, cls in ((jdir, JCfg), (tdir, RunConfig)):
        sky = d / "t.sky.txt"
        out.append(cls(dataset=str(d / "band*.h5"), sky_model=str(sky),
                       cluster_file=str(cluster_file and d / cluster_file
                                        or str(sky) + ".cluster"),
                       out_solutions=str(d / "z.txt"), **{**BASE, **kw}))
    return out


def _zfile(path):
    lines = [ln.split() for ln in open(path) if not ln.startswith("#")]
    return lines[0], np.asarray([[float(x) for x in ln] for ln in lines[1:]])


def _compare_files(jdir, tdir, nbands, tol):
    from sagecal_tpu_torch.io import solutions as solio

    hj, zj = _zfile(jdir / "z.txt")
    ht, zt = _zfile(tdir / "z.txt")
    assert ht == hj
    _close(zt, zj, tol)
    for i in range(nbands):
        mj, sj = solio.read_solutions(str(jdir / f"z.txt.band{i}"))
        mt, st = solio.read_solutions(str(tdir / f"z.txt.band{i}"))
        assert mt == mj
        _close(st, sj, tol)
        with h5py.File(jdir / f"band{i}.h5", "r") as fj, \
                h5py.File(tdir / f"band{i}.h5", "r") as ft:
            # a residual of 1e-4 of the data is a cancellation: its bar
            # is relative to the data's largest magnitude
            scale = float(np.max(np.abs(np.asarray(fj["vis"]))))
            _close(np.asarray(ft["corrected"]), np.asarray(fj["corrected"]),
                   tol, tol * scale)


def _compare_traces(tt, tj, tol):
    """The (dual, primal) traces: ``tol`` relative, or 1e-12 absolute
    at f64 (a dual residual of 1e-6 is the difference of two O(1)
    consensus values, whose last digits are cancellation)."""
    assert len(tt) == len(tj)
    atol = 1e-12 if tol == TOL else 0.0
    for (dt, pt), (dj, pj) in zip(tt, tj):
        _close(dt, dj, tol, atol)
        _close(pt, pj, tol, atol)


def _run_both(jcfg, tcfg, nshards=None, **kw):
    from sagecal_tpu.apps.distributed import run_distributed as jrun
    from sagecal_tpu_torch.apps.distributed import run_distributed

    quiet = lambda *a: None  # noqa: E731
    tj = jrun(jcfg, log=quiet, **kw)
    tt = run_distributed(tcfg, log=quiet, device="cpu", nshards=nshards,
                         **kw)
    return tj, tt


@pytest.mark.parametrize("case", ["two_tiles", "hybrid_chunks",
                                  "global_residual"])
def test_distributed_matches_jax(tmp_path, devices8, case):
    """4 bands on 4 shards: two tiles (the warm carry and the
    prefetchers), a 2-chunk hybrid cluster, and -U (residuals of B_f Z)."""
    ntime = 4 if case == "two_tiles" else 2
    jdir, tdir = _twins(tmp_path,
                        lambda d: _make_bands(d, Nf=4, ntime=ntime))
    kw, cf = {}, None
    if case == "hybrid_chunks":
        for d in (jdir, tdir):
            (d / "h.cluster").write_text(CLUSTER.replace("1 1 P1", "1 2 P1"))
        cf = "h.cluster"
    if case == "global_residual":
        kw["global_residual"] = True
    jcfg, tcfg = _cfgs(jdir, tdir, cluster_file=cf)
    tj, tt = _run_both(jcfg, tcfg, nshards=4, **kw)
    assert len(tt) == (2 if case == "two_tiles" else 1)
    _compare_traces(tt, tj, TOL)
    _compare_files(jdir, tdir, 4, TOL)


def test_distributed_padding_three_bands_on_two_shards(tmp_path, devices8,
                                                       monkeypatch):
    """3 bands on 2 shards: one zero-weight pad band (the JAX mesh on 2
    devices)."""
    jdir, tdir = _twins(tmp_path, lambda d: _make_bands(d, Nf=3))
    jcfg, tcfg = _cfgs(jdir, tdir)
    two = jax.devices()[:2]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: two)
    tj, tt = _run_both(jcfg, tcfg, nshards=2)
    _compare_traces(tt, tj, TOL)
    _compare_files(jdir, tdir, 3, TOL)
