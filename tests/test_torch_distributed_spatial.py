"""Port vs JAX package: the multi-band app with spatial regularization
and the diffuse-sky constraint (``apps/distributed.py`` with
``spatial_*``, the ``-X`` / ``--spatial-diffuse-id`` mode).

The bands are tests/test_distributed.py's (7 stations, gains linear in
frequency over 130-170 MHz) with its all-shapelet diffuse cluster SDIF
added to the calibration sky, two tiles, so the second tile's diffuse
coherencies are predicted again from the first tile's diffuse model;
made by the JAX package and copied, each package on its own copy.  A
``-G`` file gives every cluster its rho and a nonzero spatial alpha.
Compared as tests/test_torch_distributed.py does (the global-Z and band
solution files, the residual columns, the traces), plus the
``.spatial.ppm`` plot byte for byte at float64.  Bars: 1e-8 at float64,
5e-3 at float32; a number of a solution file may also differ by one
unit of its last printed digit (``%e``: 1e-6 of its magnitude), where a
difference far below the bar carried the rounding across a boundary.
"""

import numpy as np
import pytest

from test_distributed import CLUSTER, SKY, _make_bands
from test_torch_distributed import (
    F32_TOL, TOL, _cfgs, _close, _compare_traces, _twins, _zfile,
)
from torch_port_common import free_jax_programs  # noqa: F401

SKY3 = SKY + "SDIF 0 1 0.0 50 45 0.0 1.0 0 0 0 0 0 0 0 1 1 0 150e6\n"
CLUSTER3 = CLUSTER + "3 1 SDIF\n"
RHO3 = "1 1 10.0 6.0\n2 1 8.0 4.0\n3 1 10.0 5.0\n"


def _close_printed(a, b, tol):
    """``tol`` relative to the largest magnitude, or one unit of the
    last digit ``%e`` printed, for every real component."""
    a = np.asarray(a).view(np.float64) if np.iscomplexobj(a) else a
    b = np.asarray(b).view(np.float64) if np.iscomplexobj(b) else b
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b)
    mag = np.maximum(np.abs(a), np.abs(b))
    unit = 10.0 ** (np.floor(np.log10(np.where(mag > 0, mag, 1.0))) - 6)
    ok = (err < tol * float(np.max(np.abs(b)))) | (err <= 1.01 * unit)
    assert ok.all(), float(np.max(err[~ok]) / np.max(np.abs(b)))


def _compare_files(jdir, tdir, nbands, tol):
    """The global-Z file, the band solution files (both printed) and the
    residual columns (full precision)."""
    import h5py

    from sagecal_tpu_torch.io import solutions as solio

    hj, zj = _zfile(jdir / "z.txt")
    ht, zt = _zfile(tdir / "z.txt")
    assert ht == hj
    _close_printed(zt, zj, tol)
    for i in range(nbands):
        mj, sj = solio.read_solutions(str(jdir / f"z.txt.band{i}"))
        mt, st = solio.read_solutions(str(tdir / f"z.txt.band{i}"))
        assert mt == mj
        _close_printed(st, sj, tol)
        with h5py.File(jdir / f"band{i}.h5", "r") as fj, \
                h5py.File(tdir / f"band{i}.h5", "r") as ft:
            scale = float(np.max(np.abs(np.asarray(fj["vis"]))))
            _close(np.asarray(ft["corrected"]), np.asarray(fj["corrected"]),
                   tol, tol * scale)


def _diffuse_bands(d, ntime=4):
    """The JAX test's bands (two tiles of 2) and the diffuse sky: SDIF's
    2 x 2 modes, the t3 sky and cluster files and the -G file."""
    _make_bands(d, Nf=4, ntime=ntime)
    (d / "t3.sky.txt").write_text(SKY3)
    (d / "t3.sky.txt.cluster").write_text(CLUSTER3)
    (d / "t3.rho").write_text(RHO3)
    rng = np.random.default_rng(11)
    lines = ["0 0 0 50 45 0", "2 0.002"]
    lines += [f"{k} {v}" for k, v in enumerate(rng.standard_normal(4))]
    (d / "SDIF.fits.modes").write_text("\n".join(lines) + "\n")


SPATIAL = dict(spatial_n0=2, spatial_beta=-1.0, spatial_mu=1e-4,
               spatial_cadence=2, spatial_basis="shapelet",
               spatial_diffuse_id=3, spatial_gamma=0.3, spatial_lam=1e-3,
               spatial_fista_maxiter=20)


def _cfg3(jdir, tdir, **kw):
    jcfg, tcfg = _cfgs(jdir, tdir, cluster_file="t3.sky.txt.cluster", **kw)
    for d, c in ((jdir, jcfg), (tdir, tcfg)):
        c.sky_model = str(d / "t3.sky.txt")
        c.rho_file = str(d / "t3.rho")
    return jcfg, tcfg


@pytest.mark.parametrize("use_f64", [True, False])
def test_distributed_spatial_diffuse_matches_jax(tmp_path, devices8, use_f64):
    """Two tiles on 4 shards, -A 3 with cadence 2 (one refit a tile),
    the diffuse re-predict on tile 2; float64 and float32."""
    jdir, tdir = _twins(tmp_path, _diffuse_bands)
    jcfg, tcfg = _cfg3(jdir, tdir, use_f64=use_f64)
    logs = {"j": [], "t": []}
    from sagecal_tpu.apps.distributed import run_distributed as jrun
    from sagecal_tpu_torch.apps.distributed import run_distributed

    tj = jrun(jcfg, log=lambda *a: logs["j"].append(" ".join(map(str, a))),
              **SPATIAL)
    tt = run_distributed(tcfg, log=lambda *a: logs["t"].append(
        " ".join(map(str, a))), device="cpu", nshards=4, **SPATIAL)
    assert len(tt) == 2
    tol = TOL if use_f64 else F32_TOL
    _compare_traces(tt, tj, tol)
    _compare_files(jdir, tdir, 4, tol)
    pick = lambda k: [s for s in logs[k] if "spatial basis" in s]  # noqa: E731
    assert pick("t") == pick("j") and pick("t")
    ppm_t = (tdir / "z.txt.spatial.ppm").read_bytes()
    assert ppm_t[:2] == b"P6"
    if use_f64:
        assert ppm_t == (jdir / "z.txt.spatial.ppm").read_bytes()


def test_distributed_spatial_repredict_reaches_tile_2(tmp_path, monkeypatch):
    """The re-predict runs once a band on tile 2 only, from the previous
    tile's diffuse model, and changes the diffuse cluster's coherencies;
    the sharmonic basis writes no plot."""
    import sagecal_tpu_torch.apps.distributed as dist

    _diffuse_bands(tmp_path)
    _, tcfg = _cfg3(tmp_path, tmp_path, admm_iters=2)
    seen = []
    real = dist.recalculate_diffuse_coherencies

    def spy(d, cdata, cid, *a):
        out = real(d, cdata, cid, *a)
        seen.append(float((out.coh[cid] - cdata.coh[cid]).abs().max()))
        return out

    monkeypatch.setattr(dist, "recalculate_diffuse_coherencies", spy)
    dist.run_distributed(tcfg, log=lambda *a: None, device="cpu",
                         **{**SPATIAL, "spatial_cadence": 1})
    assert len(seen) == 4 and min(seen) > 0.0
    assert (tmp_path / "z.txt.spatial.ppm").exists()
    (tmp_path / "z.txt.spatial.ppm").unlink()
    with pytest.raises(ValueError, match="shapelet"):
        dist.run_distributed(tcfg, log=lambda *a: None, device="cpu",
                             **{**SPATIAL, "spatial_basis": "sharmonic"})
    sp = {**SPATIAL, "spatial_basis": "sharmonic", "spatial_diffuse_id": None}
    assert len(dist.run_distributed(tcfg, log=lambda *a: None, device="cpu",
                                    **sp)) == 2
    assert not (tmp_path / "z.txt.spatial.ppm").exists()
