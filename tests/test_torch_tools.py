"""The port's offline tools and formats (``io/fits.py``,
``tools/_native.py``, ``tools/buildsky.py``, ``tools/restore.py``,
``tools/uvwriter.py``, the MeasurementSet bridge of ``io/dataset.py`` and
the CLI's ``convert``) on the CPU, held against the JAX package.

- FITS files written by either package read by the other, and the two
  writers' bytes identical;
- the native core built from the port's own source into
  ``sagecal_tpu_torch/_build/`` (not the scipy path), and
  ``label_islands``/``kmeans_weighted`` equal to the reference's;
- ``restore`` of a three-source sky (a point, a Gaussian and a shapelet
  with its ``.fits.modes`` file; the shapelet through the port's
  ``ops/shapelets.py::image_mode_matrix`` on the CPU device) within
  1e-12 of the reference's image, relative to its max abs;
- the ``buildsky`` round trip (restore the two points and the shapelet,
  then extract) giving the
  reference's sources within 1e-9 relative, and within
  tests/test_tools.py's tolerances of the injected sky;
- ``uvwriter`` on a ``MemFile`` dataset within 1e-12 of the reference's
  rewrite of the same dataset in an HDF5 file, both frames;
- ``convert`` and ``h5_to_ms`` without python-casacore raising the
  reference's RuntimeError.
"""

import math
import os

import numpy as np
import pytest
import torch

SKY = (
    "P1 1 0 0.0 45 0 0.0 2.0 0 0 0 0 0 0 0 0 0 0 150e6\n"
    "P2 1 0 12.0 45 6 0.0 1.0 0 0 0 0 0 0 0 0 0 0 150e6\n"
)
# a Gaussian and a shapelet beside tests/test_tools.py's two points
EXTRA = (
    "G3 0 59 48.0 44 57 0.0 0.6 0 0 0 0 0 0 0 0.004 0.002 0.5 150e6\n"
    "S4 1 0 9.0 44 55 0.0 1.0 0 0 0 0 0 0 0 0 0 0 150e6\n"
)


def _blank(path, n=96, noise=0.005):
    from sagecal_tpu_torch.io import fits

    wcs = fits.FitsWCS(crval1=15.0, crval2=45.0, crpix1=n / 2, crpix2=n / 2,
                       cdelt1=-3e-3, cdelt2=3e-3)
    rng = np.random.default_rng(8)
    fits.write_fits_image(
        path, (noise * rng.standard_normal((n, n))).astype(np.float32), wcs,
        extra={"CRVAL3": 150e6})
    return wcs


def _sky(tmp_path, text):
    sky = tmp_path / "s.sky"
    sky.write_text(text)
    # S4's modes beside the sky: n0 3, beta 1.5e-4 rad (~3 pixels)
    rng = np.random.default_rng(5)
    modes = 3e-5 * rng.standard_normal(9)
    modes[0] = 8e-5  # a peak near 0.4 Jy
    lines = ["# ra dec", "1 0 9.0 44 55 0", "3 1.5e-4"]
    lines += [f"{k} {float(v)!r}" for k, v in enumerate(modes)]
    (tmp_path / "S4.fits.modes").write_text("\n".join(lines) + "\n")
    return str(sky)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fits_round_trip_across_packages(tmp_path, writer):
    from sagecal_tpu.io import fits as jfits
    from sagecal_tpu_torch.io import fits

    rng = np.random.default_rng(0)
    img = rng.standard_normal((32, 48)).astype(np.float32)
    kw = dict(crval1=123.0, crval2=45.0, crpix1=24.5, crpix2=16.5,
              cdelt1=-2e-3, cdelt2=2e-3)
    paths = {}
    for name, mod in (("port", fits), ("jax", jfits)):
        paths[name] = str(tmp_path / f"{name}.fits")
        mod.write_fits_image(paths[name], img, mod.FitsWCS(**kw),
                             extra={"CRVAL3": 150e6})
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    reader = jfits if writer == "port" else fits
    back, w2, hdr = reader.read_fits_image(paths[writer])
    np.testing.assert_array_equal(back, img)
    assert (w2.crval1, w2.cdelt2, hdr["CRVAL3"]) == (123.0, 2e-3, 150e6)
    l, m = fits.FitsWCS(**kw).pixel_to_lm(np.asarray([3.0, 40.0]),
                                          np.asarray([10.0, 50.0]))
    jl, jm = jfits.FitsWCS(**kw).pixel_to_lm(np.asarray([3.0, 40.0]),
                                             np.asarray([10.0, 50.0]))
    np.testing.assert_array_equal(l, jl)
    np.testing.assert_array_equal(m, jm)


def test_native_library_built_under_build_dir():
    from sagecal_tpu_torch.tools import _native

    assert _native.backend() == "native"
    so = _native.library_path()
    assert os.path.dirname(so) == _native.BUILD_DIR
    assert os.path.basename(os.path.dirname(so)) == "_build"
    assert os.path.exists(so)
    assert _native.SOURCE == os.path.join(_native._PKG, "native",
                                          "clusterlib.cpp")


def test_label_islands_matches_reference():
    from sagecal_tpu.tools._native import label_islands as jlabel
    from sagecal_tpu_torch.tools._native import label_islands

    rng = np.random.default_rng(4)
    for mask in (rng.random((40, 56)) > 0.7, np.eye(9, dtype=bool),
                 np.zeros((5, 5), bool)):
        (lab, n), (jlab, jn) = label_islands(mask), jlabel(mask)
        assert n == jn
        np.testing.assert_array_equal(lab, jlab)


@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_weighted_matches_reference(weighted):
    from sagecal_tpu.tools._native import kmeans_weighted as jkm
    from sagecal_tpu_torch.tools._native import kmeans_weighted

    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(c, .1, 30) for c in (0, 5, 2)])
    y = np.concatenate([rng.normal(c, .1, 30) for c in (0, 5, -3)])
    w = rng.random(90) if weighted else None
    (a, c), (ja, jc) = kmeans_weighted(x, y, w, 3), jkm(x, y, w, 3)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(c, jc)


def test_restore_matches_reference_with_shapelet(tmp_path):
    from sagecal_tpu.tools.restore import restore as jrestore
    from sagecal_tpu_torch.tools.restore import restore

    blank = str(tmp_path / "blank.fits")
    _blank(blank)
    sky = _sky(tmp_path, SKY + EXTRA)
    got = restore(sky, blank, str(tmp_path / "t.fits"), device="cpu")
    want = jrestore(sky, blank, str(tmp_path / "j.fits"))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale
    # the shapelet is rendered: zero modes change the image
    zero = restore(_sky(tmp_path, SKY + EXTRA.splitlines()[0] + "\n"),
                   blank, str(tmp_path / "z.fits"), device="cpu")
    assert np.abs(got - zero).max() > 0.05


def test_buildsky_round_trip_matches_reference(tmp_path):
    from sagecal_tpu.tools.buildsky import buildsky as jbuildsky
    from sagecal_tpu.tools.restore import restore as jrestore
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.tools.buildsky import buildsky
    from sagecal_tpu_torch.tools.restore import restore

    blank = str(tmp_path / "blank.fits")
    wcs = _blank(blank)
    sky = _sky(tmp_path, SKY + EXTRA.splitlines()[1] + "\n")
    restore(sky, blank, str(tmp_path / "t.fits"), bpa=0.0, device="cpu")
    jrestore(sky, blank, str(tmp_path / "j.fits"), bpa=0.0)
    quiet = lambda *a: None
    got = buildsky(str(tmp_path / "t.fits"), str(tmp_path / "t.sky.txt"),
                   threshold_sigma=5.0, maxP=2, log=quiet)
    want = jbuildsky(str(tmp_path / "j.fits"), str(tmp_path / "j.sky.txt"),
                     threshold_sigma=5.0, maxP=2, log=quiet)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("ra", "dec", "flux"):
            assert abs(g[k] - w[k]) <= 1e-9 * abs(w[k]), (k, g, w)
    fluxes = sorted((s["flux"] for s in got), reverse=True)[:2]
    assert fluxes[0] == pytest.approx(2.0, rel=0.15)
    assert fluxes[1] == pytest.approx(1.0, rel=0.15)
    bright = max(got, key=lambda s: s["flux"])
    ra0, dec0 = (wcs.crval1 * math.pi / 180, wcs.crval2 * math.pi / 180)
    pix = 2 * 3e-3 * math.pi / 180
    assert abs(bright["dec"] - dec0) < pix
    assert abs((bright["ra"] - ra0) * math.cos(dec0)) < pix
    out = str(tmp_path / "t.sky.txt")
    clusters, _, _ = load_sky(out, out + ".cluster", ra0, dec0,
                              dtype=torch.float64, device="cpu")
    assert len(clusters) == len(got)


@pytest.mark.parametrize("body", ["moon", "earth"])
def test_uvwriter_memfile_matches_reference(tmp_path, body):
    import h5py

    from sagecal_tpu.io.dataset import simulate_dataset as jsim
    from sagecal_tpu.tools.uvwriter import rewrite_uvw as jrewrite
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.memh5 import MemFile, remove
    from sagecal_tpu_torch.tools.uvwriter import rewrite_uvw

    jp, tp = str(tmp_path / "d.h5"), str(tmp_path / "mem.h5")
    jsim(jp, nstations=5, ntime=3, nchan=1)
    simulate_dataset(tp, nstations=5, ntime=3, nchan=1, open_file=MemFile,
                     device="cpu")
    with h5py.File(jp, "r+") as f:
        f.attrs["ra0"] = 0.3
    MemFile(tp, "r+").attrs["ra0"] = 0.3
    pos = str(tmp_path / "pos.txt")
    np.savetxt(pos, np.random.default_rng(0).standard_normal((5, 3)) * 500)
    quiet = lambda *a: None
    rewrite_uvw(tp, pos, body, log=quiet, open_file=MemFile)
    jrewrite(jp, pos, body, log=quiet)
    try:
        with h5py.File(jp) as f:
            mf = MemFile(tp, "r")
            for k in ("u", "v", "w"):
                want, got = np.asarray(f[k]), np.asarray(mf[k])
                assert got.shape == want.shape == (3, 10)
                assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    finally:
        remove(tp)


def test_convert_without_casacore_gives_reference_error(tmp_path):
    from sagecal_tpu.io import dataset as jds
    from sagecal_tpu_torch.apps.cli import main
    from sagecal_tpu_torch.io import dataset

    assert dataset.have_casacore() == jds.have_casacore() is False
    msgs = []
    for fn in (lambda: main(["convert", "a.ms", str(tmp_path / "b.h5")],
                            device="cpu"),
               lambda: jds.ms_to_h5("a.ms", str(tmp_path / "b.h5"))):
        with pytest.raises(RuntimeError) as e:
            fn()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "python-casacore" in msgs[0]
    with pytest.raises(RuntimeError) as e:
        dataset.h5_to_ms(str(tmp_path / "b.h5"), "a.ms")
    with pytest.raises(RuntimeError) as je:
        jds.h5_to_ms(str(tmp_path / "b.h5"), "a.ms")
    assert str(e.value) == str(je.value)
