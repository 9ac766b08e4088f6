"""Port vs JAX package: shapelet sources, from the basis to the tile.

``ops/shapelets.py`` (the Hermite basis, the UV mode vectors, one
source's contribution), ``io/skymodel.py`` (an LSM sky with an S-type
source and its ``.fits.modes`` file written to ``tmp_path``; the
cluster ADMM-rho file) and ``build_cluster_data(shapelets=...)`` with
one shapelet cluster among point clusters, each against the JAX
package on the same inputs at f64 (1e-12 of the max abs) and f32 (1e-5
of the max abs); the zero-padding case of ``tests/test_sky_shapelets.py``.
"""

import math

import numpy as np
import pytest
import torch

from torch_port_common import to_np

DEC0 = math.radians(51.0)
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _close(got, want, dtype=np.float64):
    got, want = to_np(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("n0", [1, 2, 5])
def test_basis_and_mode_vectors_match_jax(n0):
    import jax.numpy as jnp

    from sagecal_tpu.ops import shapelets as js
    from sagecal_tpu_torch.ops import shapelets as ts

    rng = np.random.default_rng(n0)
    x = rng.uniform(-4.0, 4.0, (7, 3))
    _close(ts.hermite_basis_1d(torch.from_numpy(x), n0),
           js.hermite_basis_1d(jnp.asarray(x), n0))
    u, v = rng.uniform(-3e3, 3e3, (2, 11))
    _close(ts.uv_mode_vectors(torch.from_numpy(u), torch.from_numpy(v), 1e-3,
                              n0),
           js.uv_mode_vectors(jnp.asarray(u), jnp.asarray(v), 1e-3, n0))
    for a, b in zip(ts.uv_mode_signs(n0), js.uv_mode_signs(n0)):
        np.testing.assert_array_equal(a, b)


def test_shapelet_uv_contrib_matches_jax():
    import jax.numpy as jnp

    from sagecal_tpu.ops import shapelets as js
    from sagecal_tpu_torch.ops import shapelets as ts

    rng = np.random.default_rng(3)
    modes = rng.standard_normal(16)
    u, v, w = rng.uniform(-3e3, 3e3, (3, 20))
    kw = dict(cxi=0.9, sxi=-0.2, cphi=0.99, sphi=-0.05)
    want = js.shapelet_uv_contrib(
        *map(jnp.asarray, (u, v, w)),
        js.ShapeletModel(jnp.asarray(modes), 8e-4, 4, 1.1, 0.9, 0.3), **kw)
    got = ts.shapelet_uv_contrib(
        *map(torch.from_numpy, (u, v, w)),
        ts.ShapeletModel(torch.from_numpy(modes), 8e-4, 4, 1.1, 0.9, 0.3),
        **kw)
    _close(got, want)


def _write_sky(tmp_path, n0=3, beta=4e-4, seed=3):
    """Two point clusters around one cluster of a Gaussian and an S-type
    source, its ``SSRC.fits.modes`` file and a cluster-rho file."""
    rng = np.random.default_rng(seed)
    modes = rng.standard_normal(n0 * n0)
    (tmp_path / "t.sky").write_text(
        "P1 0 0 30 51 10 0 2.0 0 0 0 0 0 0 0 0 150e6\n"
        "P2 0 1 0 51 20 0 1.0 0 0 0 -0.7 0 0 0 0 150e6\n"
        "G1 0 0 10 50 55 0 1.0 0 0 0 0 0 0.01 0.005 0.3 150e6\n"
        "SSRC 0 0 0 51 0 0 1.5 0 0 0 0 0 1.2 0.8 0.4 150e6\n")
    (tmp_path / "t.sky.cluster").write_text("1 1 P1\n2 2 G1 SSRC\n-3 1 P2\n")
    lines = ["# ra dec", "0 0 0 51 0 0", f"{n0} {beta}"]
    lines += [f"{k} {val}" for k, val in enumerate(modes)]
    (tmp_path / "SSRC.fits.modes").write_text("\n".join(lines) + "\n")
    (tmp_path / "t.rho").write_text("# id hybrid rho alpha\n2 1 5.0 0.1\n"
                                    "1 1 3.0 0.2\n-3 1 1.0 0.3\n")
    return str(tmp_path / "t.sky"), str(tmp_path / "t.sky.cluster"), modes


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_load_sky_and_build_cluster_data_match_jax(tmp_path, dtype):
    from sagecal_tpu.io.simulate import make_visdata
    from sagecal_tpu.io.skymodel import load_sky as jload
    from sagecal_tpu.solvers.sage import build_cluster_data as jbuild
    from sagecal_tpu_torch.interop import (
        shapelets_from_numpy, shapelets_to_numpy, sources_to_numpy,
        tile_from_numpy,
    )
    from sagecal_tpu_torch.io.skymodel import load_sky as tload
    from sagecal_tpu_torch.solvers.sage import build_cluster_data as tbuild
    from torch_port_common import tile_arrays

    sky, clus, modes = _write_sky(tmp_path)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jb, jcd, jtab = jload(sky, clus, 0.0, DEC0, dtype=dtype)
    tb, tcd, ttab = tload(sky, clus, 0.0, DEC0, dtype=tdt, device="cpu")
    assert ttab.n0max == jtab.n0max == 3
    back = shapelets_to_numpy(ttab)
    assert back["n0max"] == 3
    for k in ("modes", "beta", "eX", "eY", "eP"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jtab, k)),
                                      err_msg=k)
    again = shapelets_from_numpy(back, "cpu")
    assert torch.equal(again.modes, ttab.modes) and again.n0max == 3
    np.testing.assert_allclose(to_np(ttab.modes[0]), modes.astype(dtype))
    for a, b in zip(tb, jb):
        for k, x in sources_to_numpy(a).items():
            np.testing.assert_array_equal(x, np.asarray(getattr(b, k)),
                                          err_msg=k)
    assert to_np(tb[1].shapelet_idx).tolist() == [-1, 0]

    data = make_visdata(nstations=6, tilesz=3, nchan=2, dtype=dtype,
                        dec0=DEC0, seed=2)
    want = jbuild(data, jb, [c.nchunk for c in jcd], shapelets=jtab)
    arrays = tile_arrays(data, want, np.zeros((3, 1, 48), dtype))
    td, _, _ = tile_from_numpy(arrays, device="cpu")
    got = tbuild(td, tb, [c.nchunk for c in tcd], shapelets=ttab)
    _close(got.coh, want.coh, dtype)
    np.testing.assert_array_equal(to_np(got.chunk_map),
                                  np.asarray(want.chunk_map))
    np.testing.assert_array_equal(to_np(got.nchunk), np.asarray(want.nchunk))
    assert float(got.coh[1].abs().max()) > 0


def test_shapelet_refusals(tmp_path):
    """No modes file: load_sky raises; a shapelet cluster without a
    table: build_cluster_data raises, on both of its paths."""
    from sagecal_tpu_torch.io.simulate import make_visdata
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.solvers.sage import build_cluster_data

    sky, clus, _ = _write_sky(tmp_path)
    batches, _, _ = load_sky(sky, clus, 0.0, DEC0, device="cpu")
    data = make_visdata(nstations=5, tilesz=2, device="cpu")
    with pytest.raises(ValueError, match="ShapeletTable"):
        build_cluster_data(data, batches, [1, 1, 1])  # the batched path
    with pytest.raises(ValueError, match="ShapeletTable"):
        build_cluster_data(data, batches[1:2], [1])  # one cluster
    (tmp_path / "SSRC.fits.modes").unlink()
    with pytest.raises(FileNotFoundError):
        load_sky(sky, clus, 0.0, DEC0, device="cpu")


def test_read_cluster_rho_matches_jax(tmp_path):
    from sagecal_tpu.io.skymodel import (
        parse_clusters, read_cluster_rho as jrho,
    )
    from sagecal_tpu_torch.io.skymodel import read_cluster_rho as trho

    _, clus, _ = _write_sky(tmp_path)
    cdefs = parse_clusters(clus)
    for spatial in (False, True):
        want = jrho(str(tmp_path / "t.rho"), cdefs, spatial)
        got = trho(str(tmp_path / "t.rho"), cdefs, spatial)
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if spatial:
            np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], [3.0, 5.0, 1.0])


def test_shapelet_table_padding_is_exact():
    """A model padded from n0 = 2 to n0max = 3 predicts as its unpadded
    self (unused coefficients are zero), and as the JAX package does."""
    import jax.numpy as jnp

    from sagecal_tpu.ops import rime as jr
    from sagecal_tpu.io.skymodel import build_shapelet_table as jtable
    from sagecal_tpu_torch.io.simulate import make_visdata
    from sagecal_tpu_torch.io.skymodel import build_shapelet_table
    from sagecal_tpu_torch.ops.rime import (
        ST_SHAPELET, point_source_batch, predict_coherencies,
    )

    rng = np.random.default_rng(5)
    n0, beta = 2, 3e-4
    modes = rng.standard_normal(n0 * n0)
    extra = (3, 1e-3, rng.standard_normal(9), 1.0, 1.0, 0.0)
    data = make_visdata(nstations=5, tilesz=2, nchan=1, dtype=np.float64,
                        dec0=DEC0, device="cpu")
    src = point_source_batch([1e-3], [-2e-3], [1.0], dtype=torch.float64,
                             device="cpu").replace(
        stype=torch.tensor([ST_SHAPELET], dtype=torch.int32),
        shapelet_idx=torch.tensor([0], dtype=torch.int32))
    small = build_shapelet_table([(n0, beta, modes, 1.0, 1.0, 0.0)],
                                 torch.float64, "cpu")
    padded = build_shapelet_table([(n0, beta, modes, 1.0, 1.0, 0.0), extra],
                                  torch.float64, "cpu")
    uvwf = (data.u, data.v, data.w, data.freqs)
    a = predict_coherencies(*uvwf, src, shapelets=small)
    b = predict_coherencies(*uvwf, src, shapelets=padded)
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-12, atol=1e-15)
    jsrc = jr.point_source_batch([1e-3], [-2e-3], [1.0],
                                 dtype=jnp.float64).replace(
        stype=jnp.asarray([ST_SHAPELET], jnp.int32),
        shapelet_idx=jnp.asarray([0], jnp.int32))
    want = jr.predict_coherencies(
        *(jnp.asarray(to_np(x)) for x in uvwf), jsrc,
        shapelets=jtable([(n0, beta, modes, 1.0, 1.0, 0.0), extra],
                         np.float64))
    _close(b, want)
