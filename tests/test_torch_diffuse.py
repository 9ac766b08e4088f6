"""Port vs JAX package: the diffuse-sky re-predict under a spatial model
(``ops/diffuse.py``), mirroring tests/test_diffuse.py.

The tile, the shapelet cluster and the spatial model come from the JAX
package (its test's construction: 6 stations, one all-shapelet cluster
over a point cluster) and cross as numpy.  Bars: 1e-12 relative (of the
largest magnitude) at float64, 5e-3 at float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_diffuse
from torch_port_common import free_jax_programs, tile_arrays  # noqa: F401

TOL = 1e-12
F32_TOL = 5e-3


def _close(a, b, tol=TOL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    err = float(np.max(np.abs(a - b))) / scale
    assert err < tol, err


def _setup(nsrc=1, tilesz=1, nchan=1, dtype=np.float64, seed=2):
    """The JAX test's tile and cluster, with ``nsrc`` shapelet sources
    (different modes, fluxes and Stokes) over ``tilesz`` x ``nchan``."""
    from sagecal_tpu.io.simulate import make_visdata
    from sagecal_tpu.ops.rime import (
        ST_SHAPELET, ShapeletTable, point_source_batch, predict_coherencies,
    )
    from sagecal_tpu.solvers.sage import build_cluster_data

    if (nsrc, tilesz, nchan, dtype) == (1, 1, 1, np.float64):
        return test_diffuse.TestDiffusePredict()._diffuse_setup(seed=seed)
    n0 = 3
    rng = np.random.default_rng(seed)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    d = make_visdata(nstations=6, tilesz=tilesz, nchan=nchan, dtype=dtype)
    src = point_source_batch(0.004 * np.arange(nsrc), -0.003 * np.arange(nsrc),
                             1.0 + 0.5 * np.arange(nsrc), dtype=jdt)
    src = src.replace(
        stype=jnp.full((nsrc,), ST_SHAPELET, jnp.int32),
        shapelet_idx=jnp.arange(nsrc, dtype=jnp.int32),
        sQ0=jnp.asarray(0.2 * rng.standard_normal(nsrc), jdt),
        sU0=jnp.asarray(0.1 * rng.standard_normal(nsrc), jdt),
        sV0=jnp.asarray(0.05 * rng.standard_normal(nsrc), jdt))
    tab = ShapeletTable(
        modes=jnp.asarray(rng.standard_normal((nsrc, n0 * n0)), jdt),
        beta=jnp.asarray(1e-2 * (1.0 + 0.3 * np.arange(nsrc)), jdt),
        eX=jnp.ones((nsrc,), jdt), eY=jnp.ones((nsrc,), jdt),
        eP=jnp.zeros((nsrc,), jdt), n0max=n0)
    point = point_source_batch([0.0], [0.0], [1.0], dtype=jdt)
    cdata = build_cluster_data(d, [point, point], [1, 1], fdelta=0.0)
    coh0 = predict_coherencies(d.u, d.v, d.w, d.freqs, src, shapelets=tab)
    cdata = cdata._replace(coh=cdata.coh.at[1].set(coh0))
    return d, cdata, src, tab


def _spatial_model(N, sh_n0, seed=3, cdt=np.complex128):
    """Identity Jones on mode 0 plus a seeded perturbation of every mode."""
    G = sh_n0 * sh_n0
    rng = np.random.default_rng(seed)
    Z = 0.2 * (rng.standard_normal((2 * N, 2 * G))
               + 1j * rng.standard_normal((2 * N, 2 * G)))
    for s in range(N):
        Z[2 * s:2 * s + 2, 0:2] += np.eye(2)
    return Z.astype(cdt)


def _port(d, cdata, src, tab):
    from sagecal_tpu_torch.interop import (
        shapelets_from_numpy, sources_from_numpy, tile_from_numpy,
    )

    p0 = np.zeros((cdata.coh.shape[0], 1, 8 * d.nstations))
    td, tc, _ = tile_from_numpy(tile_arrays(d, cdata, p0), device="cpu")
    return (td, tc, sources_from_numpy(src, device="cpu"),
            shapelets_from_numpy(tab, device="cpu"))


@pytest.mark.parametrize("case", [
    dict(), dict(nsrc=2, tilesz=2, nchan=2), dict(nsrc=2, nchan=2,
                                                  dtype=np.float32)])
def test_recalculate_diffuse_coherencies_matches_jax(case):
    from sagecal_tpu.ops.diffuse import recalculate_diffuse_coherencies as jre
    from sagecal_tpu_torch.ops.diffuse import recalculate_diffuse_coherencies

    d, cdata, src, tab = _setup(**case)
    cid = cdata.coh.shape[0] - 1
    f32 = case.get("dtype") == np.float32
    Z = _spatial_model(d.nstations, 2,
                       cdt=np.complex64 if f32 else np.complex128)
    want = np.asarray(jre(d, cdata, cid, src, tab, jnp.asarray(Z), 2,
                          5e-3).coh)
    td, tc, tsrc, ttab = _port(d, cdata, src, tab)
    got = recalculate_diffuse_coherencies(td, tc, cid, tsrc, ttab,
                                          torch.from_numpy(Z), 2, 5e-3)
    assert got.coh.dtype == tc.coh.dtype
    _close(got.coh, want, F32_TOL if f32 else TOL)
    # the other clusters are untouched, and the input is not modified
    assert torch.equal(got.coh[:cid], tc.coh[:cid])
    np.testing.assert_array_equal(tc.coh.numpy(), np.asarray(cdata.coh))


def test_station_scaling_scales_coherencies():
    """The JAX test's property in the port: doubling one station's model
    scales exactly the rows touching that station."""
    from sagecal_tpu_torch.ops.diffuse import recalculate_diffuse_coherencies

    d, cdata, src, tab = _setup()
    td, tc, tsrc, ttab = _port(d, cdata, src, tab)
    N = d.nstations
    Z = np.zeros((2 * N, 8), complex)
    for s in range(N):
        Z[2 * s:2 * s + 2, 0:2] = np.eye(2)
    Z2 = Z.copy()
    Z2[0:2] *= 2.0
    a, b = (recalculate_diffuse_coherencies(
        td, tc, 0, tsrc, ttab, torch.from_numpy(z), 2, 5e-3).coh[0].numpy()
        for z in (Z, Z2))
    touches0 = (np.asarray(d.ant_p) == 0) | (np.asarray(d.ant_q) == 0)
    np.testing.assert_allclose(b[..., ~touches0], a[..., ~touches0],
                               rtol=1e-10)
    np.testing.assert_allclose(b[..., touches0], 2.0 * a[..., touches0],
                               rtol=1e-10)


def test_spatial_station_modes_layout_and_refusal():
    from sagecal_tpu.ops.diffuse import spatial_station_modes as jssm
    from sagecal_tpu_torch.ops.diffuse import (
        recalculate_diffuse_coherencies, spatial_station_modes,
    )

    Z = np.arange(6 * 8, dtype=float).reshape(6, 8) + 0j
    got = spatial_station_modes(torch.from_numpy(Z), 3, 2)
    _close(got, np.asarray(jssm(jnp.asarray(Z), 3, 2)))
    np.testing.assert_array_equal(got[1, 2].numpy(), Z[2:4, 4:6])
    # a cluster that is not all-shapelet is refused, as in the reference
    d, cdata, src, tab = _setup()
    td, tc, tsrc, ttab = _port(d, cdata, src, tab)
    tsrc = tsrc.replace(stype=torch.zeros_like(tsrc.stype))
    with pytest.raises(ValueError, match="only shapelet"):
        recalculate_diffuse_coherencies(td, tc, 0, tsrc, ttab,
                                        torch.from_numpy(Z), 2, 5e-3)
