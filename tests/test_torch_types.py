"""Port vs JAX package: data model (core/types.py, core/baselines.py) and
point-source coherency prediction (ops/rime.py), on the CPU.

Tolerance: 1e-12 at f64.  Both packages evaluate the same expressions
in f64; they differ only in summation order and in how gains reach the
rows (one-hot matmul in JAX, index gather here), which moves results by
a few ulps.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torch_port_common import to_np

TOL = 1e-12


def _rand_complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_params_jones_roundtrip_matches_jax():
    from sagecal_tpu.core import types as jt
    from sagecal_tpu_torch.core import types as tt

    p = np.random.default_rng(0).standard_normal((3, 2, 8 * 5))
    jj = np.array(jt.params_to_jones(jnp.asarray(p)))
    tj = to_np(tt.params_to_jones(torch.from_numpy(p)))
    np.testing.assert_array_equal(tj, jj)
    np.testing.assert_array_equal(
        to_np(tt.jones_to_params(torch.from_numpy(jj))), p)
    np.testing.assert_array_equal(
        to_np(tt.identity_jones(4, torch.complex128)),
        np.asarray(jt.identity_jones(4, jnp.complex128)))


@pytest.mark.parametrize("chunked", [False, True], ids=["plain", "hybrid"])
def test_corrupt_flat_matches_jax(chunked):
    from sagecal_tpu.core import types as jt
    from sagecal_tpu_torch.core import types as tt

    rng = np.random.default_rng(1)
    N, F, rows, nc = 6, 2, 40, 3
    jones = _rand_complex(rng, (nc, N, 2, 2) if chunked else (N, 2, 2))
    coh = _rand_complex(rng, (F, 4, rows))
    ant_p = rng.integers(0, N - 1, rows)
    ant_q = ant_p + rng.integers(1, N - ant_p)
    cmap = rng.integers(0, nc, rows) if chunked else None
    want = np.asarray(jt.corrupt_flat(
        jnp.asarray(jones), jnp.asarray(coh), jnp.asarray(ant_p),
        jnp.asarray(ant_q), None if cmap is None else jnp.asarray(cmap)))
    got = to_np(tt.corrupt_flat(
        torch.from_numpy(jones), torch.from_numpy(coh), torch.from_numpy(ant_p),
        torch.from_numpy(ant_q), None if cmap is None else torch.from_numpy(cmap)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    np.testing.assert_array_equal(
        to_np(tt.reals_of_flat(torch.from_numpy(coh))),
        np.asarray(jt.reals_of_flat(jnp.asarray(coh))))


def test_baselines_match_jax():
    from sagecal_tpu.core import baselines as jb
    from sagecal_tpu_torch.core import baselines as tb

    for a, b in zip(tb.tile_baselines(7, 3), jb.tile_baselines(7, 3)):
        np.testing.assert_array_equal(a, b)
    assert tb.count_baselines(62) == jb.count_baselines(62) == 1891


def _sources(rng, S):
    ll = rng.uniform(-0.05, 0.05, S)
    mm = rng.uniform(-0.05, 0.05, S)
    return ll, mm, rng.uniform(0.5, 3.0, S)


def test_predict_coherencies_matches_jax():
    """Point sources with spectra and frequency smearing, more sources
    than one source chunk (32)."""
    from sagecal_tpu.io.simulate import make_visdata as jmake
    from sagecal_tpu.ops import rime as jr
    from sagecal_tpu_torch.ops import rime as tr

    rng = np.random.default_rng(2)
    S = 40
    ll, mm, flux = _sources(rng, S)
    si = rng.uniform(-1.0, 1.0, S)
    si[::5] = 0.0
    flux[::7] *= -1.0
    jsrc = jr.point_source_batch(ll, mm, flux, dtype=jnp.float64)
    jsrc = jsrc.replace(spec_idx=jnp.asarray(si),
                        spec_idx1=jnp.asarray(0.3 * si))
    tsrc = tr.point_source_batch(ll, mm, flux, dtype=torch.float64,
                                 device="cpu")
    tsrc.spec_idx = torch.from_numpy(si)
    tsrc.spec_idx1 = torch.from_numpy(0.3 * si)
    data = jmake(nstations=6, tilesz=3, nchan=3, dtype=np.float64, seed=4)
    uvwf = [np.array(getattr(data, k)) for k in ("u", "v", "w", "freqs")]
    want = np.asarray(jr.predict_coherencies(
        *map(jnp.asarray, uvwf), jsrc, fdelta=180e3))
    got = to_np(tr.predict_coherencies(
        *map(torch.from_numpy, uvwf), tsrc, fdelta=180e3))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_extended_sources_refuse_not_silently_point():
    from sagecal_tpu_torch.ops import rime as tr

    src = tr.point_source_batch([0.0, 0.01], [0.0, 0.0], [1.0, 1.0],
                                dtype=torch.float64, device="cpu")
    src.stype = torch.tensor([tr.ST_POINT, tr.ST_GAUSSIAN], dtype=torch.int32)
    u = torch.zeros(3, dtype=torch.float64)
    f = torch.tensor([150e6], dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.predict_coherencies(u, u, u, f, src)


@pytest.mark.parametrize("sizes", [[1, 1, 1], [1, 9, 1]],
                         ids=["batched", "per-cluster"])
def test_build_cluster_data_matches_jax(sizes):
    """Both branches: clusters padded and predicted as one batch, and
    one predict per cluster when padding would waste > 4x."""
    from sagecal_tpu.io.simulate import make_visdata as jmake
    from sagecal_tpu.ops.rime import point_source_batch as jpsb
    from sagecal_tpu.solvers.sage import build_cluster_data as jbuild
    from sagecal_tpu_torch.interop import tile_from_numpy
    from sagecal_tpu_torch.ops.rime import point_source_batch as tpsb
    from sagecal_tpu_torch.solvers.sage import build_cluster_data as tbuild
    from torch_port_common import tile_arrays

    rng = np.random.default_rng(5)
    srcs = [_sources(rng, s) for s in sizes]
    data = jmake(nstations=5, tilesz=4, nchan=2, dtype=np.float64, seed=6)
    jc = [jpsb(*s, dtype=jnp.float64) for s in srcs]
    want = jbuild(data, jc, [1, 2, 1])
    arrays = tile_arrays(data, want, np.zeros((3, 2, 40)))
    tdata, _, _ = tile_from_numpy(arrays, device="cpu")
    got = tbuild(tdata, [tpsb(*s, dtype=torch.float64, device="cpu")
                         for s in srcs], [1, 2, 1])
    w = np.asarray(want.coh)
    np.testing.assert_allclose(to_np(got.coh), w, rtol=0,
                               atol=TOL * np.abs(w).max())
    np.testing.assert_array_equal(to_np(got.chunk_map),
                                  np.asarray(want.chunk_map))
    np.testing.assert_array_equal(to_np(got.nchunk), np.asarray(want.nchunk))
