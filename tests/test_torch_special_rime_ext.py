"""Port vs JAX package: ``ops/special.py`` and the extended-source,
time-smearing and uv-cut parts of ``ops/rime.py``.

The same numpy inputs go through both packages.  Tolerances: 1e-12 of
the max abs at f64 (the Bessel functions: 1e-12 absolute over [0, 50]),
1e-5 of the max abs at f32 (both compute in f32 and differ in rounding
and summation order only).  An f32 phase of phi radians is itself
rounded by ~phi * 6e-8, differently by XLA's fused evaluation and by
torch's, so the f32 cases put their sources within 0.008 of the phase
centre (phases below ~100 rad on this 3 km tile); at 0.05 (phases of
~500 rad) ``test_f32_phase_rounding_is_shared`` holds both packages'
f32 predicts to the same bound from the f64 one.
"""

import math

import numpy as np
import pytest
import torch

from torch_port_common import to_np

TOL = {np.float64: 1e-12, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]
IDS = ["f64", "f32"]


def test_bessel_and_sinc_match_jax():
    import jax.numpy as jnp

    from sagecal_tpu.ops import special as js
    from sagecal_tpu_torch.ops import special as ts

    x = np.concatenate([np.linspace(0.0, 50.0, 5001), -np.linspace(0, 7, 71)])
    for name in ("bessel_j0", "bessel_j1", "sinc_abs"):
        want = np.asarray(getattr(js, name)(jnp.asarray(x)))
        got = to_np(getattr(ts, name)(torch.from_numpy(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=name)
    # and the approximation itself (A&S, |error| < 5e-8)
    import scipy.special

    xs = np.linspace(0.0, 50.0, 501)
    np.testing.assert_allclose(to_np(ts.bessel_j0(torch.from_numpy(xs))),
                               scipy.special.j0(xs), atol=1e-7)
    np.testing.assert_allclose(to_np(ts.bessel_j1(torch.from_numpy(xs))),
                               scipy.special.j1(xs), atol=1e-7)


def _uvwf(dtype, nchan=2):
    from sagecal_tpu.io.simulate import make_visdata

    data = make_visdata(nstations=7, tilesz=3, nchan=nchan, dtype=dtype,
                        seed=4, dec0=0.7)
    return [np.array(getattr(data, k)) for k in ("u", "v", "w", "freqs")]


def _extended_batch(dtype, stypes, seed=0, spread=None):
    """A numpy source batch (dict) of the given types within ``spread``
    of the phase centre (module doc: 0.05 at f64, 0.008 at f32): random
    extents, position angles and projection angles, two sources with
    spectra."""
    from sagecal_tpu_torch.interop import SOURCE_FIELDS

    if spread is None:
        spread = 0.05 if dtype == np.float64 else 0.008
    rng = np.random.default_rng(seed)
    S = len(stypes)
    ll = rng.uniform(-spread, spread, S)
    mm = rng.uniform(-spread, spread, S)
    nn = np.sqrt(1.0 - ll ** 2 - mm ** 2) - 1.0
    xi, phi = rng.uniform(0, np.pi, S), rng.uniform(0, 0.05, S)
    pa = rng.uniform(0, np.pi, S)
    b = dict(ll=ll, mm=mm, nn=nn, sI0=rng.uniform(0.5, 3.0, S),
             sQ0=rng.uniform(-0.1, 0.1, S), sU0=rng.uniform(-0.1, 0.1, S),
             sV0=rng.uniform(-0.05, 0.05, S), f0=np.full(S, 140e6),
             spec_idx=np.where(np.arange(S) < 2, -0.7, 0.0),
             spec_idx1=np.where(np.arange(S) < 2, 0.1, 0.0),
             spec_idx2=np.zeros(S),
             ex_a=rng.uniform(1e-4, 6e-4, S), ex_b=rng.uniform(1e-4, 6e-4, S),
             ex_cp=np.cos(pa), ex_sp=np.sin(pa), cxi=np.cos(xi),
             sxi=np.sin(-xi), cphi=np.cos(phi), sphi=np.sin(-phi))
    out = {k: v.astype(dtype) for k, v in b.items()}
    out["stype"] = np.asarray(stypes, np.int32)
    out["shapelet_idx"] = np.where(out["stype"] == 4,
                                   np.cumsum(out["stype"] == 4) - 1,
                                   -1).astype(np.int32)
    assert set(out) == set(SOURCE_FIELDS)
    return out


def _jax_batch(b):
    import jax.numpy as jnp

    from sagecal_tpu.ops.rime import SourceBatch

    return SourceBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def _table(dtype, K=2, n0=4, seed=1):
    rng = np.random.default_rng(seed)
    return dict(modes=rng.standard_normal((K, n0 * n0)).astype(dtype),
                beta=rng.uniform(5e-4, 2e-3, K).astype(dtype),
                eX=rng.uniform(0.8, 1.2, K).astype(dtype),
                eY=rng.uniform(0.8, 1.2, K).astype(dtype),
                eP=rng.uniform(0, 1, K).astype(dtype), n0max=n0)


def _jax_table(t):
    import jax.numpy as jnp

    from sagecal_tpu.ops.rime import ShapeletTable

    return ShapeletTable(**{k: jnp.asarray(t[k]) for k in
                            ("modes", "beta", "eX", "eY", "eP")},
                         n0max=t["n0max"])


def _close(got, want, dtype):
    got, want = to_np(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


BATCHES = {
    "gaussian": [1, 1, 1],
    "disk": [2, 2],
    "ring": [3, 3],
    "mixed": [0, 1, 2, 3, 1, 0, 3],
}


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("kind", list(BATCHES))
@pytest.mark.parametrize("smear", [(0.0, 0.0), (10.0, 0.9)],
                         ids=["no-tsmear", "tsmear"])
def test_extended_coherencies_match_jax(kind, dtype, smear):
    import jax.numpy as jnp

    from sagecal_tpu.ops import rime as jr
    from sagecal_tpu_torch.interop import sources_from_numpy
    from sagecal_tpu_torch.ops import rime as tr

    tdelta, dec0 = smear
    uvwf = _uvwf(dtype)
    b = _extended_batch(dtype, BATCHES[kind])
    kw = dict(fdelta=180e3, source_chunk=2, tdelta=tdelta, dec0=dec0)
    want = jr.predict_coherencies(*map(jnp.asarray, uvwf), _jax_batch(b), **kw)
    got = tr.predict_coherencies(*map(torch.from_numpy, uvwf),
                                 sources_from_numpy(b, "cpu"), **kw)
    _close(got, want, dtype)


def test_f32_phase_rounding_is_shared():
    """Sources at 0.05 from the centre: each package's f32 predict lies
    within the f32 phase-rounding bound (4 eps max|phase| sum|flux|) of
    the f64 predict, and so within twice it of the other."""
    import jax.numpy as jnp

    from sagecal_tpu.ops import rime as jr
    from sagecal_tpu_torch.interop import sources_from_numpy
    from sagecal_tpu_torch.ops import rime as tr

    b64 = _extended_batch(np.float64, BATCHES["mixed"], spread=0.05)
    b32 = {k: v.astype(np.float32) if v.dtype == np.float64 else v
           for k, v in b64.items()}
    u, v, w, f = _uvwf(np.float64)
    truth = np.asarray(jr.predict_coherencies(
        *map(jnp.asarray, (u, v, w, f)), _jax_batch(b64), fdelta=180e3))
    uvwf = [a.astype(np.float32) for a in (u, v, w, f)]
    want = np.asarray(jr.predict_coherencies(
        *map(jnp.asarray, uvwf), _jax_batch(b32), fdelta=180e3))
    got = to_np(tr.predict_coherencies(*map(torch.from_numpy, uvwf),
                                       sources_from_numpy(b32, "cpu"),
                                       fdelta=180e3))
    phase = 2 * np.pi * f.max() * np.abs(
        u[:, None] * b64["ll"] + v[:, None] * b64["mm"]
        + w[:, None] * b64["nn"]).max()
    bound = 4 * np.finfo(np.float32).eps * phase * np.abs(b64["sI0"]).sum()
    assert phase > 300.0
    assert np.abs(got - truth).max() <= bound
    assert np.abs(want - truth).max() <= bound
    assert np.abs(got - want).max() <= 2 * bound


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_time_smear_factor_matches_jax(dtype):
    import jax.numpy as jnp

    from sagecal_tpu.ops.rime import time_smear_factor as jt
    from sagecal_tpu_torch.ops.rime import time_smear_factor as tt

    u, v, w, f = _uvwf(dtype)
    b = _extended_batch(dtype, [0, 0, 0, 0])
    args = (b["ll"], b["mm"], 0.6, 30.0)
    want = jt(*map(jnp.asarray, args[:2]), *args[2:],
              *map(jnp.asarray, (u, v, w, f)))
    got = tt(*map(torch.from_numpy, args[:2]), *args[2:],
             *map(torch.from_numpy, (u, v, w, f)))
    _close(got, want, dtype)
    assert float(got.min()) < 1.0  # the factor attenuates


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_predict_model_mixed_sky_matches_jax(dtype):
    """Three clusters (points and Gaussians; disks and a ring; two
    shapelets with a point) corrupted by their own gains."""
    import jax.numpy as jnp

    from sagecal_tpu.io.simulate import random_jones
    from sagecal_tpu.ops import rime as jr
    from sagecal_tpu_torch.interop import shapelets_from_numpy, sources_from_numpy
    from sagecal_tpu_torch.ops import rime as tr

    uvwf = _uvwf(dtype)
    ant = np.triu_indices(7, 1)
    ant_p = np.tile(ant[0], 3)
    ant_q = np.tile(ant[1], 3)
    skies = [_extended_batch(dtype, [0, 1, 1], 0),
             _extended_batch(dtype, [2, 3, 2], 1),
             _extended_batch(dtype, [4, 0, 4], 2)]
    tab = _table(dtype)
    cd = np.complex64 if dtype == np.float32 else np.complex128
    jones = np.array(random_jones(3, 7, seed=2, amp=0.2, dtype=cd))
    want = jr.predict_model(*map(jnp.asarray, uvwf), [_jax_batch(b) for b in
                                                      skies], 180e3,
                            jones=jnp.asarray(jones), ant_p=jnp.asarray(ant_p),
                            ant_q=jnp.asarray(ant_q),
                            shapelet_tables=[None, None, _jax_table(tab)])
    got = tr.predict_model(*map(torch.from_numpy, uvwf),
                           [sources_from_numpy(b, "cpu") for b in skies],
                           180e3, jones=torch.from_numpy(jones),
                           ant_p=torch.from_numpy(ant_p),
                           ant_q=torch.from_numpy(ant_q),
                           shapelet_tables=[None, None,
                                            shapelets_from_numpy(tab, "cpu")])
    _close(got, want, dtype)


def test_shapelet_without_table_refuses():
    from sagecal_tpu_torch.interop import sources_from_numpy
    from sagecal_tpu_torch.ops import rime as tr

    uvwf = _uvwf(np.float64)
    src = sources_from_numpy(_extended_batch(np.float64, [0, 4]), "cpu")
    with pytest.raises(ValueError, match="ShapeletTable"):
        tr.predict_coherencies(*map(torch.from_numpy, uvwf), src)
    with pytest.raises(ValueError, match="ShapeletTable"):
        tr.resolve_source_flags(src)
    assert tr.resolve_source_flags(src, tr.ShapeletTable.empty(
        torch.float64, "cpu")) == (True, True)


def test_source_flags_that_understate_the_batch_refuse():
    """A False flag on a batch with members of that type raises rather
    than predicting them as points; a True flag only widens the path."""
    from sagecal_tpu_torch.interop import sources_from_numpy
    from sagecal_tpu_torch.ops import rime as tr

    uvwf = tuple(map(torch.from_numpy, _uvwf(np.float64)))
    gauss = sources_from_numpy(_extended_batch(np.float64, [1, 1]), "cpu")
    with pytest.raises(ValueError, match="has_extended"):
        tr.predict_coherencies(*uvwf, gauss, has_extended=False)
    table = tr.ShapeletTable.empty(torch.float64, "cpu")
    shap = sources_from_numpy(_extended_batch(np.float64, [0, 4]), "cpu")
    with pytest.raises(ValueError, match="has_shapelet"):
        tr.predict_coherencies(*uvwf, shap, shapelets=table,
                               has_shapelet=False)
    point = sources_from_numpy(_extended_batch(np.float64, [0, 0]), "cpu")
    torch.testing.assert_close(
        tr.predict_coherencies(*uvwf, point, has_extended=True),
        tr.predict_coherencies(*uvwf, point), rtol=1e-12, atol=0.0)


def test_shapelet_chunk_is_bounded():
    """Cutting a shapelet cluster's source chunk changes only the order
    of the sum over sources."""
    from sagecal_tpu_torch.interop import shapelets_from_numpy, sources_from_numpy
    from sagecal_tpu_torch.ops import rime as tr

    uvwf = [torch.from_numpy(a) for a in _uvwf(np.float64)]
    src = sources_from_numpy(_extended_batch(np.float64, [4, 1, 4, 0, 2]),
                             "cpu")
    tab = shapelets_from_numpy(_table(np.float64), "cpu")
    full = tr.predict_coherencies(*uvwf, src, 180e3, shapelets=tab)
    old = tr.SHAPELET_CHUNK_ELEMS
    try:
        tr.SHAPELET_CHUNK_ELEMS = 2 * uvwf[0].shape[0] * 16 * 2  # 2 sources
        cut = tr.predict_coherencies(*uvwf, src, 180e3, shapelets=tab)
    finally:
        tr.SHAPELET_CHUNK_ELEMS = old
    np.testing.assert_allclose(to_np(cut), to_np(full), rtol=0,
                               atol=1e-13 * float(full.abs().max()))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_uv_cut_mask_matches_jax(dtype):
    import jax.numpy as jnp

    from sagecal_tpu.ops.rime import uv_cut_mask as jcut
    from sagecal_tpu_torch.ops.rime import uv_cut_mask as tcut

    u, v, _, _ = _uvwf(dtype)
    for lo, hi in ((0.0, 1e20), (200.0, 900.0)):
        want = np.asarray(jcut(jnp.asarray(u), jnp.asarray(v), 150e6, lo, hi))
        got = to_np(tcut(torch.from_numpy(u), torch.from_numpy(v), 150e6, lo,
                         hi))
        np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_whiten_uv_weights_matches_jax():
    import jax.numpy as jnp

    from sagecal_tpu.solvers.robust import whiten_uv_weights as jw
    from sagecal_tpu_torch.solvers.robust import whiten_uv_weights as tw

    u, v, _, _ = _uvwf(np.float64)
    u = np.concatenate([u, [0.0, 3e-6]])  # 0 and > 400 wavelengths
    v = np.concatenate([v, [0.0, 0.0]])
    want = np.asarray(jw(jnp.asarray(u), jnp.asarray(v), 150e6))
    got = to_np(tw(torch.from_numpy(u), torch.from_numpy(v), 150e6))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    assert got[-1] == 1.0 and math.isclose(got[-2], 1.0 / 2.8)
