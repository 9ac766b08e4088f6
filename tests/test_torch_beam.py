"""Port vs JAX package: ``ops/beam.py`` (array factor, element beam, the
per-source beam and the beam-aware predict).

The same seeded numpy inputs go through both packages on the CPU.
Tolerance: 1e-12 of the largest magnitude of the output at float64.
One exception, a deliberate difference (ROADMAP.md, Queue C): the JAX
package builds the identity E-Jones of ``DOBEAM_ARRAY`` (and of a
missing element table) as complex64 even at float64, so its array-factor
gain is rounded to complex64 there; the port keeps float64.  That branch
is held to 1e-6 relative (complex64's eps is 1.2e-7), and to 1e-12
against the JAX package's float64 ``array_beam_gain``, which it is.
"""

import numpy as np
import pytest
import torch

from torch_port_common import to_np

TOL = 1e-12
C64_TOL = 1e-6


def _close(got, want, tol=TOL):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _geometry_np(N=5, bf_type=1, seed=0):
    """A geometry dict: STAT_SINGLE, 24 dipoles a station with 3 masked;
    STAT_TILE, 16 tile dipoles (5 m) then 48 tile centroids (40 m), the
    last station's masked to 24 (a core station's 24 tiles)."""
    rng = np.random.default_rng(seed)
    K = 24 if bf_type == 1 else 16 + 48
    scale = np.full(K, 25.0)
    if bf_type == 2:
        scale[:16] = 2.5
        scale[16:] = 40.0
    mask = np.ones((N, K))
    if bf_type == 1:
        mask[:, -3:] = 0.0
    else:
        mask[-1, 16 + 24:] = 0.0
    return dict(longitude=rng.uniform(0.1, 0.2, N),
                latitude=rng.uniform(0.8, 0.9, N),
                x=rng.uniform(-1, 1, (N, K)) * scale,
                y=rng.uniform(-1, 1, (N, K)) * scale,
                z=rng.uniform(-0.5, 0.5, (N, K)), elem_mask=mask,
                bf_type=bf_type)


def _jax_geometry(g):
    import jax.numpy as jnp

    from sagecal_tpu.ops.beam import StationGeometry

    return StationGeometry(**{k: jnp.asarray(v) for k, v in g.items()
                              if k != "bf_type"}, bf_type=g["bf_type"])


POINTING = (0.4, 0.7, 0.42, 0.69, 150e6)
T_JD = np.array([2456789.30, 2456789.31, 2456789.32])
FREQS = np.array([120e6, 150e6, 180e6])


def _sources(S=7, seed=2):
    rng = np.random.default_rng(seed)
    return (POINTING[0] + rng.uniform(-0.3, 0.3, S),
            POINTING[1] + rng.uniform(-0.3, 0.3, S))


@pytest.mark.parametrize("bf_type", [1, 2], ids=["single", "tile"])
@pytest.mark.parametrize("wideband", [False, True], ids=["f0", "wideband"])
def test_array_beam_gain_matches_jax(bf_type, wideband):
    import jax.numpy as jnp

    from sagecal_tpu.ops import beam as jb
    from sagecal_tpu_torch.interop import geometry_from_numpy
    from sagecal_tpu_torch.ops import beam as tb

    g = _geometry_np(bf_type=bf_type)
    ra, dec = _sources()
    az, el = jb.azel_grid(ra, dec, g["longitude"], g["latitude"], T_JD)
    az0, el0 = jb.azel_grid(np.array([POINTING[0]]), np.array([POINTING[1]]),
                            g["longitude"], g["latitude"], T_JD)
    azb, elb = jb.azel_grid(np.array([POINTING[2]]), np.array([POINTING[3]]),
                            g["longitude"], g["latitude"], T_JD)
    pj = jb.BeamPointing(*POINTING)
    args = (az, el, az0[..., 0], el0[..., 0], azb[..., 0], elb[..., 0], FREQS)
    want = jb.array_beam_gain(_jax_geometry(g), pj,
                              *map(jnp.asarray, args), wideband)
    got = tb.array_beam_gain(geometry_from_numpy(g, "cpu"),
                             tb.BeamPointing(*POINTING),
                             *map(torch.from_numpy, args), wideband,
                             source_chunk=3)
    _close(got, want)
    assert 0.0 < float(got.max()) <= 1.0 + 1e-12
    # the port's grid is the reference's (numpy, host)
    taz, tel = tb.azel_grid(ra, dec, torch.from_numpy(g["longitude"]),
                            torch.from_numpy(g["latitude"]), T_JD)
    np.testing.assert_array_equal(taz, az)
    np.testing.assert_array_equal(tel, el)


def test_array_beam_gain_below_horizon_and_centre():
    from sagecal_tpu_torch.interop import geometry_from_numpy
    from sagecal_tpu_torch.ops import beam as tb

    geom = geometry_from_numpy(_geometry_np(N=3), "cpu").to("cpu")
    assert geom.bf_type == 1 and geom.x.dtype == torch.float64
    pointing = tb.BeamPointing(0.4, 0.7, 0.4, 0.7, 150e6)
    t = torch.float64
    g = tb.array_beam_gain(geom, pointing, torch.zeros((1, 3, 1), dtype=t),
                           torch.full((1, 3, 1), -0.1, dtype=t),
                           torch.zeros((1, 3), dtype=t),
                           torch.full((1, 3), 0.5, dtype=t),
                           torch.zeros((1, 3), dtype=t),
                           torch.full((1, 3), 0.5, dtype=t),
                           torch.tensor([150e6], dtype=t))
    assert float(g.abs().max()) == 0.0
    # pointing at the beam centre at f0: every element phase is 0
    el = torch.full((1, 3, 1), 0.5, dtype=t)
    g = tb.array_beam_gain(geom, pointing, torch.zeros((1, 3, 1), dtype=t),
                           el, torch.zeros((1, 3), dtype=t), el[..., 0],
                           torch.zeros((1, 3), dtype=t), el[..., 0],
                           torch.tensor([150e6], dtype=t))
    np.testing.assert_allclose(to_np(g), 1.0, rtol=1e-12)


@pytest.mark.parametrize("kind", ["lba", "hba", "alo"])
def test_element_tables_match_jax(kind):
    import jax.numpy as jnp

    from sagecal_tpu.ops import beam as jb
    from sagecal_tpu_torch.ops import beam as tb

    freq = {"lba": 55e6, "hba": 150e6, "alo": 25e6}[kind]
    cj = jb.ElementCoeffs.from_table(kind, freq)
    ct = tb.ElementCoeffs.from_table(kind, freq, device="cpu")
    assert (ct.M, ct.beta) == (cj.M, cj.beta)
    for k in ("pattern_theta", "pattern_phi", "preamble"):
        np.testing.assert_array_equal(to_np(getattr(ct, k)),
                                      np.asarray(getattr(cj, k)))
    rng = np.random.default_rng(5)
    r, th = rng.uniform(0, 1.5, 40), rng.uniform(0, 2 * np.pi, 40)
    for w, g in zip(jb.eval_element(cj, jnp.asarray(r), jnp.asarray(th)),
                    tb.eval_element(ct, torch.from_numpy(r),
                                    torch.from_numpy(th))):
        _close(g, w)
    az, el = rng.uniform(0, 2 * np.pi, (3, 4)), rng.uniform(-0.3, 1.5, (3, 4))
    want = jb.element_ejones(cj, jnp.asarray(az), jnp.asarray(el))
    got = tb.element_ejones(ct, torch.from_numpy(az), torch.from_numpy(el))
    _close(got, want)
    # the tables between two frequencies interpolate (and clamp at ends)
    for f in (1e6, 1e10, freq * 1.013):
        np.testing.assert_array_equal(
            to_np(tb.ElementCoeffs.from_table(kind, f, "cpu").pattern_phi),
            np.asarray(jb.ElementCoeffs.from_table(kind, f).pattern_phi))


def test_element_tables_are_byte_identical_copies():
    import os

    import sagecal_tpu
    import sagecal_tpu_torch

    for kind in ("lba", "hba", "alo"):
        a, b = (os.path.join(os.path.dirname(pkg.__file__), "data",
                             "element", f"{kind}.npz")
                for pkg in (sagecal_tpu, sagecal_tpu_torch))
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), kind


def test_coeffs_save_load_and_synthetic(tmp_path):
    from sagecal_tpu.ops import beam as jb
    from sagecal_tpu_torch.ops import beam as tb

    c = tb.synthetic_dipole_coeffs(M=3, beta=0.9, device="cpu")
    cj = jb.synthetic_dipole_coeffs(M=3, beta=0.9)
    np.testing.assert_array_equal(to_np(c.pattern_theta),
                                  np.asarray(cj.pattern_theta))
    path = str(tmp_path / "c.npz")
    c.save(path)
    c2 = tb.ElementCoeffs.load(path, device="cpu").to("cpu")
    assert (c2.M, c2.beta) == (3, 0.9)
    np.testing.assert_array_equal(to_np(c2.preamble), to_np(c.preamble))
    # a file the JAX package saved loads into the port
    cj.save(str(tmp_path / "j.npz"))
    c3 = tb.ElementCoeffs.load(str(tmp_path / "j.npz"), device="cpu")
    np.testing.assert_array_equal(to_np(c3.pattern_phi),
                                  np.asarray(cj.pattern_phi))
    for M in range(1, 8):
        assert tb.ElementCoeffs.mode_count(M) == jb.ElementCoeffs.mode_count(M)
        np.testing.assert_array_equal(tb.ElementCoeffs.preamble_for(M, 1.3),
                                      jb.ElementCoeffs.preamble_for(M, 1.3))


MODES = {"none": 0, "array": 1, "element": 2, "full": 3}


@pytest.mark.parametrize("bf_type", [1, 2], ids=["single", "tile"])
@pytest.mark.parametrize("mode", list(MODES))
def test_beam_jones_matches_jax(mode, bf_type):
    import jax.numpy as jnp

    from sagecal_tpu.ops import beam as jb
    from sagecal_tpu_torch.interop import (
        coeffs_from_numpy, geometry_from_numpy, pointing_from_numpy,
    )
    from sagecal_tpu_torch.ops import beam as tb

    g = _geometry_np(bf_type=bf_type, seed=4)
    ra, dec = _sources(S=5, seed=6)
    cj = jb.ElementCoeffs.from_table("hba", 150e6)
    gj, pj = _jax_geometry(g), jb.BeamPointing(*POINTING)
    want = jb.beam_jones(gj, pj, cj, ra, dec, T_JD, jnp.asarray(FREQS),
                         mode=MODES[mode], wideband=True)
    # the JAX package's own objects carried across by interop
    got = tb.beam_jones(geometry_from_numpy(gj, "cpu"),
                        pointing_from_numpy(pj),
                        coeffs_from_numpy(cj, "cpu"), ra, dec, T_JD,
                        torch.from_numpy(FREQS), mode=MODES[mode],
                        wideband=True)
    assert got.dtype == torch.complex128
    if mode == "array":
        # the JAX package's complex64 identity (module doc)
        _close(got, want, C64_TOL)
        az, el = jb.azel_grid(ra, dec, g["longitude"], g["latitude"], T_JD)
        az0, el0 = jb.azel_grid(np.array([POINTING[0]]),
                                np.array([POINTING[1]]), g["longitude"],
                                g["latitude"], T_JD)
        azb, elb = jb.azel_grid(np.array([POINTING[2]]),
                                np.array([POINTING[3]]), g["longitude"],
                                g["latitude"], T_JD)
        gain = jb.array_beam_gain(
            _jax_geometry(g), jb.BeamPointing(*POINTING),
            *map(jnp.asarray, (az, el, az0[..., 0], el0[..., 0], azb[..., 0],
                               elb[..., 0], FREQS)), True)
        eye = np.eye(2)[None, None, None, None]
        _close(got, np.asarray(gain)[..., None, None] * eye)
    else:
        _close(got, want)


def _predict_inputs(dtype=np.float64, T=2, N=5, seed=3):
    from test_torch_special_rime_ext import _uvwf

    u, v, w, f = _uvwf(dtype)
    rows = u.shape[0]
    rng = np.random.default_rng(seed)
    time_idx = rng.integers(0, T, rows)
    ant_p = rng.integers(0, N, rows)
    ant_q = (ant_p + rng.integers(1, N, rows)) % N
    return u, v, w, f, time_idx, ant_p, ant_q


SKIES = {"points": [0, 0, 0, 0, 0], "extended": [1, 2, 3, 0, 1, 3],
         "shapelet": [0, 4, 1]}


@pytest.mark.parametrize("sky", list(SKIES))
def test_predict_withbeam_matches_jax(sky):
    import jax.numpy as jnp

    from sagecal_tpu.ops import beam as jb
    from sagecal_tpu_torch.interop import (
        geometry_from_numpy, shapelets_from_numpy, sources_from_numpy,
    )
    from sagecal_tpu_torch.ops import beam as tb
    from test_torch_special_rime_ext import (
        _extended_batch, _jax_batch, _jax_table, _table,
    )

    u, v, w, f, tidx, ap, aq = _predict_inputs()
    b = _extended_batch(np.float64, SKIES[sky], seed=8)
    S = len(SKIES[sky])
    g = _geometry_np(bf_type=2, seed=9)
    ra, dec = _sources(S=S, seed=10)
    cj = jb.ElementCoeffs.from_table("hba", 150e6)
    Bj = jb.beam_jones(_jax_geometry(g), jb.BeamPointing(*POINTING), cj, ra,
                       dec, T_JD[:2], jnp.asarray(f), mode=3)
    tab = _table(np.float64, K=1) if sky == "shapelet" else None
    kw = dict(fdelta=180e3, source_chunk=2)
    want = jb.predict_coherencies_withbeam(
        *map(jnp.asarray, (u, v, w, f)), _jax_batch(b), Bj,
        *map(jnp.asarray, (tidx, ap, aq)),
        shapelets=None if tab is None else _jax_table(tab), **kw)
    Bt = tb.beam_jones(geometry_from_numpy(g, "cpu"),
                       tb.BeamPointing(*POINTING),
                       tb.ElementCoeffs.from_table("hba", 150e6, "cpu"), ra,
                       dec, T_JD[:2], torch.from_numpy(f), mode=3)
    _close(Bt, Bj)
    got = tb.predict_coherencies_withbeam(
        *map(torch.from_numpy, (u, v, w, f)), sources_from_numpy(b, "cpu"),
        Bt, *map(torch.from_numpy, (tidx, ap, aq)),
        shapelets=None if tab is None else shapelets_from_numpy(tab, "cpu"),
        **kw)
    _close(got, want)
    # beam-aware coherencies carry off-diagonal power that an unpolarized
    # unbeamed point sky never has
    assert float(got[:, 1].abs().max()) > 1e-3 * float(got.abs().max())


def test_predict_withbeam_identity_is_plain_predict():
    """B = identity reproduces the unbeamed coherencies (the reference
    test's oracle)."""
    from sagecal_tpu_torch.interop import sources_from_numpy
    from sagecal_tpu_torch.ops import beam as tb
    from sagecal_tpu_torch.ops.rime import predict_coherencies
    from test_torch_special_rime_ext import _extended_batch

    u, v, w, f, tidx, ap, aq = map(torch.from_numpy, _predict_inputs())
    src = sources_from_numpy(_extended_batch(np.float64, [0, 1, 2]), "cpu")
    B = torch.eye(2, dtype=torch.complex128).expand(2, 2, 5, 3, 2, 2)
    got = tb.predict_coherencies_withbeam(u, v, w, f, src, B, tidx, ap, aq,
                                          fdelta=180e3)
    _close(got, predict_coherencies(u, v, w, f, src, fdelta=180e3))
    with pytest.raises(ValueError, match="ShapeletTable"):
        src4 = sources_from_numpy(_extended_batch(np.float64, [4]), "cpu")
        tb.predict_coherencies_withbeam(u, v, w, f, src4, B[:, :, :, :1],
                                        tidx, ap, aq)
