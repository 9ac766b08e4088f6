"""Port vs JAX package: ``ops/transforms.py`` (host numpy, float64).

Every function gets the same seeded numpy inputs in both packages and
must agree within 1e-12 of the largest magnitude of its output (the
port's copy runs the same numpy code, so the difference is 0 unless one
drifts)."""

import numpy as np
import pytest

TOL = 1e-12


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1e-300))


def _inputs(seed=0, n=32):
    rng = np.random.default_rng(seed)
    return dict(
        ra=rng.uniform(0, 2 * np.pi, n), dec=rng.uniform(-1.4, 1.4, n),
        lon=rng.uniform(-np.pi, np.pi, n), lat=rng.uniform(-1.2, 1.2, n),
        jd=2451545.0 + rng.uniform(-2e4, 2e4, n),
        xyz=rng.uniform(-6.4e6, 6.4e6, (3, n)),
        ll=rng.uniform(-0.3, 0.3, n), mm=rng.uniform(-0.3, 0.3, n))


def _both():
    from sagecal_tpu.ops import transforms as jt
    from sagecal_tpu_torch.ops import transforms as tt

    return jt, tt


CASES = {
    "xyz2llh": lambda m, a: m.xyz2llh(*a["xyz"]),
    "jd2gmst": lambda m, a: m.jd2gmst(a["jd"]),
    "jd2gmst_before_j2000": lambda m, a: m.jd2gmst(a["jd"] - 5e4),
    "radec2azel_gmst": lambda m, a: m.radec2azel_gmst(
        a["ra"], a["dec"], a["lon"], a["lat"], m.jd2gmst(a["jd"])),
    "radec2azel": lambda m, a: m.radec2azel(a["ra"], a["dec"], a["lon"],
                                            a["lat"], a["jd"]),
    "get_precession_params": lambda m, a: m.get_precession_params(
        float(a["jd"][0])),
    "precess_radec": lambda m, a: m.precess_radec(
        a["ra"], a["dec"] + 1.5, m.get_precession_params(float(a["jd"][1]))),
    "radec_to_lmn": lambda m, a: m.radec_to_lmn(a["ra"], a["dec"], 0.4, 0.7),
    "lmn_to_radec": lambda m, a: m.lmn_to_radec(a["ll"], a["mm"], 0.4, 0.7),
    "precess_radec_equatorial": lambda m, a: m.precess_radec_equatorial(
        a["ra"], a["dec"], m.get_precession_params(float(a["jd"][2]))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_transform_matches_jax(name):
    jt, tt = _both()
    a = _inputs()
    want, got = CASES[name](jt, a), CASES[name](tt, a)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_constants_and_roundtrip():
    jt, tt = _both()
    assert tt.ASEC2RAD == jt.ASEC2RAD
    # lmn_to_radec inverts radec_to_lmn within the hemisphere
    a = _inputs(seed=3)
    ra, dec = tt.lmn_to_radec(a["ll"], a["mm"], 0.4, 0.7)
    ll, mm, _ = tt.radec_to_lmn(ra, dec, 0.4, 0.7)
    np.testing.assert_allclose(ll, a["ll"], atol=1e-12)
    np.testing.assert_allclose(mm, a["mm"], atol=1e-12)
    # the precession matrix is a rotation
    Tr = tt.get_precession_params(2451545.0 + 9000.0)
    np.testing.assert_allclose(Tr @ Tr.T, np.eye(3), atol=1e-12)

