"""Port vs JAX package: ``data/simsky.py``, simulated skies with known
ground truth.

One seed must give both packages the same sky, the same true gains and
the same visibilities: every draw is numpy's seeded ``Generator`` in
the same order.  At f64 (the fixtures' default) the data, sources,
shapelet tables and gains agree to 1e-12 of their max abs (the
visibilities pass through each package's predict).
"""

import numpy as np
import pytest

from torch_port_common import to_np

TOL = 1e-12


def _close(got, want, what):
    got, want = to_np(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _same_sky(got, want):
    from sagecal_tpu_torch.interop import sources_to_numpy

    for k in ("u", "v", "w", "freqs", "vis", "mask", "ant_p", "ant_q",
              "time_idx"):
        _close(getattr(got.data, k), getattr(want.data, k), k)
    _close(got.jones, want.jones, "jones")
    assert len(got.clusters) == len(want.clusters)
    for a, b in zip(got.clusters, want.clusters):
        for k, x in sources_to_numpy(a).items():
            _close(x, getattr(b, k), k)
    for ta, tb in zip(got.shapelet_tables, want.shapelet_tables):
        assert (ta is None) == (tb is None)
        if ta is not None:
            assert ta.n0max == tb.n0max
            for k in ("modes", "beta", "eX", "eY", "eP"):
                _close(getattr(ta, k), getattr(tb, k), k)
    for a, b in zip(got.true_flux + got.true_spec_idx,
                    want.true_flux + want.true_spec_idx):
        np.testing.assert_array_equal(a, b)
    if want.true_modes is None:
        assert got.true_modes is None
    else:
        np.testing.assert_array_equal(got.true_modes, want.true_modes)
    assert (got.freq0, got.dec0, got.noise_sigma) == (
        want.freq0, want.dec0, want.noise_sigma)


CASES = {
    "point": dict(),
    "shapelet-spectral": dict(shapelet_n0=3, spectral=True, noise_sigma=1e-3,
                              nclusters=3),
    "wide-field": dict(wide_field=True, nsources=40, nclusters=4,
                       spectral=True, extent_m=200.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_make_sky_matches_jax(case):
    from sagecal_tpu.data.simsky import make_sky as jmake
    from sagecal_tpu_torch.data.simsky import make_sky as tmake

    kw = dict(nstations=6, tilesz=2, nchan=2, seed=11, **CASES[case])
    _same_sky(tmake(device="cpu", **kw), jmake(**kw))


def test_make_multiband_skies_and_perturb_flux_match_jax():
    from sagecal_tpu.data.simsky import (
        make_multiband_skies as jbands, perturb_flux as jperturb,
    )
    from sagecal_tpu_torch.data.simsky import (
        make_multiband_skies as tbands, perturb_flux as tperturb,
    )

    kw = dict(nbands=3, band_bw=5e6, nstations=5, tilesz=2, nchan=1,
              shapelet_n0=2, seed=4)
    got, want = tbands(device="cpu", **kw), jbands(**kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_sky(g, w)
    np.testing.assert_allclose(to_np(got[2].data.freqs),
                               np.asarray(want[2].data.freqs))
    pg = tperturb(got[0], factor=1.2, cluster=0, source=1)
    pw = jperturb(want[0], factor=1.2, cluster=0, source=1)
    _close(pg[0].sI0, pw[0].sI0, "perturbed flux")
    assert float(pg[0].sI0[1]) != float(got[0].clusters[0].sI0[1])
    assert pg[1] is got[0].clusters[1]


def test_shapelet_source_batch_matches_jax():
    from sagecal_tpu.data.simsky import shapelet_source_batch as jsb
    from sagecal_tpu_torch.data.simsky import shapelet_source_batch as tsb
    import torch

    modes = np.arange(9.0).reshape(3, 3)
    ts_, tt = tsb(0.01, -0.02, 2.0, modes, beta=0.02, dtype=torch.float64,
                  device="cpu")
    js_, jt = jsb(0.01, -0.02, 2.0, modes, beta=0.02, dtype=np.float64)
    _close(ts_.stype, js_.stype, "stype")
    _close(tt.modes, jt.modes, "modes")
    assert tt.n0max == jt.n0max == 3
    with pytest.raises(ValueError, match="square"):
        tsb(0.0, 0.0, 1.0, np.ones(5), device="cpu")
