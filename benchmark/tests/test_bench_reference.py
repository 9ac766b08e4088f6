"""The benchmark's plain reference against the program, on the CPU at a
small size: coherencies of points and Gaussians read from the sky files
the benchmark writes, the corrupted model, the residual norm and the
robust cost; and the TF32 rounding of the control."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark.harness import inputs
from benchmark.reference import rime

CFG = {"nclusters": 3, "sources_per_cluster": 4, "gaussian_share": 0.5,
       "field_radius_deg": 3.0, "cluster_radius_deg": 0.3,
       "flux_jy": [1.0, 20.0], "spectral_index": [-0.9, -0.5],
       "gaussian_fwhm_arcmin": [0.5, 3.0], "freq0_hz": 150e6}
RA0, DEC0 = math.radians(123.4), math.radians(48.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def sky(tmp_path):
    g = torch.Generator().manual_seed(3000000123)
    sky_path = str(tmp_path / "sky.txt")
    clus = inputs.make_sky(CFG, g, "cpu", RA0, DEC0, sky_path,
                           sky_path + ".cluster")
    return sky_path, clus


def _rows(n=400, seed=1):
    """u, v, w (seconds) of random baselines up to ~60 km, and stations."""
    r = np.random.default_rng(seed)
    uvw = r.uniform(-6e4, 6e4, (3, n)) / rime.C_LIGHT
    uvw[2] *= 0.1
    ap = r.integers(0, 7, n)
    aq = (ap + 1 + r.integers(0, 6, n)) % 8
    f = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    return (f(uvw[0]), f(uvw[1]), f(uvw[2]), torch.as_tensor(ap),
            torch.as_tensor(aq))


def test_coherencies_match_the_program(sky):
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.ops.rime import predict_coherencies

    sky_path, clus = sky
    batches, _, _ = load_sky(sky_path, sky_path + ".cluster", RA0, DEC0,
                             dtype=torch.float64, device="cpu")
    u, v, w, _, _ = _rows()
    freqs = torch.tensor([149.9e6, 150.1e6], dtype=torch.float64)
    for k, src in enumerate(clus):
        assert sum(src["gauss"]) == 2
        ref = rime.coherencies(rime.source_table(src, RA0, DEC0, "cpu"),
                               u, v, w, freqs, 97656.25)
        got = predict_coherencies(u, v, w, freqs, batches[k], 97656.25)
        assert torch.allclose(got, ref, rtol=0, atol=1e-9 * ref.abs().max())


def test_model_residual_and_costs_match_the_program(sky):
    from sagecal_tpu_torch.core.types import jones_to_params, VisData
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.solvers.sage import (
        _cluster_data, _res_norm, predict_full_model,
    )

    sky_path, clus = sky
    batches, _, _ = load_sky(sky_path, sky_path + ".cluster", RA0, DEC0,
                             dtype=torch.float64, device="cpu")
    u, v, w, ap, aq = _rows()
    freqs = torch.tensor([150e6], dtype=torch.float64)
    g = torch.Generator().manual_seed(5)
    J = torch.eye(2, dtype=torch.complex128) + 0.2 * torch.randn(
        (3, 8, 2, 2), dtype=torch.complex128, generator=g)
    tabs = [rime.source_table(c, RA0, DEC0, "cpu") for c in clus]
    ref = rime.model(rime.tile_coherencies(tabs, u, v, w, freqs, 195312.5),
                     J, ap, aq)
    vis = ref + 0.5 * torch.randn(ref.shape, dtype=torch.complex128,
                                  generator=g)
    R = u.shape[0]
    from sagecal_tpu_torch.ops.rime import predict_coherencies

    coh = torch.stack([predict_coherencies(u, v, w, freqs, b, 195312.5)
                       for b in batches])
    data = VisData(u=u, v=v, w=w, ant_p=ap, ant_q=aq, vis=vis,
                   mask=torch.ones((1, R), dtype=torch.float64), freqs=freqs,
                   time_idx=torch.zeros(R, dtype=torch.int64), freq0=150e6,
                   deltaf=195312.5, deltat=1.0, tilesz=1, nbase=R,
                   nstations=8)
    cdata = _cluster_data(data, coh, [1, 1, 1])
    p = jones_to_params(J).reshape(3, 1, 64)
    model = predict_full_model(p, cdata, data)
    assert torch.allclose(model, ref, rtol=0, atol=1e-9 * ref.abs().max())
    res = vis - ref
    assert float(rime.residual_norm(res)) == pytest.approx(
        float(_res_norm(vis - model, data.mask, R * 8)), rel=1e-9)
    diff = vis - model
    e2 = diff.real ** 2 + diff.imag ** 2
    assert float(rime.robust_cost(res, 3.0)) == pytest.approx(
        float(torch.log1p(e2 / 3.0).sum()), rel=1e-9)


@pytest.mark.parametrize("nu", [3.0, None])
def test_the_joint_cost_and_its_gradient_match_autograd(sky, nu):
    from sagecal_tpu_torch.core.types import jones_to_params

    _, clus = sky
    u, v, w, ap, aq = _rows()
    freqs = torch.tensor([150e6], dtype=torch.float64)
    tabs = [rime.source_table(c, RA0, DEC0, "cpu") for c in clus]
    coh = rime.tile_coherencies(tabs, u, v, w, freqs, 195312.5)
    g = torch.Generator().manual_seed(7)
    J = torch.eye(2, dtype=torch.complex128) + 0.2 * torch.randn(
        (3, 8, 2, 2), dtype=torch.complex128, generator=g)
    # the solutions-file order of the parameters is the program's
    p = jones_to_params(J)
    assert torch.equal(rime.jones(p), J)
    data = rime.model(coh, J * 1.05, ap, aq) + 0.5 * torch.randn(
        (1, 4, u.shape[0]), dtype=torch.complex128, generator=g)
    cost, grad = rime.joint_cost_and_grad(coh, data, p, nu, ap, aq)
    x = p.clone().requires_grad_(True)
    r = data - rime.model(coh, rime.jones(x), ap, aq)
    f = (rime.robust_cost(r, nu) if nu is not None
         else (r.real ** 2 + r.imag ** 2).sum())
    (want,) = torch.autograd.grad(f, x)
    assert cost == pytest.approx(float(f.detach()), rel=1e-12)
    assert torch.allclose(grad, want, rtol=1e-10,
                          atol=1e-10 * want.abs().max())


def test_tf32_keeps_ten_mantissa_bits_rounding_to_nearest_even():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      1 + 2 ** -11 + 2 ** -20, -(1 + 3 * 2 ** -11)],
                     dtype=torch.float32)
    want = [1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9, 1 + 2 ** -10,
            -(1 + 2 ** -9)]
    assert rime.tf32(x).tolist() == want


def test_the_control_differs_by_tf32_phases_not_by_float32(sky):
    _, clus = sky
    u, v, w, _, _ = _rows()
    freqs = torch.tensor([150e6], dtype=torch.float64)
    t = rime.source_table(clus[0], RA0, DEC0, "cpu")
    ref = rime.coherencies(t, u, v, w, freqs, 0.0)
    f32 = rime.coherencies(
        {k: (x if x.dtype == torch.bool else x.float()) for k, x in t.items()},
        u.float(), v.float(), w.float(), freqs.float(), 0.0)
    ctl = rime.coherencies_tf32(t, u, v, w, freqs, 0.0)
    gap = lambda a: float((a.to(torch.complex128) - ref).norm()  # noqa
                          / ref.norm())
    assert gap(f32) < 1e-3
    assert gap(ctl) > 30 * gap(f32)
