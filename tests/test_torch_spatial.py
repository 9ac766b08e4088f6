"""Port vs JAX package: the shapelet product algebra
(``ops/shapelets.py``) and the spatial regularization math
(``parallel/spatial.py``).

Same seeded numpy inputs through both packages.  Bars: 1e-12 relative
(of the largest magnitude) at float64 for the product tensors, the image
and spherical-harmonic bases, the basis blocks, FISTA with and without
the diffuse term, ``find_initial_spatial`` and ``bz_spatial``; 5e-3 at
float32, where the port keeps the data's complex64 and the tests' JAX
process (x64 on) computes the host tensors in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import free_jax_programs  # noqa: F401

TOL = 1e-12
F32_TOL = 5e-3


def _close(a, b, tol=TOL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    err = float(np.max(np.abs(a - b))) / scale
    assert err < tol, err


@pytest.mark.parametrize("args", [
    (12, 4, 4, 1.0, 1.3, 0.8, False), (6, 6, 3, 2e-3, 2e-3, 1e-2, True),
    (3, 2, 3, 0.5, 0.7, 0.5, True)])
def test_shapelet_product_tensor_matches_jax(args):
    from sagecal_tpu.ops.shapelets import shapelet_product_tensor as jspt
    from sagecal_tpu_torch.ops.shapelets import shapelet_product_tensor

    got = shapelet_product_tensor(*args[:6], normalize=args[6])
    _close(got, jspt(*args[:6], normalize=args[6]))
    # cached: a second call gives the same values, and a caller's edit of
    # its copy leaves the cache alone
    got[...] = 0.0
    _close(shapelet_product_tensor(*args[:6], normalize=args[6]),
           jspt(*args[:6], normalize=args[6]))


def test_hermite_product_tensor_matches_jax():
    from sagecal_tpu.ops.shapelets import hermite_product_tensor as jhpt
    from sagecal_tpu_torch.ops.shapelets import hermite_product_tensor

    _close(hermite_product_tensor(4, 3, 5), np.asarray(jhpt(4, 3, 5)))


@pytest.mark.parametrize("hermitian", [False, True])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_shapelet_product_jones_matches_jax(hermitian, dtype):
    from sagecal_tpu.ops.shapelets import shapelet_product_jones as jspj
    from sagecal_tpu_torch.ops.shapelets import (
        shapelet_product_jones, shapelet_product_tensor,
    )

    rng = np.random.default_rng(5)
    T = shapelet_product_tensor(4, 3, 2, 1.0, 1.2, 0.9)
    cdt = np.complex128 if dtype == "f64" else np.complex64
    f = (rng.standard_normal((5, 9, 2, 2))
         + 1j * rng.standard_normal((5, 9, 2, 2))).astype(cdt)
    g = (rng.standard_normal((5, 4, 2, 2))
         + 1j * rng.standard_normal((5, 4, 2, 2))).astype(cdt)
    got = shapelet_product_jones(T, torch.from_numpy(f), torch.from_numpy(g),
                                 hermitian=hermitian)
    want = jspj(T, jnp.asarray(f), jnp.asarray(g), hermitian=hermitian)
    assert got.dtype == torch.from_numpy(f).dtype
    _close(got, want, TOL if dtype == "f64" else F32_TOL)


def test_image_mode_matrix_matches_jax():
    from sagecal_tpu.ops.shapelets import image_mode_matrix as jimm
    from sagecal_tpu_torch.ops.shapelets import image_mode_matrix

    rng = np.random.default_rng(2)
    ll, mm = rng.uniform(-0.05, 0.05, (2, 30))
    for n0, beta in ((1, 0.02), (3, 0.01), (6, 2e-3)):
        got = image_mode_matrix(torch.from_numpy(ll), torch.from_numpy(mm),
                                beta, n0)
        _close(got, jimm(jnp.asarray(ll), jnp.asarray(mm), beta, n0))


def test_sharmonic_and_basis_modes_match_jax():
    from sagecal_tpu.parallel import spatial as js
    from sagecal_tpu_torch.parallel import spatial as ts

    rng = np.random.default_rng(4)
    th, ph = rng.uniform(0, np.pi / 2, 9), rng.uniform(0, 2 * np.pi, 9)
    _close(ts.sharmonic_mode_matrix(th, ph, 4),
           js.sharmonic_mode_matrix(th, ph, 4))
    ll, mm = rng.uniform(-0.03, 0.03, (2, 7))
    for basis, beta in (("shapelet", 0.01), ("shapelet", None),
                        ("sharmonic", None)):
        got, gb = ts.spatial_basis_modes(ll, mm, 3, beta, basis)
        want, wb = js.spatial_basis_modes(ll, mm, 3, beta, basis)
        assert gb == wb
        _close(got, want)
        Phi = ts.build_spatial_basis(ll, mm, 3, beta, basis, device="cpu")
        _close(Phi, js.build_spatial_basis(ll, mm, 3, beta, basis))
        _close(ts.phikk_matrix(Phi, 1e-6),
               js.phikk_matrix(js.build_spatial_basis(ll, mm, 3, beta, basis),
                               1e-6))
    with pytest.raises(ValueError, match="basis"):
        ts.spatial_basis_modes(ll, mm, 2, None, "other")


def _fista_problem(seed=0, M=12, D=8, G=3, noise=0.01):
    rng = np.random.default_rng(seed)
    Phi = rng.standard_normal((M, 2 * G, 2)) + 1j * rng.standard_normal(
        (M, 2 * G, 2))
    Zt = rng.standard_normal((D, 2 * G)) + 1j * rng.standard_normal((D, 2 * G))
    Zbar = np.einsum("dg,mgc->mdc", Zt, Phi)
    Zbar = Zbar + noise * (rng.standard_normal(Zbar.shape)
                           + 1j * rng.standard_normal(Zbar.shape))
    Zd = 0.3 * (rng.standard_normal(Zt.shape)
                + 1j * rng.standard_normal(Zt.shape))
    Psi = 0.1 * (rng.standard_normal(Zt.shape)
                 + 1j * rng.standard_normal(Zt.shape))
    return Phi, Zt, Zbar, Zd, Psi


@pytest.mark.parametrize("diffuse", [False, True])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_fista_matches_jax(diffuse, dtype):
    """``maxiter`` FISTA steps, L1 on, with and without the diffuse
    constraint's Psi/gamma terms; ``spatial_model_apply`` on the fit."""
    from sagecal_tpu.parallel import spatial as js
    from sagecal_tpu_torch.parallel import spatial as ts

    Phi, _, Zbar, Zd, Psi = _fista_problem()
    cdt = np.complex128 if dtype == "f64" else np.complex64
    Phikk = np.asarray(js.phikk_matrix(jnp.asarray(Phi), 1e-6))
    kw = dict(Z_diff=Zd, Psi=Psi, gamma=0.4) if diffuse else {}
    want = js.update_spatialreg_fista(
        jnp.asarray(Zbar.astype(cdt)), jnp.asarray(Phikk.astype(cdt)),
        jnp.asarray(Phi.astype(cdt)), 0.5, maxiter=60,
        **{k: (jnp.asarray(v.astype(cdt)) if isinstance(v, np.ndarray)
               else v) for k, v in kw.items()})
    t = lambda a: torch.from_numpy(a.astype(cdt))  # noqa: E731
    got = ts.update_spatialreg_fista(
        t(Zbar), t(Phikk), t(Phi), 0.5, maxiter=60,
        **{k: (t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    assert got.dtype == t(Zbar).dtype
    tol = TOL if dtype == "f64" else F32_TOL
    _close(got, want, tol)
    _close(ts.spatial_model_apply(got, t(Phi)),
           js.spatial_model_apply(want, jnp.asarray(Phi.astype(cdt))), tol)


def test_fista_recovers_the_model_and_l1_shrinks():
    """The JAX package's own FISTA properties hold in the port: without
    L1 the exact model comes back; a large L1 shrinks the coefficients."""
    from sagecal_tpu_torch.parallel import spatial as ts

    Phi, Zt, Zbar, _, _ = _fista_problem(noise=0.0)
    Phi_t, Zbar_t = torch.from_numpy(Phi), torch.from_numpy(Zbar)
    Z = ts.update_spatialreg_fista(Zbar_t, ts.phikk_matrix(Phi_t, 1e-9),
                                   Phi_t, 0.0, maxiter=300)
    assert float(torch.linalg.norm(Z - torch.from_numpy(Zt))
                 / np.linalg.norm(Zt)) < 1e-2
    Pk = ts.phikk_matrix(Phi_t, 1e-6)
    small = ts.update_spatialreg_fista(Zbar_t, Pk, Phi_t, 0.0, maxiter=100)
    big = ts.update_spatialreg_fista(Zbar_t, Pk, Phi_t, 50.0, maxiter=100)
    assert float(big.abs().sum()) < float(small.abs().sum())


def test_find_initial_spatial_and_bz_spatial_match_jax():
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu.parallel import spatial as js
    from sagecal_tpu_torch.parallel import spatial as ts

    rng = np.random.default_rng(8)
    ll, mm = rng.uniform(-0.03, 0.03, (2, 5))
    modes, _ = js.spatial_basis_modes(ll, mm, 2, 0.01, "shapelet")
    B = np.asarray(jc.setup_polynomials(np.linspace(130e6, 170e6, 4), 150e6,
                                        3, jc.POLY_BERNSTEIN))
    N = 6
    got = ts.find_initial_spatial(B, modes, N)
    want = np.asarray(js.find_initial_spatial(B, modes, N))
    _close(got, want)
    # B_f Zdiff0 Phi_k ~ 1_N kron I_2: the constraint's intent
    Zs = torch.from_numpy(got)
    for f in range(4):
        Zb = ts.bz_spatial(Zs, B[f], N)
        _close(Zb, js.bz_spatial(jnp.asarray(want), jnp.asarray(B[f]), N))
        Zc = ts.bz_spatial(Zs.to(torch.complex64), torch.tensor(B[f]), N)
        assert Zc.dtype == torch.complex64
        _close(Zc, js.bz_spatial(jnp.asarray(want), jnp.asarray(B[f]), N),
               F32_TOL)
