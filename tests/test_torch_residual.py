"""Port vs JAX package: residuals, correction and simulation
(ops/residual.py), the cases of ``tests/test_residual.py``.

Tiles are built by the JAX package (6 stations, 2 point clusters, 2
timeslots x 2 channels, noise-free, zero bandwidth smearing) and carried
to the port as numpy.  Solutions are the true gains, or the true gains
perturbed so that the residual is not zero.

Tolerances, relative to the largest visibility (the size of the terms
that are subtracted): 1e-12 at f64, where both sides compute the same
products in another order; 1e-5 at f32, where the port forms its model
with the fused predict's plain version (the kernel's arithmetic on CUDA)
and the JAX package with its XLA predict.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torch_port_common import norm_rel, rel, tile_arrays, to_np

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _setup(dtype=np.float64, nchunks=(1, 1), perturb=0.05, nclus=2):
    """JAX tile whose data is the model of ``truth``; returns (JAX data,
    cdata, p, port data, cdata, p)."""
    from sagecal_tpu.core.types import jones_to_params
    from sagecal_tpu.io.simulate import (
        corrupt_and_observe, make_visdata, random_jones,
    )
    from sagecal_tpu.ops.rime import point_source_batch
    from sagecal_tpu.solvers.sage import build_cluster_data
    from sagecal_tpu_torch.interop import tile_from_numpy

    fdt = jnp.float64 if dtype == np.float64 else jnp.float32
    cdt = np.complex128 if dtype == np.float64 else np.complex64
    data = make_visdata(nstations=6, tilesz=2, nchan=2, dtype=dtype)
    clusters = [
        point_source_batch([0.0], [0.0], [2.0], dtype=fdt),
        point_source_batch([0.02], [-0.01], [1.0], dtype=fdt),
    ][:nclus]
    truth = random_jones(nclus, 6, seed=5, amp=0.2, dtype=cdt)
    data = corrupt_and_observe(data, clusters, jones=truth, noise_sigma=0.0)
    cdata = build_cluster_data(data, clusters, list(nchunks[:nclus]),
                               fdelta=0.0)
    nmax = max(nchunks[:nclus])
    p = np.repeat(np.asarray(jones_to_params(truth))[:, None, :], nmax, 1)
    p = p + perturb * np.random.default_rng(2).standard_normal(p.shape)
    p = jnp.asarray(p.astype(dtype))
    td, tc, tp = tile_from_numpy(tile_arrays(data, cdata, p), device="cpu")
    return data, cdata, p, td, tc, tp


def _close(got, want, data, dtype):
    scale = float(np.abs(np.asarray(data.vis)).max())
    err = float(np.abs(to_np(got) - np.asarray(want)).max())
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("rho", [0.0, 0.3])
def test_mat_invert_reg_matches_jax(rho):
    from sagecal_tpu.ops.residual import mat_invert_reg as jinv
    from sagecal_tpu_torch.ops.residual import mat_invert_reg

    rng = np.random.default_rng(0)
    J = rng.standard_normal((4, 2, 2)) + 1j * rng.standard_normal((4, 2, 2))
    J[0] = 0.0  # singular: the determinant guard
    want = np.asarray(jinv(jnp.asarray(J), rho))
    got = to_np(mat_invert_reg(torch.from_numpy(J), rho))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if rho == 0.0:
        eye = np.broadcast_to(np.eye(2), (3, 2, 2))
        np.testing.assert_allclose(J[1:] @ got[1:], eye, atol=1e-10)


@pytest.mark.parametrize("phase_only", [False, True],
                         ids=["full", "phase-only"])
def test_correction_jones_matches_jax(phase_only):
    from sagecal_tpu.ops.residual import correction_jones as jcorr
    from sagecal_tpu_torch.ops.residual import correction_jones

    _, _, p, _, _, tp = _setup()
    want = np.asarray(jcorr(p[0], 1e-9, phase_only))
    got = to_np(correction_jones(tp[0], 1e-9, phase_only))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if phase_only:
        got = to_np(correction_jones(tp[0], 0.0, True))
        np.testing.assert_allclose(np.abs(got[..., 0, 0]), 1.0, rtol=1e-10)
        np.testing.assert_allclose(np.abs(got[..., 1, 1]), 1.0, rtol=1e-10)
        np.testing.assert_array_equal(got[..., 0, 1], 0.0)


RES_CASES = [
    # (dtype, cluster chunk counts, ccid_index, phase_only)
    (np.float64, (1, 1), None, False),
    (np.float64, (1, 1), 0, False),
    (np.float64, (1, 1), 1, True),
    (np.float64, (2, 1), 0, False),
    (np.float32, (1, 1), None, False),
    (np.float32, (1, 1), 0, True),
    (np.float32, (2, 1), None, False),
    (np.float32, (2, 1), 1, False),
]


@pytest.mark.parametrize(
    "dtype,nchunks,ccid,phase_only", RES_CASES,
    ids=[f"{np.dtype(c[0]).name}-nc{max(c[1])}-ccid{c[2]}"
         + ("-phase" if c[3] else "") for c in RES_CASES])
def test_calculate_residuals_matches_jax(dtype, nchunks, ccid, phase_only):
    from sagecal_tpu.ops.residual import calculate_residuals as jres
    from sagecal_tpu_torch.ops.residual import calculate_residuals

    data, cdata, p, td, tc, tp = _setup(dtype, nchunks)
    want = jres(data, cdata, p, ccid_index=ccid, phase_only=phase_only)
    got = calculate_residuals(td, tc, tp, ccid_index=ccid,
                              phase_only=phase_only)
    assert got.dtype == td.vis.dtype
    _close(got, want, data, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_exact_solution_gives_zero_residual(dtype):
    from sagecal_tpu_torch.ops.residual import calculate_residuals

    data, _, _, td, tc, tp = _setup(dtype, perturb=0.0)
    res = calculate_residuals(td, tc, tp)
    scale = float(np.abs(np.asarray(data.vis)).max())
    assert float(res.abs().max()) <= TOL[dtype] * scale


def test_correction_restores_uncorrupted_single_cluster():
    """One cluster corrected by its own solutions: J^-1 (J C J^H) J^-H = C."""
    from sagecal_tpu_torch.ops.residual import SIMUL_ONLY, simulate_visibilities

    _, cdata, _, td, tc, tp = _setup(nclus=1, perturb=0.0)
    model = simulate_visibilities(td, tc, tp, mode=SIMUL_ONLY, ccid_index=0,
                                  rho=0.0)
    np.testing.assert_allclose(to_np(model), np.asarray(cdata.coh[0]),
                               atol=1e-9)


SIM_CASES = [
    # (dtype, mode, with solutions, ignore_clusters, ccid_index)
    (np.float64, 1, True, (), None),
    (np.float64, 2, True, (), None),
    (np.float64, 3, True, (), None),
    (np.float64, 1, True, (0,), None),
    (np.float64, 3, True, (1,), 0),
    (np.float64, 1, False, (), None),
    (np.float64, 2, False, (1,), None),
    (np.float32, 1, True, (), None),
    (np.float32, 2, True, (0,), 1),
    (np.float32, 3, True, (), None),
    (np.float32, 1, False, (), None),
]


@pytest.mark.parametrize(
    "dtype,mode,with_p,ignore,ccid", SIM_CASES,
    ids=[f"{np.dtype(c[0]).name}-mode{c[1]}-{'p' if c[2] else 'sky'}"
         f"-ignore{''.join(map(str, c[3]))}-ccid{c[4]}" for c in SIM_CASES])
def test_simulate_visibilities_matches_jax(dtype, mode, with_p, ignore, ccid):
    from sagecal_tpu.ops.residual import simulate_visibilities as jsim
    from sagecal_tpu_torch.ops.residual import simulate_visibilities

    data, cdata, p, td, tc, tp = _setup(dtype)
    want = jsim(data, cdata, p if with_p else None, mode=mode,
                ignore_clusters=ignore, ccid_index=ccid)
    got = simulate_visibilities(td, tc, tp if with_p else None, mode=mode,
                                ignore_clusters=ignore, ccid_index=ccid)
    _close(got, want, data, dtype)


def test_simulate_modes_follow_their_definitions():
    """-a 2 adds the model, -a 3 subtracts it (exactly: the same model)."""
    from sagecal_tpu_torch.ops.residual import (
        SIMUL_ADD, SIMUL_ONLY, SIMUL_SUB, calculate_residuals,
        simulate_visibilities,
    )

    _, _, _, td, tc, tp = _setup(np.float32)
    model = simulate_visibilities(td, tc, tp, SIMUL_ONLY)
    assert torch.equal(simulate_visibilities(td, tc, tp, SIMUL_ADD),
                       td.vis + model)
    assert torch.equal(simulate_visibilities(td, tc, tp, SIMUL_SUB),
                       calculate_residuals(td, tc, tp))


def test_f32_residual_forms_its_model_with_the_plain_predict():
    """f32 data on the CPU: the fused predict's plain version, no launch;
    within f32 rounding of the torch-op predict."""
    from sagecal_tpu_torch.ops import rime_kernel as rk
    from sagecal_tpu_torch.ops.residual import calculate_residuals
    from sagecal_tpu_torch.solvers.sage import predict_full_model

    data, _, _, td, tc, tp = _setup(np.float32, (2, 1))
    before = rk.fused_predict_fwd_cuda.launches
    got = calculate_residuals(td, tc, tp)
    assert rk.fused_predict_fwd_cuda.launches == before
    _close(got, to_np(td.vis - predict_full_model(tp, tc, td)), data,
           np.float32)


def test_residual_norm_matches_jax():
    from sagecal_tpu.ops.residual import (
        calculate_residuals as jres, residual_norm as jnorm,
    )
    from sagecal_tpu_torch.ops.residual import residual_norm

    data, cdata, p, td, tc, tp = _setup()
    r = jres(data, cdata, p)
    got = residual_norm(torch.from_numpy(np.array(r)), td.mask)
    assert rel(got, jnorm(r, data.mask)) <= 1e-12


def test_fused_objective_matches_jax():
    """Value and gradient with respect to p, robust cost (the default
    mode's; the Gaussian kernel path is held to JAX in
    test_torch_rime_kernel.py); the JAX side runs its Pallas objective
    in interpret mode."""
    nu = 5.0
    import jax
    from sagecal_tpu.ops.residual import fused_objective as jobj
    from sagecal_tpu_torch.ops.residual import fused_objective

    data, cdata, p, td, tc, tp = _setup(np.float32, perturb=0.1)
    vj, gj = jax.value_and_grad(lambda x: jobj(data, cdata, x, nu))(p)
    x = tp.clone().requires_grad_(True)
    vt = fused_objective(td, tc, x, nu)
    (gt,) = torch.autograd.grad(vt, x)
    assert rel(vt.detach(), vj) <= 1e-5
    assert norm_rel(gt, np.asarray(gj)) <= 1e-5


def test_fused_objective_refuses_coherency_gradients_and_f64():
    from sagecal_tpu_torch.ops.residual import fused_objective
    from sagecal_tpu_torch.ops.rime_kernel import FusedSkyGradientError

    _, _, _, td, tc, tp = _setup(np.float32)
    with pytest.raises(FusedSkyGradientError):
        fused_objective(td, tc.replace(coh=tc.coh.clone().requires_grad_(True)),
                        tp)
    _, _, _, td, tc, tp = _setup(np.float64)
    with pytest.raises(ValueError, match="float32"):
        fused_objective(td, tc, tp)
