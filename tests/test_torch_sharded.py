"""The rows-sharded joint fit (``sagecal_tpu_torch/solvers/sharded.py``)
against the JAX package's single-device ``lbfgs_fit`` on the same padded
cost, built as ``tests/test_sharded.py`` builds it; its bounds (cost
rtol 1e-9, p rtol 1e-7 / atol 1e-9).  The JAX sharded fit is not the
oracle: its own test has failed since the seed."""

import numpy as np
import pytest
import torch

from torch_port_common import free_jax_programs, tile_arrays, to_np  # noqa: F401

NU = 5.0


@pytest.fixture(scope="module")
def scene():
    import jax
    import jax.numpy as jnp

    from sagecal_tpu.core.types import identity_jones, jones_to_params
    from sagecal_tpu.solvers.lbfgs import lbfgs_fit
    from sagecal_tpu.solvers.sage import predict_full_model
    from sagecal_tpu.solvers.sharded import pad_rows_to
    from test_sharded import _scene

    m, nst = 2, 7
    data, cdata = _scene(m=m, nst=nst)
    p0 = jones_to_params(jnp.broadcast_to(
        identity_jones(nst, jnp.complex128), (m, 1, nst, 2, 2)))
    data_p, cdata_p = pad_rows_to(data, cdata, 8)

    def cost_fn(pflat):
        pa = pflat.reshape(p0.shape)
        model = predict_full_model(pa, cdata_p, data_p)
        diff = (data_p.vis - model) * data_p.mask[..., None, :]
        e2 = jnp.real(diff) ** 2 + jnp.imag(diff) ** 2
        return jnp.sum(jnp.log1p(e2 / NU))

    fit = jax.jit(
        lambda p: lbfgs_fit(cost_fn, None, p.reshape(-1), itmax=25, M=7))(p0)
    ref = (float(fit.cost), np.asarray(fit.p.reshape(p0.shape)))
    return tile_arrays(data, cdata, p0), ref


@pytest.mark.parametrize("nshards", [1, 2, 8])
def test_sharded_fit_matches_single_device_lbfgs(scene, nshards):
    from sagecal_tpu_torch.interop import tile_from_numpy
    from sagecal_tpu_torch.solvers import pad_rows_to, sharded_joint_fit

    arrays, (cost_ref, p_ref) = scene
    data, cdata, p0 = tile_from_numpy(arrays, device="cpu")
    data_p, cdata_p = pad_rows_to(data, cdata, 8)
    p, cost, it = sharded_joint_fit(data_p, cdata_p, p0, nshards, itmax=25,
                                    robust_nu=NU, device="cpu")
    np.testing.assert_allclose(float(cost), cost_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(to_np(p), p_ref, rtol=1e-7, atol=1e-9)
    assert float(cost) < 1e-2


def test_sharded_quality_sums_to_the_cost(scene):
    """The block-summed chi^2 attribution reproduces the cost, and its
    station and baseline sums equal the unsharded scatter's."""
    from sagecal_tpu_torch.interop import tile_from_numpy
    from sagecal_tpu_torch.solvers import pad_rows_to, sharded_joint_fit

    arrays, _ = scene
    data, cdata, p0 = tile_from_numpy(arrays, device="cpu")
    data_p, cdata_p = pad_rows_to(data, cdata, 8)
    outs = [sharded_joint_fit(data_p, cdata_p, p0, k, itmax=6, robust_nu=NU,
                              collect_quality=True, device="cpu")
            for k in (1, 4)]
    for p, cost, _, q in outs:
        np.testing.assert_allclose(float(q.chi2_chunk.sum()), float(cost),
                                   rtol=1e-12)
    q1, q4 = outs[0][3], outs[1][3]
    np.testing.assert_allclose(to_np(q4.chi2_station), to_np(q1.chi2_station),
                               rtol=1e-9)
    np.testing.assert_allclose(to_np(q4.chi2_baseline),
                               to_np(q1.chi2_baseline), rtol=1e-9, atol=1e-14)


def test_pad_rows_to_masks_padding(scene):
    from sagecal_tpu_torch.interop import tile_from_numpy
    from sagecal_tpu_torch.solvers import pad_rows_to

    arrays, _ = scene
    data, cdata, _ = tile_from_numpy(arrays, device="cpu")
    rows = data.vis.shape[-1]
    data_p, cdata_p = pad_rows_to(data, cdata, 512)
    rowsp = data_p.vis.shape[-1]
    assert rowsp % 512 == 0 and rowsp >= rows
    assert float(data_p.mask[..., rows:].sum()) == 0.0
    assert float(cdata_p.coh[..., rows:].abs().max()) == 0.0
    assert torch.equal(data_p.vis[..., :rows], data.vis)
    same = pad_rows_to(data, cdata, rows)
    assert same[0] is data and same[1] is cdata


def test_rows_must_split_into_the_blocks(scene):
    from sagecal_tpu_torch.interop import tile_from_numpy
    from sagecal_tpu_torch.solvers import sharded_joint_fit

    arrays, _ = scene
    data, cdata, p0 = tile_from_numpy(arrays, device="cpu")
    rows = data.vis.shape[-1]
    with pytest.raises(ValueError, match="pad_rows_to"):
        sharded_joint_fit(data, cdata, p0, rows + 1, device="cpu")
