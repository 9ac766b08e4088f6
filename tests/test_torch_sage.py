"""Port vs JAX package: the whole slice — one SAGE tile through ``sagefit``.

The tile is the ``__graft_entry__.entry()`` tile (8 stations, 2 point
clusters, 2 timeslots x 2 channels, f32), built by the JAX package and
carried to the port through ``interop`` as numpy.  The config is
``entry()``'s (max_iter 5, max_lbfgs 8, lbfgs_m 5).

Deterministic modes are held to the JAX result: ``res_1`` relative error
<= 5e-3 and ``p`` absolute error <= 5e-3, the bar the JAX package holds
its own fused path to (tests/test_rime_kernel.py).  They differ by f32
rounding in another summation order, which LM damping decisions and the
LBFGS line search can amplify over a few dozen iterations.  At f64 the
torch-op path is held to rounding (1e-10 on res_1, 1e-9 on p).  Modes 0, 3,
and mode 2 with more than one EM pass run OS-LM on random row subsets
(``jax.random`` there, a ``torch.Generator`` here), so they are held
only to converging: ``res_1 < 0.2 res_0``.
"""

import numpy as np
import pytest

import jax
import torch

from torch_port_common import jax_entry_tile, rel, to_np

ENTRY_KW = dict(max_iter=5, max_lbfgs=8, lbfgs_m=5)
RES_TOL = 5e-3
P_ATOL = 5e-3


@pytest.fixture(scope="module")
def tile():
    return jax_entry_tile(np.float32)


def _port_fit(arrays, **kw):
    from sagecal_tpu_torch.interop import result_to_numpy, tile_from_numpy
    from sagecal_tpu_torch.solvers.sage import SageConfig, sagefit

    td, tc, tp = tile_from_numpy(arrays, device="cpu")
    return result_to_numpy(sagefit(td, tc, tp, SageConfig(**kw), device="cpu"))


@pytest.mark.parametrize("fused", [False, True], ids=["torch-ops", "fused"])
@pytest.mark.parametrize("mode,emiter", [(1, 2), (2, 1)],
                         ids=["mode1-lm", "mode2-robust"])
def test_sagefit_matches_jax(tile, mode, emiter, fused):
    from sagecal_tpu.solvers.sage import SageConfig as JCfg, sagefit as jfit

    data, cdata, p0, arrays = tile
    kw = dict(ENTRY_KW, max_emiter=emiter, solver_mode=mode,
              use_fused_predict=fused)
    want = jfit(data, cdata, p0, JCfg(**kw))
    got = _port_fit(arrays, **kw)
    assert rel(got["res_0"], want.res_0) <= 1e-5
    assert rel(got["res_1"], want.res_1) <= RES_TOL
    assert np.abs(got["p"] - np.asarray(want.p)).max() <= P_ATOL
    assert float(got["res_1"]) < float(got["res_0"])


@pytest.mark.parametrize("mode,emiter", [(1, 2), (2, 1)],
                         ids=["mode1-lm", "mode2-robust"])
def test_sagefit_f64_matches_jax_to_rounding(mode, emiter):
    """At f64 the same algorithm leaves only rounding between the two
    packages: res_1 to 1e-10 relative, p to 1e-9 absolute."""
    from sagecal_tpu.solvers.sage import SageConfig as JCfg, sagefit as jfit

    data, cdata, p0, arrays = jax_entry_tile(np.float64)
    kw = dict(ENTRY_KW, max_emiter=emiter, solver_mode=mode)
    want = jfit(data, cdata, p0, JCfg(**kw))
    got = _port_fit(arrays, **kw)
    assert rel(got["res_1"], want.res_1) <= 1e-10
    assert np.abs(got["p"] - np.asarray(want.p)).max() <= 1e-9


@pytest.mark.parametrize("fused", [False, True], ids=["torch-ops", "fused"])
@pytest.mark.parametrize("mode,emiter", [(0, 2), (3, 2), (2, 2)],
                         ids=["mode0-oslm", "mode3-default", "mode2-em2"])
def test_sagefit_random_subset_modes_converge(tile, mode, emiter, fused):
    got = _port_fit(tile[3], **dict(ENTRY_KW, max_emiter=emiter,
                                    solver_mode=mode, use_fused_predict=fused))
    assert np.isfinite(got["p"]).all()
    assert float(got["res_1"]) < 0.2 * float(got["res_0"])


def test_fused_bf16_coherencies_agree_with_f32(tile):
    base = dict(ENTRY_KW, max_emiter=2, solver_mode=1, use_fused_predict=True)
    f32 = _port_fit(tile[3], **base)
    bf16 = _port_fit(tile[3], **dict(base, coh_dtype="bf16"))
    assert rel(bf16["res_1"], f32["res_1"]) <= 5e-2


def test_interop_round_trip(tile):
    from sagecal_tpu_torch.interop import (
        result_to_numpy, tile_from_numpy,
    )
    from sagecal_tpu_torch.solvers.sage import SageResult
    from torch_port_common import STATIC_FIELDS, VIS_FIELDS

    arrays = tile[3]
    td, tc, tp = tile_from_numpy(arrays, device="cpu")
    for k in VIS_FIELDS:
        np.testing.assert_array_equal(to_np(getattr(td, k)), arrays[k])
    for k in STATIC_FIELDS:
        assert getattr(td, k) == arrays[k]
    for k in ("coh", "chunk_map", "nchunk"):
        np.testing.assert_array_equal(to_np(getattr(tc, k)), arrays[k])
    np.testing.assert_array_equal(to_np(tp), arrays["p0"])
    assert td.vis.dtype == torch.complex64 and td.ant_p.dtype == torch.int64
    res = SageResult(p=tp, res_0=torch.tensor(2.0), res_1=torch.tensor(1.0),
                     mean_nu=torch.tensor(3.0), diverged=torch.tensor(False))
    back = result_to_numpy(res)
    np.testing.assert_array_equal(back["p"], arrays["p0"])
    assert (float(back["res_0"]), float(back["res_1"]),
            float(back["mean_nu"]), bool(back["diverged"])) == (2.0, 1.0, 3.0,
                                                                False)


def test_unported_options_refuse(tile):
    from sagecal_tpu_torch.solvers.sage import SageConfig

    for kw in (dict(solver_mode=4), dict(solver_mode=6),
               dict(param_bound=1.0), dict(collect_telemetry=True),
               dict(collect_quality=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _port_fit(tile[3], **dict(ENTRY_KW, max_emiter=1, **kw))


def test_solve_tile_without_device_raises_when_cuda_absent(tile, monkeypatch):
    from sagecal_tpu_torch.interop import tile_from_numpy
    from sagecal_tpu_torch.io.simulate import make_visdata
    from sagecal_tpu_torch.solvers.sage import SageConfig, solve_tile

    td, tc, tp = tile_from_numpy(tile[3], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_tile(td, tc, tp.numpy(), SageConfig(max_emiter=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_visdata(nstations=4)

