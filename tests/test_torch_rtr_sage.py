"""Port vs JAX package: ``sagefit`` in the RTR/NSD modes 4-6.

f64 torch-op on the ``tests/test_torch_rtr.py`` tile (two clusters, one
with two hybrid chunks): ``p`` and ``res_1`` within 1e-8 relative of the
JAX package, ``mean_nu`` equal.  f32 on the ``__graft_entry__`` tile,
fused and torch-op joint cost: within the 5e-3 bar of
``tests/test_torch_sage.py``.  ``sagefit_batched_fused`` in mode 5 with
B = 3 lanes against three solo solves (1e-5: the lanes differ from the
solo solves only in the lock-step batching of their joint LBFGS).
"""

import numpy as np
import pytest

from test_torch_rtr import F64_TOL, _rand_c, problem  # noqa: F401
from torch_port_common import rel

RES_TOL = 5e-3


def _port_fit(arrays, device="cpu", **kw):
    from sagecal_tpu_torch.interop import result_to_numpy, tile_from_numpy
    from sagecal_tpu_torch.solvers.sage import SageConfig, sagefit

    td, tc, tp = tile_from_numpy(arrays, device=device)
    return result_to_numpy(sagefit(td, tc, tp, SageConfig(**kw),
                                   device=device))


SAGE_KW = dict(max_emiter=2, max_iter=3, max_lbfgs=6, lbfgs_m=5)


@pytest.mark.parametrize("mode", [4, 5, 6])
def test_sagefit_rtr_modes_f64_match_jax(problem, mode):
    from sagecal_tpu.solvers.sage import SageConfig as JCfg, sagefit as jfit

    data, cdata, p0, arrays = problem
    kw = dict(SAGE_KW, solver_mode=mode)
    want = jfit(data, cdata, p0, JCfg(**kw))
    got = _port_fit(arrays, **kw)
    assert rel(got["res_0"], want.res_0) <= 1e-12
    assert rel(got["res_1"], want.res_1) <= F64_TOL
    assert rel(got["mean_nu"], want.mean_nu) <= 1e-12
    wp = np.asarray(want.p)
    assert np.abs(got["p"] - wp).max() <= F64_TOL * np.abs(wp).max()
    assert float(got["res_1"]) < float(got["res_0"])


@pytest.fixture(scope="module")
def entry_tile():
    from torch_port_common import jax_entry_tile

    return jax_entry_tile(np.float32)


@pytest.mark.parametrize("fused", [False, True], ids=["torch-ops", "fused"])
@pytest.mark.parametrize("mode", [4, 5, 6])
def test_sagefit_rtr_modes_f32_match_jax(entry_tile, mode, fused):
    from sagecal_tpu.solvers.sage import SageConfig as JCfg, sagefit as jfit

    data, cdata, p0, arrays = entry_tile
    kw = dict(max_emiter=2, max_iter=3, max_lbfgs=8, lbfgs_m=5,
              solver_mode=mode, use_fused_predict=fused)
    want = jfit(data, cdata, p0, JCfg(**kw))
    got = _port_fit(arrays, **kw)
    assert rel(got["res_0"], want.res_0) <= 1e-5
    assert rel(got["res_1"], want.res_1) <= RES_TOL
    assert np.abs(got["p"] - np.asarray(want.p)).max() <= RES_TOL
    assert float(got["res_1"]) < float(got["res_0"])


def test_batched_fused_mode5_matches_solo_solves(entry_tile):
    """A bucket of B = 3 lanes (the entry tile with three noise draws)
    in mode 5: each lane's result is its solo ``sagefit`` within 1e-5."""
    from sagecal_tpu_torch.interop import batch_from_numpy, tile_from_numpy
    from sagecal_tpu_torch.solvers.batched import derive_lane_generators
    from sagecal_tpu_torch.solvers.sage import (
        SageConfig, sagefit, sagefit_batched_fused,
    )

    arrays = entry_tile[3]
    rng = np.random.default_rng(11)
    lanes = []
    for b in range(3):
        a = dict(arrays)
        noise = _rand_c(rng, a["vis"].shape) * 1e-3
        a["vis"] = (a["vis"] + noise).astype(a["vis"].dtype)
        lanes.append(a)
    cfg = SageConfig(max_emiter=2, max_iter=3, max_lbfgs=8, lbfgs_m=5,
                     solver_mode=5, use_fused_predict=True)
    data, cdata, p0 = batch_from_numpy(lanes, device="cpu")
    gens = derive_lane_generators(0, range(3))
    got = sagefit_batched_fused(data, cdata, p0, cfg, gens, device="cpu")
    gens = derive_lane_generators(0, range(3))
    for b in range(3):
        td, tc, tp = tile_from_numpy(lanes[b], device="cpu")
        solo = sagefit(td, tc, tp, cfg, gens[b], device="cpu")
        assert rel(got.res_1[b], solo.res_1) <= 1e-5
        assert float((got.p[b] - solo.p).abs().max()) <= 1e-5
        assert float(got.res_1[b]) < float(got.res_0[b])
