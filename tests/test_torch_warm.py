"""Port vs JAX package: a warm-started tile.

Each package solves the ``__graft_entry__.entry()`` tile (8 stations, 2
point clusters, f32; config as ``tests/test_torch_sage.py``'s
``ENTRY_KW``), then solves it again starting from its own solution.
The warm solve must not raise the residual (warm ``res_1 <= res_0``) in
either package, and the port's warm solve is held to the JAX package's
with the bar of ``test_sagefit_matches_jax``: ``res_1`` within 5e-3
relative, ``p`` within 5e-3 absolute.  The round-5 TPU fault this
guards against was a selection rounded to ~3 digits, which made a warm
start diverge (PERF.md, appendix).
"""

import numpy as np
import pytest

import jax  # noqa: F401  (both packages in one process; JAX on the CPU)

from torch_port_common import jax_entry_tile, rel

ENTRY_KW = dict(max_iter=5, max_lbfgs=8, lbfgs_m=5)
RES_TOL = 5e-3
P_ATOL = 5e-3


@pytest.fixture(scope="module")
def tile():
    return jax_entry_tile(np.float32)


def _port_chain(arrays, kw):
    from sagecal_tpu_torch.interop import result_to_numpy, tile_from_numpy
    from sagecal_tpu_torch.solvers.sage import SageConfig, sagefit

    td, tc, tp = tile_from_numpy(arrays, device="cpu")
    cfg = SageConfig(**kw)
    cold = sagefit(td, tc, tp, cfg, device="cpu")
    warm = sagefit(td, tc, cold.p, cfg, device="cpu")
    return result_to_numpy(cold), result_to_numpy(warm)


def _jax_chain(data, cdata, p0, kw):
    from sagecal_tpu.solvers.sage import SageConfig, sagefit

    cfg = SageConfig(**kw)
    cold = sagefit(data, cdata, p0, cfg)
    return cold, sagefit(data, cdata, cold.p, cfg)


@pytest.mark.parametrize("fused", [False, True], ids=["torch-ops", "fused"])
@pytest.mark.parametrize("mode,emiter", [(1, 2), (2, 1)],
                         ids=["mode1-lm", "mode2-robust"])
def test_warm_started_tile_matches_jax(tile, mode, emiter, fused):
    data, cdata, p0, arrays = tile
    kw = dict(ENTRY_KW, max_emiter=emiter, solver_mode=mode,
              use_fused_predict=fused)
    jcold, jwarm = _jax_chain(data, cdata, p0, kw)
    cold, warm = _port_chain(arrays, kw)
    # the warm solve starts where the cold one ended, in each package
    assert rel(warm["res_0"], cold["res_1"]) <= 1e-5
    assert rel(jwarm.res_0, jcold.res_1) <= 1e-5
    assert float(jwarm.res_1) <= float(jwarm.res_0)
    assert float(warm["res_1"]) <= float(warm["res_0"])
    assert rel(warm["res_1"], jwarm.res_1) <= RES_TOL
    assert np.abs(warm["p"] - np.asarray(jwarm.p)).max() <= P_ATOL
    assert np.isfinite(warm["p"]).all()
