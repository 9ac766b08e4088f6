"""Port vs JAX package: the batched serve solve (solvers/batched.py,
``sagefit_batched_fused``, serve/bucket.py).

The batch is the JAX tests' own (``_batched_solve_problem`` of
tests/test_rime_kernel.py: B = 3 same-geometry tiles, N = 5 stations,
M = 2 clusters, F = 2, tilesz = 2, f32), carried to the port through
``interop.batch_from_numpy``.  The JAX side runs its batched Pallas
kernels in interpret mode; the port side runs the plain version of its
batched kernels (CPU tensors).

Bars: the reference's own for its batched route
(tests/test_rime_kernel.py:945-946): ``p`` within 1e-4 and ``res_1``
within 1e-5 absolute.  Modes 1 and 2 with one EM pass draw no random
subsets, so the port is held to the JAX result; mode 3 runs OS-LM on
random subsets (``jax.random`` there, ``torch.Generator`` here), so the
port's batched route is held to its own per-lane torch-op route with the
same generators.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_rime_kernel import _batched_solve_problem
from torch_port_common import tile_arrays, to_np

P_ATOL = 1e-4
RES_ATOL = 1e-5
CFG = dict(max_emiter=1, max_iter=2, max_lbfgs=6, use_fused_predict=True)


@pytest.fixture(scope="module")
def problem():
    data_b, cdata_b, p0_b = _batched_solve_problem(seed=41)
    return data_b, cdata_b, p0_b, tile_arrays(data_b, cdata_b, p0_b)


def _port_solve(arrays, cfg, generators=None, valid=None, fused=True):
    from sagecal_tpu_torch.interop import batch_from_numpy
    from sagecal_tpu_torch.solvers.batched import sagefit_packed_batch

    data, cdata, p0 = batch_from_numpy(arrays, device="cpu")
    return sagefit_packed_batch(
        data, cdata, data.vis.real, data.vis.imag, cdata.coh.real,
        cdata.coh.imag, p0, cfg, generators, valid, batched_fused=fused,
        device="cpu")


@pytest.mark.parametrize("mode", [1, 2], ids=["mode1-lm", "mode2-robust"])
def test_batched_fused_solve_matches_jax(problem, mode):
    from sagecal_tpu.solvers.batched import sagefit_packed_batch as jsolve
    from sagecal_tpu.solvers.sage import SageConfig as JCfg
    from sagecal_tpu_torch.solvers.sage import SageConfig

    data_b, cdata_b, p0_b, arrays = problem
    keys = jax.random.split(jax.random.PRNGKey(5), p0_b.shape[0])
    want = jsolve(data_b.replace(vis=None), cdata_b._replace(coh=None),
                  jnp.real(data_b.vis), jnp.imag(data_b.vis),
                  jnp.real(cdata_b.coh), jnp.imag(cdata_b.coh), p0_b,
                  JCfg(solver_mode=mode, **CFG), keys, batched_fused=True)
    got = _port_solve(arrays, SageConfig(solver_mode=mode, **CFG))
    assert tuple(got.p.shape) == tuple(p0_b.shape)
    assert np.abs(to_np(got.p) - np.asarray(want.p)).max() <= P_ATOL
    assert np.abs(to_np(got.res_1) - np.asarray(want.res_1)).max() <= RES_ATOL
    np.testing.assert_allclose(to_np(got.res_0), np.asarray(want.res_0),
                               rtol=1e-5)
    assert (to_np(got.res_1) < to_np(got.res_0)).all()
    assert len(got.lbfgs_iterations) == 3
    assert set(got.phase_seconds) == {"em", "lbfgs"}


def test_mode3_fused_batch_agrees_with_per_lane_torch_op(problem):
    from sagecal_tpu_torch.solvers.batched import derive_lane_generators
    from sagecal_tpu_torch.solvers.sage import SageConfig

    cfg = SageConfig(solver_mode=3, **dict(CFG, max_emiter=2))
    fused = _port_solve(problem[3], cfg, derive_lane_generators(5, range(3)))
    per_lane = _port_solve(problem[3],
                           cfg.replace(use_fused_predict=False),
                           derive_lane_generators(5, range(3)), fused=False)
    assert (to_np(fused.res_1) < to_np(fused.res_0)).all()
    assert np.isfinite(to_np(fused.p)).all()
    assert np.abs(to_np(fused.p) - to_np(per_lane.p)).max() <= P_ATOL
    assert np.abs(to_np(fused.res_1) - to_np(per_lane.res_1)).max() <= RES_ATOL


def test_ragged_bucket_real_lanes_match_the_full_bucket(problem):
    """Two real requests padded to three lanes (``pad_indices``, the
    ``valid`` guard) give the real lanes what a two-lane bucket gives."""
    from sagecal_tpu_torch.serve.bucket import pad_indices
    from sagecal_tpu_torch.solvers.batched import derive_lane_generators
    from sagecal_tpu_torch.solvers.sage import SageConfig

    arrays = problem[3]
    lane = lambda i: {k: (v[i] if isinstance(v, np.ndarray) else v)
                      for k, v in arrays.items()}
    cfg = SageConfig(solver_mode=3, **dict(CFG, max_emiter=2))
    idx, valid = pad_indices(2, 3)
    assert idx == [0, 1, 0] and valid.tolist() == [True, True, False]
    ragged = _port_solve([lane(i) for i in idx], cfg,
                         derive_lane_generators(9, idx), valid=valid)
    full = _port_solve([lane(0), lane(1)], cfg,
                       derive_lane_generators(9, [0, 1]))
    np.testing.assert_allclose(to_np(ragged.res_1)[:2], to_np(full.res_1),
                               rtol=1e-6, atol=0)


def _router_case(B=3, M=2, N=5, nchunk=1, dtype=np.float32, shared=True):
    rows = 6
    ant_p = np.tile(np.arange(rows) % (N - 1), (B, 1))
    if not shared:
        ant_p[1, 0] += 1
    data = types.SimpleNamespace(ant_p=ant_p, ant_q=ant_p + 1)
    return data, None, np.zeros((B, M, nchunk, 8 * N), dtype)


ROUTES = {
    "fused-off": (_router_case(), dict(use_fused_predict=False)),
    "f64": (_router_case(dtype=np.float64), {}),
    "param-bound": (_router_case(), dict(param_bound=1.0)),
    "telemetry": (_router_case(), dict(collect_telemetry=True)),
    "hybrid-chunks": (_router_case(nchunk=2), {}),
    "unshared-baselines": (_router_case(shared=False), {}),
    "all-pass": (_router_case(), {}),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_choose_batched_path_matches_jax(case):
    from sagecal_tpu.solvers.batched import choose_batched_path as jroute
    from sagecal_tpu.solvers.sage import SageConfig as JCfg
    from sagecal_tpu_torch.solvers.batched import choose_batched_path
    from sagecal_tpu_torch.solvers.sage import SageConfig

    (data, cdata, p0), kw = ROUTES[case]
    kw = dict(dict(use_fused_predict=True), **kw)
    want = jroute(data, cdata, p0, JCfg(**kw))
    assert choose_batched_path(data, cdata, p0, SageConfig(**kw)) == want
    assert choose_batched_path(data, cdata, torch.from_numpy(p0),
                               SageConfig(**kw)) == want


def test_vmem_bound_is_a_tpu_limit_the_port_does_not_have():
    """B * pad8(M) = 14 * 8 = 112 rows pass the reference's 104-row VMEM
    bound, so the JAX router sends the bucket to its solo fused kernels;
    the CUDA kernels have no such bound, so the port keeps it batched."""
    from sagecal_tpu.solvers.batched import choose_batched_path as jroute
    from sagecal_tpu.solvers.sage import SageConfig as JCfg
    from sagecal_tpu_torch.solvers.batched import choose_batched_path
    from sagecal_tpu_torch.solvers.sage import SageConfig

    data, cdata, p0 = _router_case(B=14, M=8)
    jpath, jreason = jroute(data, cdata, p0, JCfg(use_fused_predict=True))
    assert jpath == "fused" and "VMEM" in jreason
    assert choose_batched_path(data, cdata, p0,
                               SageConfig(use_fused_predict=True)) == (
        "fused_batch", "all batched-kernel capability checks passed")


def test_bucket_of_and_pad_indices_match_jax(problem):
    from sagecal_tpu.serve.bucket import bucket_of as jbucket
    from sagecal_tpu.serve.bucket import pad_indices as jpad
    from sagecal_tpu_torch.interop import batch_from_numpy
    from sagecal_tpu_torch.serve import bucket_of, pad_indices
    from sagecal_tpu_torch.solvers.sage import lane_of

    data_b, cdata_b, p0_b, arrays = problem
    lane0 = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)
    want = jbucket(lane0(data_b), lane0(cdata_b), np.asarray(p0_b[0]))
    data, cdata, p0 = batch_from_numpy(arrays, device="cpu")
    assert bucket_of(lane_of(data, 0), lane_of(cdata, 0), p0[0]) == want
    assert bucket_of(lane_of(data, 0), lane_of(cdata, 0),
                     to_np(p0[0])) == want
    assert bucket_of(lane_of(data, 2), lane_of(cdata, 2), p0[2]).short() == (
        want.short())
    for k, batch in ((1, 4), (3, 4), (4, 4), (5, 4)):
        got_idx, got_valid = pad_indices(k, batch)
        want_idx, want_valid = jpad(k, batch)
        assert got_idx == want_idx
        np.testing.assert_array_equal(got_valid, want_valid)
    with pytest.raises(ValueError):
        pad_indices(0, 4)


def test_lane_generators_depend_on_the_lane_not_its_slot():
    from sagecal_tpu_torch.solvers.batched import derive_lane_generators

    draw = lambda g: torch.rand(4, generator=g).tolist()
    a = [draw(g) for g in derive_lane_generators(7, [3, 5])]
    b = [draw(g) for g in derive_lane_generators(7, [5, 3])]
    assert a[0] == b[1] and a[1] == b[0]
    assert a[0] != a[1]
    assert draw(derive_lane_generators(8, [3])[0]) != a[0]


def test_batch_from_numpy_list_equals_stacked_dict(problem):
    from sagecal_tpu_torch.interop import batch_from_numpy

    arrays = problem[3]
    lanes = [{k: (v[i] if isinstance(v, np.ndarray) else v)
              for k, v in arrays.items()} for i in range(3)]
    d1, c1, p1 = batch_from_numpy(arrays, device="cpu")
    d2, c2, p2 = batch_from_numpy(lanes, device="cpu")
    for k in ("vis", "mask", "ant_p", "time_idx", "u"):
        assert torch.equal(getattr(d1, k), getattr(d2, k))
    assert torch.equal(c1.coh, c2.coh) and torch.equal(p1, p2)
    assert d2.tilesz == arrays["tilesz"] and tuple(p2.shape) == (3, 2, 1, 40)
    lanes[1]["freq0"] = 1.0
    with pytest.raises(ValueError, match="freq0"):
        batch_from_numpy(lanes, device="cpu")


def test_batched_fused_refusals(problem):
    from sagecal_tpu_torch.interop import batch_from_numpy
    from sagecal_tpu_torch.solvers.sage import SageConfig, sagefit_batched_fused

    data, cdata, p0 = batch_from_numpy(problem[3], device="cpu")
    cfg = SageConfig(**CFG)
    with pytest.raises(ValueError, match="nchunk_max"):
        sagefit_batched_fused(data, cdata, p0.repeat(1, 1, 2, 1), cfg,
                              device="cpu")
    for kw in (dict(param_bound=1.0), dict(collect_telemetry=True)):
        with pytest.raises(ValueError, match="param_bound"):
            sagefit_batched_fused(data, cdata, p0, cfg.replace(**kw),
                                  device="cpu")
    # collect_quality, refused until it was ported, now runs
    out = sagefit_batched_fused(data, cdata, p0,
                                cfg.replace(collect_quality=True),
                                device="cpu")
    assert out.quality["final"].chi2_station.shape[0] == p0.shape[0]
