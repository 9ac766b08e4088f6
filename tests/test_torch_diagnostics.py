"""Port vs JAX package: ``ops/diagnostics.py`` (the ``-i`` influence
function).

Both packages compute in complex64 (the JAX package does so even at
float64), on the same seeded numpy inputs:

- ``_cluster_hessian``: within 1e-5 of the JAX package's Frobenius norm
  (complex64 sums over rows in another order: measured ~1e-7);
- the minimum-norm least squares: against ``jnp.linalg.lstsq`` on a
  cluster's H, within 1e-4 of the solution's norm (both an SVD with the
  same cutoff; complex64 SVDs agree to ~1e-6), and against float64
  ``np.linalg.pinv`` on a rank-deficient matrix;
- the influence eigenvalues, per correlation, as multisets (an optimal
  one-to-one matching, since numpy's order is the implementation's):
  within 1e-4 of the largest |lambda| (measured ~1e-6 relative); each
  correlation's sum equal to the trace of its dR within 1e-4 of max
  |lambda| (the JAX test's invariant).
"""

import numpy as np
import pytest
import torch

from torch_port_common import tile_arrays, to_np

H_TOL = 1e-5
LSTSQ_TOL = 1e-4
EIG_TOL = 1e-4


def _tile(N=5, T=2, M=1, seed=0):
    """A JAX-made tile of M point clusters under true gains; the truth as
    the solution (the JAX test's setup), and the port's copy."""
    import jax.numpy as jnp

    from sagecal_tpu.core.types import jones_to_params
    from sagecal_tpu.io.simulate import (
        corrupt_and_observe, make_visdata, random_jones,
    )
    from sagecal_tpu.ops.rime import point_source_batch
    from sagecal_tpu.solvers.sage import build_cluster_data
    from sagecal_tpu_torch.interop import tile_from_numpy

    d = make_visdata(nstations=N, tilesz=T, nchan=1, seed=seed,
                     dtype=np.float64)
    rng = np.random.default_rng(seed + 10)
    srcs = [point_source_batch([rng.uniform(-0.02, 0.02)],
                               [rng.uniform(-0.02, 0.02)],
                               [rng.uniform(1.0, 3.0)], dtype=jnp.float64)
            for _ in range(M)]
    J = random_jones(M, N, seed=seed + 1, amp=0.2, dtype=np.complex128)
    obs = corrupt_and_observe(d, srcs, jones=J, noise_sigma=1e-3,
                              seed=seed + 2)
    cdata = build_cluster_data(obs, srcs, [1] * M)
    p = jones_to_params(J)[:, None, :]
    port = tile_from_numpy(tile_arrays(obs, cdata, p), "cpu")
    return (obs, cdata, p), port


def _rand_c64(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_cluster_hessian_matches_jax():
    import jax.numpy as jnp

    from sagecal_tpu.ops import diagnostics as jd
    from sagecal_tpu_torch.ops import diagnostics as td

    rng = np.random.default_rng(1)
    N, rows = 6, 45
    ap = rng.integers(0, N, rows)
    aq = (ap + rng.integers(1, N, rows)) % N
    C, R, Jp, Jq = (_rand_c64(rng, rows, 2, 2) for _ in range(4))
    want = np.asarray(jd._cluster_hessian(
        *map(jnp.asarray, (C, R, Jp, Jq, ap, aq)), N))
    args = [torch.from_numpy(a) for a in (C, R, Jp, Jq, ap, aq)]
    got = to_np(td._cluster_hessian(*args, N))
    assert got.dtype == np.complex64 and got.shape == (4 * N, 4 * N)
    assert np.linalg.norm(got - want) <= H_TOL * np.linalg.norm(want)
    # a plan built once gives the same bits as one built per call
    plan = td.HessianPlan(args[4], args[5], N)
    np.testing.assert_array_equal(to_np(td._cluster_hessian(*args, N, plan)),
                                  got)
    # one complex64 product per entry: the rounding of the complex
    # multiply (XLA's and torch's may fuse differently)
    want_k = np.asarray(jd._kron4(jnp.asarray(C), jnp.asarray(R)))
    np.testing.assert_allclose(to_np(td._kron4(args[0], args[1])), want_k,
                               rtol=0, atol=1e-6 * np.abs(want_k).max())


def test_condition_diag_and_consensus_curvature_match_jax():
    import jax.numpy as jnp

    from sagecal_tpu.ops import diagnostics as jd
    from sagecal_tpu_torch.ops import diagnostics as td

    rng = np.random.default_rng(2)
    H = _rand_c64(rng, 12, 12)
    H[[3, 7], [3, 7]] = 1e-7  # a flagged station's zero diagonal
    Bpoly, Binv = rng.uniform(0, 1, 3), rng.uniform(-0.2, 0.2, (3, 3))
    extra_j = jd.consensus_hessian_addition(2.5, jnp.asarray(Bpoly),
                                            jnp.asarray(Binv))
    extra_t = td.consensus_hessian_addition(2.5, torch.from_numpy(Bpoly),
                                            torch.from_numpy(Binv))
    np.testing.assert_allclose(float(extra_t), float(extra_j), rtol=1e-12)
    for ej, et in ((0.0, 0.0), (extra_j, extra_t)):
        want = np.asarray(jd._condition_diag(jnp.asarray(H), ej))
        got = to_np(td._condition_diag(torch.from_numpy(H),
                                       float(et)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_lstsq_min_norm_matches_jax_on_a_cluster_hessian():
    """The influence function's own H and right-hand sides, at
    complex64."""
    import jax.numpy as jnp

    from sagecal_tpu_torch.ops import diagnostics as td
    from sagecal_tpu_torch.solvers.sage import predict_full_model
    from sagecal_tpu_torch.core.types import params_to_jones

    _, (data, cdata, p) = _tile(N=6, T=2)
    N, rows = data.nstations, data.rows
    mat = lambda f: f.transpose(0, 1).reshape(rows, 2, 2)  # noqa: E731
    R = mat((data.vis - predict_full_model(p, cdata, data))[0]).to(
        torch.complex64)
    C = mat(cdata.coh[0, 0]).to(torch.complex64)
    jones = params_to_jones(p[0]).to(torch.complex64)[0]
    H = td._condition_diag(td._cluster_hessian(
        C, R, jones[data.ant_p], jones[data.ant_q], data.ant_p, data.ant_q,
        N))
    rng = np.random.default_rng(3)
    b = _rand_c64(rng, 4 * N, data.nbase)
    want = np.asarray(jnp.linalg.lstsq(jnp.asarray(to_np(H)),
                                       jnp.asarray(b))[0])
    got = to_np(td._lstsq_min_norm(H, torch.from_numpy(b)))
    assert np.linalg.norm(got - want) <= LSTSQ_TOL * np.linalg.norm(want)


def test_lstsq_min_norm_on_a_rank_deficient_matrix():
    """Rank 9 of 16: the minimum-norm solution (the pseudo-inverse's),
    which a full-rank QR solve would not give."""
    from sagecal_tpu_torch.ops import diagnostics as td

    rng = np.random.default_rng(4)
    A = (rng.standard_normal((16, 9)) @ rng.standard_normal((9, 16))
         + 1j * rng.standard_normal((16, 9)) @ rng.standard_normal((9, 16)))
    A = A.astype(np.complex64)
    b = _rand_c64(rng, 16, 5)
    want = np.linalg.pinv(A.astype(np.complex128), rcond=1e-5) @ b
    got = to_np(td._lstsq_min_norm(torch.from_numpy(A), torch.from_numpy(b)))
    assert np.linalg.norm(got - want) <= LSTSQ_TOL * np.linalg.norm(want)


def _multiset_gap(got, want) -> float:
    """Largest distance of an optimal one-to-one matching of two sets of
    complex numbers."""
    from scipy.optimize import linear_sum_assignment

    cost = np.abs(got[:, None] - want[None, :])
    r, c = linear_sum_assignment(cost)
    return float(cost[r, c].max())


def _capture_eigvals(monkeypatch):
    """Record each eigensolve's input trace and eigenvalue sum."""
    seen = []
    orig = np.linalg.eigvals

    def capture(mat):
        lam = orig(mat)
        seen.append((np.trace(mat), lam.sum()))
        return lam

    monkeypatch.setattr(np.linalg, "eigvals", capture)
    return seen


@pytest.mark.parametrize("N,T,M", [(5, 2, 1), (7, 3, 3), (8, 2, 2)])
def test_influence_matches_jax(N, T, M, monkeypatch):
    from sagecal_tpu.ops.diagnostics import influence_function as jinf
    from sagecal_tpu_torch.ops import diagnostics as td

    (obs, cdata, p), (data, cd, pt) = _tile(N=N, T=T, M=M, seed=N)
    want = jinf(obs, cdata, p)
    seen = _capture_eigvals(monkeypatch)
    got = td.influence_function(data, cd, pt)
    assert got.shape == want.shape == (1, 4, data.rows)
    assert np.isfinite(got).all()
    Bt = data.nbase
    for c in range(4):
        g, w = got[0, c, :Bt], want[0, c, :Bt]
        scale = np.abs(w).max()
        assert scale > 1e-8  # the calibration has leverage
        assert _multiset_gap(g, w) <= EIG_TOL * scale, c
        # the eigenvalues of baseline b repeat over the tile's timeslots
        np.testing.assert_array_equal(got[0, c].reshape(T, Bt),
                                      np.tile(g, (T, 1)))
    assert len(seen) == 4
    for (tr, s), c in zip(seen, range(4)):
        assert abs(s - tr) <= EIG_TOL * np.abs(want[0, c]).max()
    assert set(td.last_seconds) == {"residual", "hessian_lstsq", "dR", "eig",
                                    "total"}


def test_influence_two_channels_replicates():
    """F = 2: every channel carries channel 0's eigenvalues, as the
    reference."""
    import jax.numpy as jnp

    from sagecal_tpu.core.types import jones_to_params
    from sagecal_tpu.io.simulate import make_visdata, random_jones
    from sagecal_tpu.ops.diagnostics import influence_function as jinf
    from sagecal_tpu.ops.rime import point_source_batch
    from sagecal_tpu.solvers.sage import build_cluster_data
    from sagecal_tpu_torch.interop import tile_from_numpy
    from sagecal_tpu_torch.ops.diagnostics import influence_function as tinf

    d = make_visdata(nstations=5, tilesz=2, nchan=2, seed=1, dtype=np.float64)
    src = point_source_batch([0.01], [0.005], [2.0], dtype=jnp.float64)
    J = random_jones(1, 5, seed=2, amp=0.2, dtype=np.complex128)
    cdata = build_cluster_data(d, [src], [1])
    p = jones_to_params(J)[:, None, :]
    want = jinf(d, cdata, p)
    got = tinf(*tile_from_numpy(tile_arrays(d, cdata, p), "cpu"))
    np.testing.assert_array_equal(got[0], got[1])
    for c in range(4):
        assert _multiset_gap(got[0, c, :10], want[0, c, :10]) <= (
            EIG_TOL * np.abs(want[0, c]).max())
