"""Port vs JAX package: the consensus math (``parallel/consensus.py``),
the manifold average (``parallel/manifold.py``), the AIC/MDL order scan
(``parallel/spatial.py``), the bounded-staleness ledger
(``parallel/async_consensus.py``) and the ADMM watchdog
(``obs/quality.py::assess_consensus``).

The same numpy inputs, made from seeds, go through both packages at
f64.  Bars: 1e-12 relative (of the largest magnitude) for the consensus
functions, 1e-10 for the manifold average.  The port's 2x2 polar factor
is a closed form where the JAX package takes an SVD; on a singular
input the two may pick different unitaries, so the rank-deficient cases
hold the projected blocks ``J U``, which are unique when J itself is
rank-deficient.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = 1e-12
MTOL = 1e-10


def _close(a, b, tol=TOL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    err = float(np.max(np.abs(a - b))) / scale
    assert err < tol, err


def _t(x):
    return torch.from_numpy(np.array(x))


FREQS = np.linspace(120e6, 180e6, 6)


@pytest.mark.parametrize("ptype", [0, 1, 2, 3],
                         ids=["ordinary", "normalized", "bernstein",
                              "rational"])
def test_setup_polynomials_every_basis(ptype):
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu_torch.parallel import consensus as tc

    for npoly in (1, 2, 3, 4):
        _close(tc.setup_polynomials(FREQS, 150e6, npoly, ptype),
               jc.setup_polynomials(FREQS, 150e6, npoly, ptype))


@pytest.mark.parametrize("case", ["full", "singular_nf", "zero_band"])
def test_prod_inverses_match_jax_pinv(case):
    """pinv(sum w B B^T) and its per-cluster form, full rank and
    singular (fewer bands than polynomial terms, a zero-weight band)."""
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu_torch.parallel import consensus as tc

    rng = np.random.default_rng(1)
    freqs = FREQS[:2] if case == "singular_nf" else FREQS
    B = np.asarray(jc.setup_polynomials(freqs, 150e6, 3, 0))
    w = rng.uniform(0.5, 1.0, len(freqs))
    rho = rng.uniform(1.0, 20.0, (len(freqs), 4))
    if case == "zero_band":
        w[2] = 0.0
        rho[2] = 0.0
        B = np.asarray(jc.setup_polynomials(freqs[:3], 150e6, 4, 0))
        B = np.concatenate([B, B[-1:]], axis=0)[:4]
        w, rho = w[:4], rho[:4]
        w[1:] = 0.0
        rho[1:] = 0.0
    _close(tc.find_prod_inverse(_t(B), _t(w)),
           jc.find_prod_inverse(jnp.asarray(B), jnp.asarray(w)))
    _close(tc.find_prod_inverse(_t(B)), jc.find_prod_inverse(jnp.asarray(B)))
    _close(tc.find_prod_inverse_full(_t(B), _t(rho)),
           jc.find_prod_inverse_full(jnp.asarray(B), jnp.asarray(rho)))
    alpha = rng.uniform(0.1, 2.0, 4)
    _close(tc.find_prod_inverse_full(_t(B), _t(rho), _t(alpha)),
           jc.find_prod_inverse_full(jnp.asarray(B), jnp.asarray(rho),
                                     jnp.asarray(alpha)))


def test_z_accumulate_update_and_target():
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu_torch.parallel import consensus as tc

    rng = np.random.default_rng(2)
    B = np.asarray(jc.setup_polynomials(FREQS, 150e6, 3, 2))
    Yrho = rng.standard_normal((4, 48))
    Bii = rng.standard_normal((4, 3, 3))
    z = rng.standard_normal((4, 3, 48))
    _close(tc.accumulate_z_term(_t(B[2]), _t(Yrho)),
           jc.accumulate_z_term(jnp.asarray(B[2]), jnp.asarray(Yrho)))
    _close(tc.update_global_z(_t(z), _t(Bii)),
           jc.update_global_z(jnp.asarray(z), jnp.asarray(Bii)))
    _close(tc.bz_for_freq(_t(z), _t(B[4])),
           jc.bz_for_freq(jnp.asarray(z), jnp.asarray(B[4])))
    _close(tc.soft_threshold(_t(z), 0.3), jc.soft_threshold(jnp.asarray(z),
                                                            0.3))
    _close(tc.admm_dual_residual(_t(z), _t(z[::-1])),
           jc.admm_dual_residual(jnp.asarray(z), jnp.asarray(z[::-1])))
    J, BZ = rng.standard_normal((2, 5, 16))
    _close(tc.admm_primal_residual(_t(J), _t(BZ)),
           jc.admm_primal_residual(jnp.asarray(J), jnp.asarray(BZ)))
    _close(tc.admm_primal_residual(_t(J[0]), _t(BZ[0])),
           jc.admm_primal_residual(jnp.asarray(J[0]), jnp.asarray(BZ[0])))


def test_update_rho_bb_accepts_and_rejects_like_jax():
    """Correlated deltas (accepted), anti-correlated (rejected), a
    converged cluster (dJ under the floor: kept) and an alpha above the
    upper bound (kept)."""
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu_torch.parallel import consensus as tc

    rng = np.random.default_rng(3)
    dJ = rng.standard_normal((4, 32)) * np.asarray([1, 1, 1e-9, 1])[:, None]
    dY = np.stack([5.0 * dJ[0] + 0.1 * rng.standard_normal(32),
                   -3.0 * dJ[1], 4.0 * dJ[2], 5e3 * dJ[3]])
    rho = np.asarray([2.0, 3.0, 4.0, 5.0])
    up = np.full(4, 1e3)
    got = tc.update_rho_bb(_t(rho), _t(up), _t(dY), _t(dJ))
    want = jc.update_rho_bb(jnp.asarray(rho), jnp.asarray(up),
                            jnp.asarray(dY), jnp.asarray(dJ))
    _close(got, want)
    assert float(got[0]) != 2.0 and list(got[1:].tolist()) == [3.0, 4.0, 5.0]


def test_staleness_ages_and_weights():
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu_torch.parallel import consensus as tc

    for g in range(4):
        np.testing.assert_array_equal(
            tc.slot_staleness_ages(g, 4).numpy(),
            np.asarray(jc.slot_staleness_ages(g, 4)))
    ages = np.asarray([0, 1, 2, 3, 5])
    for st, disc in ((None, 1.0), (2, 0.5), (None, 0.7), (0, 1.0)):
        _close(tc.staleness_weights(_t(ages), st, disc),
               jc.staleness_weights(jnp.asarray(ages), st, disc))


def _traj(rng, nadmm=6, nf=4):
    pr = np.abs(rng.standard_normal((nadmm, nf))) + 0.1
    du = np.abs(rng.standard_normal((nadmm, nf))) + 0.1
    pr[-1, 1] = 10.0 * pr[:, 1].min()  # band 1 moved away
    return pr, du


def test_consensus_health_and_watchdog_match_jax():
    from sagecal_tpu.obs.quality import assess_consensus as jassess
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu_torch.obs.quality import assess_consensus
    from sagecal_tpu_torch.parallel import consensus as tc

    rng = np.random.default_rng(4)
    pr, du = _traj(rng)
    pr_nan = pr.copy()
    pr_nan[2, 3] = np.nan
    ages = np.asarray([0, 3, 1, 6])
    for kw in (dict(), dict(ages=ages), dict(ages=ages, staleness=4),
               dict(trend_thresh=20.0)):
        for p in (pr, pr_nan):
            got = tc.consensus_health(p, du, **kw)
            want = jc.consensus_health(jnp.asarray(p), jnp.asarray(du), **kw)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, np.asarray(b), rtol=TOL)
            v, r, h = assess_consensus(p, du, **kw)
            vj, rj, hj = jassess(p, du, **kw)
            assert (v, r) == (vj, rj)
            np.testing.assert_array_equal(h["diverged"], hj["diverged"])
    assert assess_consensus(pr, du)[0] == "diverged"


def test_band_imbalance_matches_jax():
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu_torch.parallel import consensus as tc

    t = np.asarray([1.0, 2.5, 1.2, 0.9])
    got = tc.band_imbalance(t)
    want = jc.band_imbalance(jnp.asarray(t))
    np.testing.assert_allclose(got[:2], [float(x) for x in want[:2]],
                               rtol=TOL)
    assert got[2] == int(want[2])


# ------------------------------------------------------------ manifold


def _rand_c(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_polar_factor_full_rank_and_unitary():
    from sagecal_tpu.parallel import manifold as jm
    from sagecal_tpu_torch.parallel import manifold as tm

    rng = np.random.default_rng(5)
    A = _rand_c(rng, (64, 2, 2))
    U = tm.polar_unitary_2x2(_t(A)).numpy()
    np.testing.assert_allclose(U @ np.conj(np.swapaxes(U, -1, -2)),
                               np.broadcast_to(np.eye(2), U.shape),
                               atol=1e-13)
    _close(U, jm.polar_unitary_2x2(jnp.asarray(A)), MTOL)


def test_procrustes_rank_deficient_block():
    """J of rank 1 (one station column zero, or the two columns
    parallel): A = J^H J_ref is singular, and J U is still unique."""
    from sagecal_tpu.parallel import manifold as jm
    from sagecal_tpu_torch.parallel import manifold as tm

    rng = np.random.default_rng(6)
    J = _rand_c(rng, (3, 16, 2))
    J[0, :, 1] = 0.0
    J[1, :, 1] = (0.3 - 0.2j) * J[1, :, 0]
    J[2] = 0.0
    J_ref = _rand_c(rng, (3, 16, 2))
    _close(tm.procrustes_project(_t(J), _t(J_ref)),
           jm.procrustes_project(jnp.asarray(J), jnp.asarray(J_ref)), MTOL)
    # the zero block maps to the identity, as a unitary must
    U0 = tm.polar_unitary_2x2(torch.zeros((2, 2), dtype=torch.complex128))
    np.testing.assert_array_equal(U0.numpy(), np.eye(2))


def _rotated_copies(rng, Nf=5, M=3, N=6, noise=0.0):
    """Nf copies of one Jones set, each right-multiplied by a random
    unitary (per cluster), plus noise."""
    base = _rand_c(rng, (M, N, 2, 2))
    out = []
    for _ in range(Nf):
        q, _ = np.linalg.qr(_rand_c(rng, (M, 2, 2)))
        out.append(base @ q[:, None] + noise * _rand_c(rng, (M, N, 2, 2)))
    return np.stack(out)


@pytest.mark.parametrize("noise", [0.0, 0.05], ids=["exact", "noisy"])
def test_manifold_average_rotated_copies(noise):
    from sagecal_tpu.parallel import manifold as jm
    from sagecal_tpu_torch.parallel import manifold as tm

    rng = np.random.default_rng(7)
    Y = _rotated_copies(rng, noise=noise)
    got = tm.manifold_average(_t(Y), niter=20)
    _close(got, jm.manifold_average(jnp.asarray(Y), niter=20), MTOL)
    if noise == 0.0:  # the copies align onto one another
        g = got.numpy()
        np.testing.assert_allclose(g, np.broadcast_to(g[:1], g.shape),
                                   atol=1e-10)
    Ym = np.moveaxis(Y, 1, 0)[0]
    a, m = tm.manifold_average_cluster(_t(Ym), niter=5, ref_idx=2)
    aj, mj = jm.manifold_average_cluster(jnp.asarray(Ym), niter=5,
                                         ref_idx=2)
    _close(a, aj, MTOL)
    _close(m, mj, MTOL)


def test_manifold_average_rank_deficient_block():
    """One band's Jones of rank 1 at every station (its second column
    parallel to the first): its own projection is unique."""
    from sagecal_tpu.parallel import manifold as jm
    from sagecal_tpu_torch.parallel import manifold as tm

    rng = np.random.default_rng(8)
    Y = _rotated_copies(rng, noise=0.02)
    Y[3, :, :, :, 1] = (0.5 + 0.1j) * Y[3, :, :, :, 0]
    _close(tm.manifold_average(_t(Y), niter=10),
           jm.manifold_average(jnp.asarray(Y), niter=10), MTOL)


def test_manifold_average_projectback():
    from sagecal_tpu.parallel import manifold as jm
    from sagecal_tpu_torch.parallel import manifold as tm

    rng = np.random.default_rng(9)
    Y = _rotated_copies(rng, noise=0.05)
    _close(tm.manifold_average_projectback(_t(Y), niter=10),
           jm.manifold_average_projectback(jnp.asarray(Y), niter=10), MTOL)


# ------------------------------------------------------- MDL and ledger


def test_mdl_order_scan_matches_jax():
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu.parallel.spatial import (
        minimum_description_length as jmdl,
    )
    from sagecal_tpu_torch.parallel.spatial import minimum_description_length

    rng = np.random.default_rng(10)
    B = np.asarray(jc.setup_polynomials(FREQS, 150e6, 2, 2))
    Zt = rng.standard_normal((3, 2, 16))
    J = np.einsum("fp,mpk->fmk", B, Zt) + 0.01 * rng.standard_normal(
        (6, 3, 16))
    rho = np.asarray([5.0, 2.0, 8.0])
    w = np.asarray([1.0, 0.9, 0.0, 0.8, 1.0, 0.7])
    J = J * w[:, None, None] * rho[None, :, None]
    got = minimum_description_length(J, rho, FREQS, 150e6, weight=w,
                                     Kstart=1, Kfinish=4)
    want = jmdl(jnp.asarray(J), rho, FREQS, 150e6, weight=w, Kstart=1,
                Kfinish=4)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=TOL)
    assert got[2:] == want[2:]


def test_async_periods_and_activity_match_jax():
    from sagecal_tpu.parallel import async_consensus as ja
    from sagecal_tpu_torch.parallel import async_consensus as ta

    for w, k in (([100, 300, 90, 0], 2), ([5, 5, 5], 0), ([1, 7, 2], 9)):
        per = ta.refresh_periods(w, k)
        np.testing.assert_array_equal(per, ja.refresh_periods(w, k))
        for r in range(6):
            np.testing.assert_array_equal(ta.band_active(r, per),
                                          ja.band_active(r, per))


def test_staleness_ledger_and_weighted_z_match_jax():
    """One ledger history through both packages (and across them by the
    interop converters): ages, weights, the stale-weighted Z."""
    from sagecal_tpu.parallel import async_consensus as ja
    from sagecal_tpu.parallel import consensus as jc
    from sagecal_tpu_torch.interop import ledger_from_numpy, ledger_to_numpy
    from sagecal_tpu_torch.parallel import async_consensus as ta

    rng = np.random.default_rng(11)
    nb, shape = 4, (2, 3, 8)
    lj = ja.StalenessLedger(nb, shape, np.float64)
    lt = ta.StalenessLedger(nb, shape, np.float64)
    for r in range(5):
        for b in range(nb):
            if (r + b) % (b + 1) == 0:
                z = rng.standard_normal(shape)
                lj.record(b, z)
                lt.record(b, torch.from_numpy(z))
        lj.advance()
        lt.advance()
        for st, disc in ((None, 1.0), (1, 0.5), (2, 0.8)):
            np.testing.assert_allclose(lt.weights(st, disc),
                                       lj.weights(st, disc), rtol=TOL)
    B = np.asarray(jc.setup_polynomials(FREQS[:nb], 150e6, 3, 0))
    rho = rng.uniform(1, 10, (nb, 2))
    for w in (lj.weights(1, 0.5), np.zeros(nb)):
        _close(ta.stale_weighted_z(lt, _t(B), _t(rho), w),
               ja.stale_weighted_z(lj, jnp.asarray(B), jnp.asarray(rho), w))
    back = ledger_from_numpy(lj)
    np.testing.assert_array_equal(back.ages, lj.ages)
    np.testing.assert_array_equal(back.zterms, lj.zterms)
    assert back.round_index == lj.round_index == 5
    rt = ta.StalenessLedger.from_arrays(lt.to_arrays())
    assert ledger_to_numpy(rt)["round_index"] == 5
    np.testing.assert_array_equal(rt.zterms, lt.zterms)
