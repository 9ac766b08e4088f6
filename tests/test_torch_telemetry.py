"""Port vs JAX package: solver telemetry (``collect_trace`` /
``collect_telemetry``) and quality outputs (``collect_quality``).

The per-cluster solvers run on the ``tests/test_torch_rtr.py`` tile
(cluster 0: two hybrid chunks, f64) and LBFGS on Rosenbrock; ``sagefit``
runs on the same tile in modes 1, 2 (one EM pass) and 5.  Every trace
field has the JAX package's shape and NaN in the same places, and its
finite values agree within 1e-8 of the field's largest magnitude (the
solves themselves agree to 1e-8; tests/test_torch_lm.py,
test_torch_rtr.py).  Every quality field agrees to the same 1e-8.  The
flags change nothing else: ``p`` and ``res_1`` with both on are bit for
bit those with both off, and the RTR solver makes exactly as many host
reads.  ``sagefit_batched_fused``'s per-lane quality is each lane's own
``sagefit`` quality.  The copied metrics registry gives the JAX
package's snapshot and Prometheus text; ``tools/solve_outputs.py
compare`` tells equal saves from different ones.

One exception, in ``sagefit`` mode 5 only: once a converged lane's
trust-region step falls below 1e-9 (STEP_FLOOR), its cost changes by
less than f64 resolution, and whether the next step is accepted
(``fx_prop < fx``) is decided by rounding, which differs between the two
packages' summation orders; a lane may then run on to its iteration
bound in one package and stop in the other, on steps of ~1e-11.  Rows
from that point on are left out; every row before it is compared as
above, and the per-cluster convergence records, which concatenate those
rows, are held to their keys.  The solves still agree to 1e-8 (tests/test_torch_rtr_sage.py).
"""

import numpy as np
import pytest
import torch

from test_torch_rtr import _solver_args, problem  # noqa: F401
from torch_port_common import to_np

TOL = 1e-8
STEP_FLOOR = 1e-9


def _close_field(got, want, name, settled=None):
    """NaN in the same places, finite values within TOL of the field's
    largest magnitude; entries in ``settled`` are left out."""
    g, w = to_np(got).astype(np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    keep = np.ones(g.shape, bool)
    if settled is not None:
        keep = ~np.broadcast_to(settled, g.shape)
    assert (np.isnan(g) == np.isnan(w))[keep].all(), name
    fin = ~np.isnan(w) & keep
    if fin.any():
        scale = max(np.abs(w[fin]).max(), 1e-30)
        assert np.abs(g[fin] - w[fin]).max() <= TOL * scale, (
            name, np.abs(g[fin] - w[fin]).max(), scale)


def same_trace(got, want, floor=False):
    """Field by field; ``floor``: rows (axis -2) at and after a lane's
    first step below STEP_FLOOR are settled (module doc)."""
    settled = None
    if floor:
        step = np.asarray(want.step, np.float64)
        settled = np.maximum.accumulate(step < STEP_FLOOR, axis=-2)
    for name in want._fields:
        _close_field(getattr(got, name), getattr(want, name), name,
                     settled if np.ndim(getattr(want, name)) == np.ndim(
                         want.step) else None)


def same_quality(got, want):
    for name in want._fields:
        w = getattr(want, name)
        g = getattr(got, name)
        assert (g is None) == (w is None), name
        if w is not None:
            _close_field(g, w, name)


def _solvers(m, robust_mod, lm_mod):
    return {
        "lm": (lm_mod.lm_solve, dict(config=lm_mod.LMConfig(itmax=6)), False),
        "lm_dynamic": (lm_mod.lm_solve,
                       dict(config=lm_mod.LMConfig(itmax=6),
                            itmax_dynamic=3), False),
        "robust_lm": (robust_mod.robust_lm_solve,
                      dict(nu0=2.0, em_iters=2,
                           config=lm_mod.LMConfig(itmax=5)), True),
        "rtr": (m.rtr_solve, dict(config=m.RTRConfig(
            itmax_rsd=4, itmax_rtr=8, max_inner=6)), False),
        "rtr_dynamic": (m.rtr_solve, dict(config=m.RTRConfig(
            itmax_rsd=9, itmax_rtr=14), itmax_dynamic=2), False),
        "nsd_robust": (m.nsd_solve_robust, dict(itmax=10, nu0=4.0,
                                                em_iters=2), True),
    }


SOLVER_NAMES = ("lm", "lm_dynamic", "robust_lm", "rtr", "rtr_dynamic",
                "nsd_robust")


@pytest.mark.parametrize("name", SOLVER_NAMES)
def test_solver_trace_and_quality_match_jax(problem, name):
    import jax.numpy as jnp

    import sagecal_tpu.solvers.lm as jlm
    import sagecal_tpu.solvers.robust as jrob
    import sagecal_tpu.solvers.rtr as jr
    import sagecal_tpu_torch.solvers.lm as tlm
    import sagecal_tpu_torch.solvers.robust as trob
    import sagecal_tpu_torch.solvers.rtr as tr

    np_args, t_args = _solver_args(problem[3])
    jfn, jkw, robust = _solvers(jr, jrob, jlm)[name]
    tfn, tkw, _ = _solvers(tr, trob, tlm)[name]
    flags = dict(collect_trace=True, collect_quality=True)
    want = jfn(*map(jnp.asarray, np_args), **jkw, **flags)
    before = tr.host_read.count
    got = tfn(*t_args, **tkw, **flags)
    reads_on = tr.host_read.count - before
    before = tr.host_read.count
    plain = tfn(*t_args, **tkw)
    reads_off = tr.host_read.count - before
    if robust:
        (want, _), (got, _), (plain, _) = want, got, plain
    same_trace(got.trace, want.trace)
    same_quality(got.quality, want.quality)
    if name == "lm":
        from sagecal_tpu.obs.records import trace_to_host as jhost
        from sagecal_tpu_torch.obs.records import trace_to_host

        gh, wh = trace_to_host(got.trace), jhost(want.trace)
        assert gh.keys() == wh.keys()
        for k in wh:
            _close_field(np.array(gh[k]), np.array(wh[k]), k)
    assert torch.equal(got.p, plain.p) and torch.equal(got.cost, plain.cost)
    assert plain.trace is None and plain.quality is None
    assert reads_on == reads_off


def test_lm_trace_rows_past_the_stop_are_nan(problem):
    """A chunk set that converges before itmax leaves its later rows NaN
    (and ls_evals 0), as the reference's while_loop does."""
    from sagecal_tpu_torch.solvers.lm import LMConfig, lm_solve

    _, t_args = _solver_args(problem[3])
    out = lm_solve(*t_args, LMConfig(itmax=40, eps3=1e3),
                   collect_trace=True)
    n = out.iterations
    assert n < 40
    assert torch.isfinite(out.trace.cost[:n]).all()
    assert torch.isnan(out.trace.cost[n:]).all()
    assert (out.trace.ls_evals[n:] == 0).all()


def test_lbfgs_trace_matches_jax():
    import jax.numpy as jnp

    from sagecal_tpu.solvers.lbfgs import lbfgs_fit as jfit
    from sagecal_tpu_torch.solvers.lbfgs import lbfgs_fit
    from test_torch_lbfgs import X0, _rosen_j, _rosen_t

    want = jfit(_rosen_j, None, jnp.asarray(X0), itmax=30, M=5,
                collect_trace=True)
    got = lbfgs_fit(_rosen_t, None, torch.from_numpy(X0.copy()), itmax=30,
                    M=5, collect_trace=True)
    same_trace(got.trace, want.trace)
    plain = lbfgs_fit(_rosen_t, None, torch.from_numpy(X0.copy()), itmax=30,
                      M=5)
    assert torch.equal(got.p, plain.p) and plain.trace is None


SAGE_KW = dict(max_iter=3, max_lbfgs=6, lbfgs_m=5)
SAGE_CASES = {"mode1": dict(solver_mode=1, max_emiter=2),
              "mode2": dict(solver_mode=2, max_emiter=1),
              "mode5": dict(solver_mode=5, max_emiter=2)}


@pytest.mark.parametrize("case", list(SAGE_CASES))
def test_sagefit_telemetry_and_quality_match_jax(problem, case):
    from sagecal_tpu.obs.records import (
        sage_convergence_records as jrecords,
    )
    from sagecal_tpu.solvers.sage import SageConfig as JCfg, sagefit as jfit
    from sagecal_tpu_torch.interop import tile_from_numpy
    from sagecal_tpu_torch.obs.records import sage_convergence_records
    from sagecal_tpu_torch.solvers.sage import SageConfig, sagefit

    data, cdata, p0, arrays = problem
    kw = dict(SAGE_KW, **SAGE_CASES[case])
    flags = dict(collect_telemetry=True, collect_quality=True)
    want = jfit(data, cdata, p0, JCfg(**kw, **flags))
    td, tc, tp = tile_from_numpy(arrays, device="cpu")
    got = sagefit(td, tc, tp, SageConfig(**kw, **flags), device="cpu")
    off = sagefit(td, tc, tp, SageConfig(**kw), device="cpu")

    assert torch.equal(got.p, off.p) and torch.equal(got.res_1, off.res_1)
    assert off.telemetry is None and off.quality is None
    floor = case == "mode5"
    assert len(got.telemetry["em"]) == len(want.telemetry["em"])
    for g, w in zip(got.telemetry["em"], want.telemetry["em"]):
        same_trace(g, w, floor)
    same_trace(got.telemetry["lbfgs"], want.telemetry["lbfgs"])
    same_quality(got.quality["em"], want.quality["em"])
    same_quality(got.quality["final"], want.quality["final"])

    grec = sage_convergence_records(got.telemetry)
    wrec = jrecords(want.telemetry)
    assert len(grec) == len(wrec)
    for g, w in zip(grec, wrec):
        assert g.keys() == w.keys()
        assert g["cluster"] == w["cluster"]
        # mode 5: a cluster's record concatenates its lanes' rows past
        # the floor too, so only its keys are held here; its rows are the
        # traces compared above
        if floor and g["cluster"] is not None:
            continue
        assert g["iterations"] == w["iterations"]
        n = g["iterations"]
        for name in ("cost", "grad_norm", "step", "ls_evals", "nu"):
            gv = np.array([np.nan if v is None else v for v in g[name]])
            wv = np.array([np.nan if v is None else v for v in w[name]])
            _close_field(gv[:n], wv[:n], name)


def test_batched_lane_quality_is_each_lanes_sagefit_quality():
    """Per-lane quality of ``sagefit_batched_fused`` (B = 3, mode 2, one
    EM pass): the EM part bit for bit each lane's own ``sagefit``, the
    whole-solution part within the batched route's 1e-5 of it (the lanes
    differ from solo solves only in the lock-step joint LBFGS)."""
    from test_torch_batched import CFG, _batched_solve_problem
    from torch_port_common import tile_arrays

    from sagecal_tpu_torch.interop import batch_from_numpy
    from sagecal_tpu_torch.solvers.batched import derive_lane_generators
    from sagecal_tpu_torch.solvers.sage import (
        SageConfig, lane_of, sagefit, sagefit_batched_fused,
    )

    data_b, cdata_b, p0_b = _batched_solve_problem(seed=41)
    data, cdata, p0 = batch_from_numpy(tile_arrays(data_b, cdata_b, p0_b),
                                       device="cpu")
    cfg = SageConfig(**CFG, solver_mode=2, collect_quality=True)
    gens = derive_lane_generators(0, range(3))
    out = sagefit_batched_fused(data, cdata, p0, cfg, gens, device="cpu")
    for b in range(3):
        solo = sagefit(lane_of(data, b), lane_of(cdata, b), p0[b], cfg,
                       derive_lane_generators(0, [b])[0], device="cpu")
        for name, w in solo.quality["em"]._asdict().items():
            g = getattr(out.quality["em"], name)
            assert (g is None) == (w is None), name
            if w is not None:
                assert torch.equal(g[b], w), name
        for name, w in solo.quality["final"]._asdict().items():
            if w is not None:
                g = getattr(out.quality["final"], name)[b]
                assert torch.allclose(g, w, rtol=1e-5,
                                      atol=1e-5 * float(w.abs().max())), name


def test_solve_outputs_compare_reports_bits(tmp_path):
    """``tools/solve_outputs.py compare``: 0 for equal saves, 1 for a
    differing or missing entry (the tool that holds a change's solves to
    its parent's bits, host reads and launches)."""
    from sagecal_tpu_torch.tools.solve_outputs import compare

    a = {"x p": torch.tensor([1.0, 2.0]), "x host reads": torch.tensor(3)}
    torch.save(a, tmp_path / "a.pt")
    torch.save(dict(a), tmp_path / "b.pt")
    torch.save(dict(a, **{"x p": torch.tensor([1.0, 2.5])}),
               tmp_path / "c.pt")
    torch.save({"x p": a["x p"]}, tmp_path / "d.pt")
    assert compare(tmp_path / "a.pt", tmp_path / "b.pt") == 0
    assert compare(tmp_path / "a.pt", tmp_path / "c.pt") == 1
    assert compare(tmp_path / "a.pt", tmp_path / "d.pt") == 1


def test_registry_matches_jax(monkeypatch):
    """The copied metrics registry: the same calls give the JAX
    package's snapshot and Prometheus text, and telemetry off hands out
    the no-op registry."""
    from sagecal_tpu.obs import registry as jreg
    from sagecal_tpu_torch.obs import registry as treg

    regs = (jreg.MetricsRegistry(), treg.MetricsRegistry())
    for reg in regs:
        reg.counter_inc("solves_total", help="solves", tile="0")
        reg.counter_inc("solves_total", 2.0, tile="0")
        reg.gauge_set("tile_iterations_to_converge", 17, tile="60")
        for v in (0.004, 0.2, 42.0, 400.0):
            reg.observe("phase_seconds", v, phase="solve")
    assert regs[1].snapshot() == regs[0].snapshot()
    assert regs[1].to_prometheus() == regs[0].to_prometheus()
    assert regs[1].get_counter("solves_total", tile="0") == 3.0
    monkeypatch.delenv("SAGECAL_TELEMETRY", raising=False)
    assert not treg.get_registry().enabled
    treg.set_telemetry(True)
    try:
        assert treg.get_registry().enabled and treg.telemetry_enabled()
    finally:
        treg.set_telemetry(None)
