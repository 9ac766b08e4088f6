"""Port vs JAX package: the fullbatch app (``apps/fullbatch.py``).

One ``vis.h5`` is made by the JAX package (``tests/test_apps.py``'s
geometry: 7 stations, the 2-cluster sky, 2 channels, 4 timeslots) and
copied; the JAX ``run_fullbatch`` runs on one copy and the port's
(``device="cpu"``) on the other, with ``tilesz`` 2, so two tiles
exercise the warm carry and the prefetcher.

Bars: at f64 the per-tile res_0/res_1, the solutions file and the
residual column within 1e-8 relative (of the largest magnitude for
arrays) in modes 1 and 5; at f32 with ``--fused`` within the 5e-3 bar of
tests/test_torch_sage.py (p absolute, res relative) and the residual
column within 5e-3 of its largest magnitude.  Simulation modes 1-3 (with
``-q``, ``-z``, ``-k``, ``correction_rho``, phase-only) within 1e-10.
Mode 3, the CLI default, draws OS-LM subsets (``jax.random`` there, a
``torch.Generator`` here), so it is held only to converging.  A solve
warm-started from a converged solution (``-q``) starts at the noise
floor, where LM's gain ratios divide cost differences of ~1e-12
relative and rounding steers the damping: its res_1 is held to 1e-6
(WARM_TOL; measured 1.5e-8), its res_0 to 1e-8.
"""

import math
import os
import shutil

import numpy as np
import pytest

from test_apps import CLUSTER, SKY, _make_dataset

TOL = 1e-8
WARM_TOL = 1e-6
F32_TOL = 5e-3
BASE = dict(tilesz=2, max_emiter=2, max_iter=4, max_lbfgs=6, lbfgs_m=5)


@pytest.fixture()
def work(tmp_path):
    """Sky files, and a JAX-made dataset with true gains at two paths."""
    from sagecal_tpu.io.simulate import random_jones

    (tmp_path / "t.sky.txt").write_text(SKY)
    (tmp_path / "t.sky.txt.cluster").write_text(CLUSTER)
    jones = random_jones(2, 7, seed=3, amp=0.15, dtype=np.complex128)
    _make_dataset(tmp_path / "j.h5", ntime=4, nchan=2, jones=jones)
    shutil.copy(tmp_path / "j.h5", tmp_path / "t.h5")
    return tmp_path


def _cfgs(work, **kw):
    """(JAX RunConfig, port RunConfig) on the two copies."""
    from sagecal_tpu.apps.config import RunConfig as JCfg
    from sagecal_tpu_torch.apps.config import RunConfig

    common = dict(sky_model=str(work / "t.sky.txt"),
                  cluster_file=str(work / "t.sky.txt.cluster"), **kw)
    return (JCfg(dataset=str(work / "j.h5"),
                 out_solutions=str(work / "j.sol"), **common),
            RunConfig(dataset=str(work / "t.h5"),
                      out_solutions=str(work / "t.sol"), **common))


def _run_both(work, **kw):
    from sagecal_tpu.apps.fullbatch import run_fullbatch as jrun
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch

    jcfg, tcfg = _cfgs(work, **kw)
    want = jrun(jcfg, log=lambda *a: None)
    got = run_fullbatch(tcfg, log=lambda *a: None, device="cpu")
    return got, want


def _column(path, name):
    import h5py

    with h5py.File(str(path), "r") as f:
        return np.asarray(f[name])


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


def _solutions(path):
    from sagecal_tpu.io import solutions as solio

    return solio.read_solutions(str(path))


@pytest.mark.parametrize("mode", [1, 5])
def test_f64_matches_jax(work, mode):
    got, want = _run_both(work, solver_mode=mode, **BASE)
    assert len(got) == len(want) == 2
    for (g0, g1), (w0, w1) in zip(got, want):
        assert abs(g0 - w0) <= TOL * w0 and abs(g1 - w1) <= TOL * w1
        assert g1 < g0
    gm, gsol = _solutions(work / "t.sol")
    wm, wsol = _solutions(work / "j.sol")
    assert gm == wm and gsol.shape == wsol.shape == (2, 2, 7, 2, 2)
    _close(gsol, wsol, TOL)
    _close(_column(work / "t.h5", "corrected"),
           _column(work / "j.h5", "corrected"), TOL)


def test_f32_fused_matches_jax(work):
    got, want = _run_both(work, solver_mode=1, use_f64=False,
                          use_fused_predict=True, **BASE)
    for (g0, g1), (w0, w1) in zip(got, want):
        assert abs(g0 - w0) <= 1e-5 * w0
        assert abs(g1 - w1) <= F32_TOL * w1
    _, gsol = _solutions(work / "t.sol")
    _, wsol = _solutions(work / "j.sol")
    assert np.abs(gsol - wsol).max() <= F32_TOL
    _close(_column(work / "t.h5", "corrected"),
           _column(work / "j.h5", "corrected"), F32_TOL)


def test_mode3_default_converges(work):
    from sagecal_tpu_torch.apps.config import RunConfig
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch

    _, tcfg = _cfgs(work, solver_mode=3, **BASE)
    got = run_fullbatch(tcfg, log=lambda *a: None, device="cpu")
    # the second tile starts warm, from the first tile's gains
    assert len(got) == 2 and all(r1 < r0 for r0, r1 in got)
    assert got[0][1] < 0.2 * got[0][0]
    assert RunConfig().solver_mode == 3


def test_whiten_skip_limit_and_columns_match_jax(work):
    """-W, -K 1 (one tile of two), and -I / --out-column."""
    import h5py

    for name in ("j.h5", "t.h5"):
        with h5py.File(str(work / name), "r+") as f:
            f.create_dataset("datacopy", data=np.asarray(f["vis"]))
    got, want = _run_both(work, solver_mode=1, whiten=True, skip_tiles=1,
                          in_column="datacopy", out_column="resid2", **BASE)
    assert len(got) == len(want) == 1
    assert abs(got[0][1] - want[0][1]) <= TOL * want[0][1]
    _close(_column(work / "t.h5", "resid2"), _column(work / "j.h5", "resid2"),
           TOL)
    got, want = _run_both(work, solver_mode=1, max_tiles=1, **BASE)
    assert len(got) == len(want) == 1
    assert abs(got[0][1] - want[0][1]) <= TOL * want[0][1]


def test_warm_start_and_simulation_modes_match_jax(work):
    """-q warm start from a solutions file, then simulation modes 1-3
    with -q (advancing through its intervals), -z and -k."""
    got, want = _run_both(work, solver_mode=1, **BASE)
    shutil.copy(work / "j.sol", work / "init.sol")
    got, want = _run_both(work, solver_mode=1,
                          init_solutions=str(work / "init.sol"), **BASE)
    for (g0, g1), (w0, w1) in zip(got, want):
        assert abs(g0 - w0) <= TOL * w0 and abs(g1 - w1) <= WARM_TOL * w1
        assert g1 <= g0
    (work / "ignore.txt").write_text("# ignore cluster 2\n2\n")
    for mode, kw in ((1, {}),
                     (2, dict(init_solutions=str(work / "init.sol"))),
                     (3, dict(init_solutions=str(work / "init.sol"),
                              ignore_clusters_file=str(work / "ignore.txt"),
                              ccid=1, correction_rho=1e-3,
                              phase_only_correction=True))):
        got, want = _run_both(work, simulation_mode=mode, **dict(BASE, **kw))
        assert got == want == []
        _close(_column(work / "t.h5", "model"),
               _column(work / "j.h5", "model"), 1e-10)


def test_divergence_guard_matches_jax(work):
    """res_ratio so low that every tile diverges: the gains reset to the
    initial ones, as in the reference."""
    got, want = _run_both(work, solver_mode=1, res_ratio=1e-9, **BASE)
    _, gsol = _solutions(work / "t.sol")
    _, wsol = _solutions(work / "j.sol")
    np.testing.assert_array_equal(gsol, wsol)
    np.testing.assert_allclose(gsol, np.broadcast_to(np.eye(2), gsol.shape),
                               atol=1e-12)


def test_abort_on_divergence_raises(work):
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch
    from sagecal_tpu_torch.obs.quality import DivergenceAbort

    _, tcfg = _cfgs(work, solver_mode=1, res_ratio=1e-9,
                    abort_on_divergence=True, **BASE)
    with pytest.raises(DivergenceAbort, match="residual_ratio"):
        run_fullbatch(tcfg, log=lambda *a: None, device="cpu")


_TIMING = ("ts", "mono", "seconds", "phase_seconds", "created_unix", "pid",
           "run_id", "writer", "argv", "env", "extra", "dataset")


def test_telemetry_events_match_jax(work, monkeypatch):
    """SAGECAL_TELEMETRY=1: the same event kinds in the same order, and
    the same convergence records (timing fields dropped)."""
    from sagecal_tpu.apps.fullbatch import run_fullbatch as jrun
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch
    from sagecal_tpu_torch.obs.events import read_events, validate_manifest

    jcfg, tcfg = _cfgs(work, solver_mode=1, **BASE)
    monkeypatch.setenv("SAGECAL_TELEMETRY", "1")
    monkeypatch.setenv("SAGECAL_EVENT_LOG", str(work / "j.jsonl"))
    jrun(jcfg, log=lambda *a: None)
    monkeypatch.setenv("SAGECAL_EVENT_LOG", str(work / "t.jsonl"))
    run_fullbatch(tcfg, log=lambda *a: None, device="cpu")
    jev = read_events(str(work / "j.jsonl"))
    tev = read_events(str(work / "t.jsonl"))
    jkinds = [e["type"] for e in jev]
    tkinds = [e["type"] for e in tev]
    # the reference's A11 instrumentation adds perf and audit events the
    # port does not have yet
    jkinds = [k for k in jkinds if k in set(tkinds) | {"cluster_convergence"}]
    assert tkinds == jkinds
    assert validate_manifest(tev[0]) == []
    assert tev[0]["platform"] == "cpu" and tev[0]["kernel_path"] == "torch"
    for kind in ("cluster_convergence", "tile_done", "solve_quality"):
        tj = [e for e in jev if e["type"] == kind]
        tt = [e for e in tev if e["type"] == kind]
        assert len(tt) == len(tj) > 0, kind
        for a, b in zip(tt, tj):
            a = {k: v for k, v in a.items() if k not in _TIMING}
            b = {k: v for k, v in b.items() if k not in _TIMING}
            assert a.keys() == b.keys(), kind
            _close_json(a, b)


def _close_json(a, b):
    """Equal structure; numbers within 1e-8 of the largest magnitude of
    their list (a scalar: of itself)."""
    if isinstance(b, dict):
        for k in b:
            _close_json(a[k], b[k])
    elif isinstance(b, list) and b and all(
            v is None or isinstance(v, (int, float)) for v in b):
        fa = np.array([np.nan if v is None else v for v in a], float)
        fb = np.array([np.nan if v is None else v for v in b], float)
        assert fa.shape == fb.shape
        assert (np.isnan(fa) == np.isnan(fb)).all()
        fin = ~np.isnan(fb)
        if fin.any():
            scale = max(np.abs(fb[fin]).max(), 1e-300)
            assert np.abs(fa[fin] - fb[fin]).max() <= 1e-8 * scale, (a, b)
    elif isinstance(b, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close_json(x, y)
    elif isinstance(b, float) and isinstance(a, (int, float)):
        assert abs(a - b) <= 1e-8 * max(abs(b), 1e-300) or (
            math.isnan(a) and math.isnan(b)), (a, b)
    else:
        assert a == b, (a, b)


# the elastic options, refused until the port had elastic/, now run:
# a fresh resume (no checkpoint yet) and a checkpointed run both solve
# every tile (their bits against an uninterrupted run:
# tests/test_torch_resume_apps.py)
ELASTIC = {
    "resume": dict(resume=True),
    "checkpoint_every": dict(checkpoint_every=1),
}


@pytest.mark.parametrize("name", list(ELASTIC) + [
    "SAGECAL_PROFILE_DIR", "SAGECAL_TRANSFER_AUDIT", "SAGECAL_CHECKIFY"])
def test_unported_options_refuse(work, monkeypatch, name):
    """The A11 options refuse naming their item; the elastic ones run."""
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch

    if name in ELASTIC:
        _, tcfg = _cfgs(work, **dict(BASE, **ELASTIC[name]))
        res = run_fullbatch(tcfg, log=lambda *a: None, device="cpu")
        assert len(res) == 2 and all(np.isfinite(r).all() for r in res)
        assert sorted(os.listdir(str(work / "t.sol.ckpt"))) == [
            "ckpt_t000000.npz", "ckpt_t000001.npz"]
        return
    monkeypatch.setenv(name, str(work / "x") if "DIR" in name else "1")
    _, tcfg = _cfgs(work, **BASE)
    with pytest.raises(NotImplementedError, match="A11"):
        run_fullbatch(tcfg, log=lambda *a: None, device="cpu")
    assert not os.path.exists(work / "t.sol")
