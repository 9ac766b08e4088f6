"""The port's stream calibrator (``fleet/stream.py``, ``apps/stream.py``,
``apps/config.py::StreamConfig``) on the CPU, held against the JAX
package.

- ``stream_windows``, ``steady_state_latency`` and the warm-budget clamp
  equal the reference's on the same inputs;
- the owner-lease gate (``elastic/checkpoint.py::check_owner_lease``):
  its four cases decided as the reference decides them;
- one f64 mode-1 stream without OS-LM randomization (``-R``) over
  ``make_synthetic_stream(nstations=7, ntime=6, nchan=2, seed=7)`` in
  both packages: the datasets within 1e-12, per-window res_0 and res_1
  within 1e-8 relative, the same verdicts and warm flags, the solutions
  files within 1e-8 of their max abs;
- a port run stopped after a window's checkpoint, or between a window's
  append and its checkpoint, then adopted by ``--resume``: solutions file
  and per-window results bit-identical to the uninterrupted run's;
- ``--resume`` against a live foreign lease exits 5 through the CLI;
- the JAX package's stream checkpoint read by the port's manager (the
  same fingerprint) with its ``p`` the JAX run's last solution, to the
  solutions file's printed precision (1e-6 of its max abs).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

QUIET = dict(log=lambda *a: None)


@pytest.mark.parametrize("args", [
    (6, 2, 1), (8, 2, 2), (3, 4, 1), (100, 2, 1, 3), (4, 0, 0),
    (120, 20, 10, 3), (7, 3, 5)])
def test_stream_windows_match_reference(args):
    from sagecal_tpu.fleet.stream import stream_windows as ref
    from sagecal_tpu_torch.fleet.stream import stream_windows

    assert stream_windows(*args) == ref(*args)


@pytest.mark.parametrize("lat", [
    [], [1.0], [3.0, 1.0], [10.0, 3.0, 0.2, 0.21, 0.19],
    [5.0, 4.0, 0.3, 0.1]])
def test_steady_state_latency_matches_reference(lat):
    from sagecal_tpu.fleet.stream import steady_state_latency as ref
    from sagecal_tpu_torch.fleet.stream import steady_state_latency

    assert steady_state_latency(lat) == ref(lat)


@pytest.mark.parametrize("budgets", [(2, 6, 5, 99), (3, 10, 1, 4),
                                     (3, 10, 0, 0)])
def test_warm_budget_clamp_matches_reference(budgets):
    from sagecal_tpu.apps.config import StreamConfig as JCfg
    from sagecal_tpu.fleet.stream import StreamCalibrator as JCal
    from sagecal_tpu_torch.apps.config import StreamConfig
    from sagecal_tpu_torch.fleet.stream import StreamCalibrator

    e, lb, we, wl = budgets
    kw = dict(max_emiter=e, max_lbfgs=lb, warm_emiter=we, warm_lbfgs=wl)
    got = StreamCalibrator(StreamConfig(**kw), **QUIET)._sage_configs()
    want = JCal(JCfg(**kw), **QUIET)._sage_configs()
    for g, w in zip(got, want):
        assert (g.max_emiter, g.max_lbfgs, g.max_iter, g.solver_mode,
                g.randomize, g.collect_quality) == \
            (w.max_emiter, w.max_lbfgs, w.max_iter, w.solver_mode,
             w.randomize, w.collect_quality)


@pytest.mark.parametrize("meta,owner,refused", [
    ({}, "me", False),                                       # no owner
    ({"owner": "me", "lease_expires_at": 2e9}, "me", False),  # our own
    ({"owner": "peer", "lease_expires_at": 2e9}, "me", True),  # live
    ({"owner": "peer", "lease_expires_at": 1.0}, "me", False),  # expired
])
def test_lease_gate_matches_reference(meta, owner, refused):
    from sagecal_tpu.elastic.checkpoint import check_owner_lease as jcheck
    from sagecal_tpu_torch.elastic.checkpoint import (
        ResumeRefused, check_owner_lease,
    )

    outcomes = []
    for fn in (check_owner_lease, jcheck):
        try:
            fn(dict(meta), owner, now=1000.0)
            outcomes.append(False)
        except Exception as e:  # each package's own ResumeRefused
            assert "live lease" in str(e)
            outcomes.append(True)
    assert outcomes == [refused, refused]
    if refused:
        with pytest.raises(ResumeRefused):
            check_owner_lease(dict(meta), owner, now=1000.0)


def _cfg(pkg, fixture, out_dir, **kw):
    import importlib

    ds, sky, cluster = fixture
    base = dict(dataset=ds, sky_model=sky, cluster_file=cluster,
                out_dir=out_dir, window=2, hop=1, max_emiter=3,
                max_iter=2, max_lbfgs=10, solver_mode=1, warm_emiter=1,
                warm_lbfgs=4, checkpoint_every=0, use_f64=True,
                randomize=False)
    base.update(kw)
    return importlib.import_module(f"{pkg}.apps.config").StreamConfig(**base)


def _docs(out_dir):
    docs = []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".result.json"):
            with open(os.path.join(out_dir, name)) as fh:
                docs.append(json.load(fh))
    return docs


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Both packages' fixture streams and one f64 mode-1 ``-R`` run of
    each over the JAX fixture, the JAX run checkpointing its chain."""
    from sagecal_tpu.fleet.stream import (
        StreamCalibrator as JCal, make_synthetic_stream as jmake,
    )
    from sagecal_tpu_torch.fleet.stream import (
        StreamCalibrator, make_synthetic_stream,
    )

    root = tmp_path_factory.mktemp("stream")
    jfix = jmake(str(root / "jfix"), nstations=7, ntime=6, nchan=2, seed=7)
    tfix = make_synthetic_stream(str(root / "tfix"), nstations=7, ntime=6,
                                 nchan=2, seed=7, device="cpu")
    jcfg = _cfg("sagecal_tpu", jfix, str(root / "jout"),
                checkpoint_every=1, lease_ttl_s=0.0)
    tcfg = _cfg("sagecal_tpu_torch", jfix, str(root / "tout"))
    jsum = JCal(jcfg, **QUIET).run()
    tsum = StreamCalibrator(tcfg, device="cpu", **QUIET).run()
    return dict(root=root, jfix=jfix, tfix=tfix, jcfg=jcfg, tcfg=tcfg,
                jsum=jsum, tsum=tsum)


def test_synthetic_stream_matches_reference(parity):
    import h5py

    with h5py.File(parity["jfix"][0]) as fj, h5py.File(parity["tfix"][0]) as ft:
        for k in ("u", "v", "w", "freqs", "ant_p", "ant_q", "flag"):
            np.testing.assert_array_equal(np.asarray(ft[k]), np.asarray(fj[k]))
        vj, vt = np.asarray(fj["vis"]), np.asarray(ft["vis"])
        assert np.abs(vt - vj).max() <= 1e-12 * np.abs(vj).max()
        assert dict(ft.attrs) == pytest.approx(dict(fj.attrs))
    for a, b in zip(parity["jfix"][1:], parity["tfix"][1:]):
        assert open(a).read() == open(b).read()


def test_f64_mode1_stream_matches_reference(parity):
    from sagecal_tpu_torch.io.solutions import read_solutions

    jsum, tsum = parity["jsum"], parity["tsum"]
    for k in ("windows", "solved", "warm", "resets", "resumed_from"):
        assert tsum[k] == jsum[k], k
    jd, td = _docs(parity["jcfg"].out_dir), _docs(parity["tcfg"].out_dir)
    assert [d["request_id"] for d in td] == [d["request_id"] for d in jd]
    assert len(td) == 5
    for j, t in zip(jd, td):
        assert (t["warm"], t["verdict"], t["window"], t["t0"]) == \
            (j["warm"], j["verdict"], j["window"], j["t0"])
        for k in ("res0", "res1"):
            assert abs(t[k] - j[k]) <= 1e-8 * abs(j[k]), (k, t[k], j[k])
        assert t["res1"] < t["res0"]
    jm, jsol = read_solutions(jsum["solutions"])
    tm, tsol = read_solutions(tsum["solutions"])
    assert tm == jm and tsol.shape == jsol.shape == (5, 2, 7, 2, 2)
    assert np.abs(tsol - jsol).max() <= 1e-8 * np.abs(jsol).max()


def test_port_reads_jax_stream_checkpoint(parity):
    """The JAX run's chain checkpoint passes the port's fingerprint
    check for the same configuration, and its ``p`` is the JAX run's
    last solution."""
    from sagecal_tpu_torch.core.types import params_to_jones
    from sagecal_tpu_torch.elastic.checkpoint import CheckpointManager
    from sagecal_tpu_torch.fleet.stream import StreamCalibrator
    from sagecal_tpu_torch.io.dataset import VisDataset
    from sagecal_tpu_torch.io.solutions import read_solutions

    jcfg = parity["jcfg"]
    tcfg = _cfg("sagecal_tpu_torch", parity["jfix"], jcfg.out_dir,
                checkpoint_every=1, lease_ttl_s=0.0)
    with VisDataset(tcfg.dataset) as ds:
        fp = StreamCalibrator(tcfg, **QUIET)._fingerprint(ds.meta, 2, 1)
    meta, arrays, _ = CheckpointManager(
        os.path.join(jcfg.out_dir, "stream.ckpt"), fp, "stream").resume()
    assert meta["windows_done"] == 5 and meta["lease_expires_at"] == 0.0
    assert "rng_key" in arrays
    _, jsol = read_solutions(parity["jsum"]["solutions"])
    p = torch.as_tensor(arrays["p"])
    assert p.dtype == torch.float64 and p.shape == (2, 1, 56)
    # the solutions file prints ~7 significant digits
    got = params_to_jones(p).reshape(2, 7, 2, 2).numpy()
    assert np.abs(got - jsol[-1]).max() <= 1e-6 * np.abs(jsol[-1]).max()


class _Killed(BaseException):
    """Stands in for a SIGKILL: escapes every ``except Exception``."""


@pytest.mark.parametrize("at", ["after_checkpoint", "before_checkpoint"])
def test_killed_then_adopted_run_is_bit_identical(parity, monkeypatch, at):
    """A run dies after window 0's checkpoint (before window 1's solve),
    or after window 1's append but before its checkpoint (the solutions
    file then holds one interval past the chain); ``--resume`` by
    another owner after the lease lapses gives the uninterrupted run's
    solutions file and results bit for bit."""
    from sagecal_tpu_torch.elastic.checkpoint import CheckpointManager
    from sagecal_tpu_torch.fleet.stream import StreamCalibrator
    from sagecal_tpu_torch.io.solutions import validate_solutions

    root = parity["root"] / f"kill_{at}"
    fix = parity["tfix"]
    ref_cfg = _cfg("sagecal_tpu_torch", fix, str(root / "ref"),
                   randomize=True, solver_mode=3, checkpoint_every=1)
    ref = StreamCalibrator(ref_cfg, device="cpu", **QUIET).run()

    out = str(root / "killed")
    if at == "after_checkpoint":
        # die as window 1 starts: its solve is never reached
        import sagecal_tpu_torch.solvers.sage as sage

        solve, calls = sage.solve_tile, []

        def dying_solve(*a, **k):
            calls.append(1)
            if len(calls) == 2:
                raise _Killed
            return solve(*a, **k)

        monkeypatch.setattr(sage, "solve_tile", dying_solve)
    else:
        # die after window 1's append, before its checkpoint
        update = CheckpointManager.update

        def dying_update(self, tile_index, arrays, **meta):
            if tile_index == 1:
                raise _Killed
            return update(self, tile_index, arrays, **meta)

        monkeypatch.setattr(CheckpointManager, "update", dying_update)
    monkeypatch.setenv("SAGECAL_WORKER_ID", "stream-a")
    cfg = _cfg("sagecal_tpu_torch", fix, out, randomize=True, solver_mode=3,
               checkpoint_every=1, lease_ttl_s=60.0)
    with pytest.raises(_Killed):
        StreamCalibrator(cfg, device="cpu", **QUIET).run()
    monkeypatch.undo()
    sol = os.path.join(out, os.path.basename(ref["solutions"]))
    assert validate_solutions(sol)["n_intervals"] == \
        (1 if at == "after_checkpoint" else 2)
    # another owner, once the dead owner's lease has lapsed on its clock
    monkeypatch.setenv("SAGECAL_WORKER_ID", "stream-b")
    cfg = _cfg("sagecal_tpu_torch", fix, out, randomize=True, solver_mode=3,
               checkpoint_every=1, lease_ttl_s=60.0, resume=True)
    later = lambda: time.time() + 120.0
    got = StreamCalibrator(cfg, device="cpu", clock=later, **QUIET).run()
    assert got["resumed_from"] == 1 and got["solved"] == 5
    with open(sol) as a, open(ref["solutions"]) as b:
        assert a.read() == b.read()
    keys = ("request_id", "warm", "verdict", "res0", "res1", "window")
    assert [{k: d[k] for k in keys} for d in _docs(out)] == \
        [{k: d[k] for k in keys} for d in _docs(ref_cfg.out_dir)]


def test_live_foreign_lease_exits_5(parity, monkeypatch, capsys):
    from sagecal_tpu_torch.apps.cli import main
    from sagecal_tpu_torch.elastic.checkpoint import (
        find_latest_checkpoint, write_checkpoint,
    )

    ds, sky, cluster = parity["tfix"]
    out = str(parity["root"] / "lease")
    argv = ["stream", "-d", ds, "-s", sky, "-c", cluster, "--out-dir", out,
            "-j", "1", "-R", "-e", "1", "-l", "4", "--max-windows", "2",
            "--checkpoint-every", "1", "--lease-ttl", "3600"]
    monkeypatch.setenv("SAGECAL_WORKER_ID", "stream-a")
    assert main(argv, device="cpu") == 0
    ckdir = os.path.join(out, "stream.ckpt")
    meta, arrays, path = find_latest_checkpoint(ckdir)
    meta["owner"] = "stream-c"  # a crashed peer mid-stream
    meta["lease_expires_at"] = time.time() + 3600.0
    write_checkpoint(path, arrays, meta)
    monkeypatch.setenv("SAGECAL_WORKER_ID", "stream-b")
    assert main(argv + ["--resume"], device="cpu") == 5
    assert "live lease" in capsys.readouterr().err
