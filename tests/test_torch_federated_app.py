"""Port vs JAX package: the federated stochastic app
(``apps/federated.py``, ``-f`` with ``-N``).

The bands are tests/test_distributed.py's (4 bands, 7 stations, 2
clusters), made by the JAX package and copied; the JAX app runs one
band a device of the conftest's CPU devices, the port one virtual shard
a band.  Compared: the returned (dual-residual trace, resets) per tile
and every band's solution file, over two tiles of two minibatches; a
band whose data are NaN, reset as in the JAX package; the command line;
the events.  Bars: 1e-8 at float64 (a solution file's number also
within one unit of its last printed digit,
tests/test_torch_distributed_spatial.py), 5e-3 at float32.  The float32
case runs whole-tile minibatches: with 21-row minibatches (one timeslot
of 7 stations for 112 parameters) the two packages' float32 LBFGS
trajectories part by 0.5-2% within two tiles (a line search decided on
the other side of its bound: the port keeps the search's scalars in
double on the host), while at float64 they agree to 1e-8.
"""

import json

import h5py
import numpy as np
import pytest

from test_distributed import _make_bands
from test_torch_distributed import F32_TOL, TOL, _cfgs, _close, _twins
from test_torch_distributed_spatial import _close_printed
from torch_port_common import free_jax_programs  # noqa: F401

RUN = dict(nadmm=2, epochs=1, minibatches=2, alpha=5.0)


def _fcfgs(jdir, tdir, **kw):
    return _cfgs(jdir, tdir, max_iter=6, max_lbfgs=6, lbfgs_m=5, **kw)


def _compare(jdir, tdir, tj, tt, tol, nbands=4):
    from sagecal_tpu_torch.io import solutions as solio

    assert len(tt) == len(tj)
    for (dt, rt), (dj, rj) in zip(tt, tj):
        assert rt == rj
        _close(dt, dj, tol, 1e-12 if tol == TOL else 0.0)
    for i in range(nbands):
        mj, sj = solio.read_solutions(str(jdir / f"z.txt.band{i}"))
        mt, st = solio.read_solutions(str(tdir / f"z.txt.band{i}"))
        assert mt == mj
        _close_printed(st, sj, tol)


@pytest.mark.parametrize("use_f64", [True, False])
def test_federated_app_matches_jax(tmp_path, devices8, use_f64):
    from sagecal_tpu.apps.federated import run_federated as jrun
    from sagecal_tpu_torch.apps.federated import run_federated

    jdir, tdir = _twins(tmp_path, lambda d: _make_bands(d, Nf=4, ntime=4))
    jcfg, tcfg = _fcfgs(jdir, tdir, use_f64=use_f64)
    run = RUN if use_f64 else {**RUN, "minibatches": 1}
    tj = jrun(jcfg, log=lambda *a: None, **run)
    tt = run_federated(tcfg, log=lambda *a: None, device="cpu", **run)
    assert len(tt) == 2 and all(r == 0 for _, r in tt)
    _compare(jdir, tdir, tj, tt, TOL if use_f64 else F32_TOL)


def test_federated_app_resets_a_nan_band(tmp_path, devices8):
    """Band 2's data NaN: reset every round as in the JAX package, the
    other bands' solutions finite and equal to the JAX package's."""
    from sagecal_tpu.apps.federated import run_federated as jrun
    from sagecal_tpu_torch.apps.federated import run_federated

    def make(d):
        paths, _ = _make_bands(d, Nf=4, ntime=2)
        with h5py.File(paths[2], "r+") as fh:
            fh["vis"][...] = np.full(fh["vis"].shape, np.nan,
                                     fh["vis"].dtype)

    jdir, tdir = _twins(tmp_path, make)
    jcfg, tcfg = _fcfgs(jdir, tdir)
    logs = {"j": [], "t": []}
    tj = jrun(jcfg, log=lambda *a: logs["j"].append(" ".join(map(str, a))),
              **{**RUN, "nadmm": 3})
    tt = run_federated(tcfg, log=lambda *a: logs["t"].append(
        " ".join(map(str, a))), device="cpu", **{**RUN, "nadmm": 3})
    assert tt[0][1] == tj[0][1] >= 1
    pick = lambda k: [s for s in logs[k] if "diverged" in s]  # noqa: E731
    assert pick("t") == pick("j") and "band 2" in pick("t")[0]
    from sagecal_tpu_torch.io import solutions as solio

    for i in (0, 1, 3):
        _, sj = solio.read_solutions(str(jdir / f"z.txt.band{i}"))
        _, st = solio.read_solutions(str(tdir / f"z.txt.band{i}"))
        assert np.isfinite(st).all()
        _close_printed(st, sj, TOL)


def test_cli_federated_matches_jax_cli(tmp_path, devices8, monkeypatch):
    """``-f ... -N 1 -M 2 -A 2 -u 5`` through both command lines, the
    port's with the event log: fed_round a round, tile_done, run_done."""
    from sagecal_tpu.apps.cli import main as jmain
    from sagecal_tpu_torch.apps.cli import main

    jdir, tdir = _twins(tmp_path, lambda d: _make_bands(d, Nf=4, ntime=2))

    def argv(d):
        sky = str(d / "t.sky.txt")
        return ["-s", sky, "-c", sky + ".cluster", "-f", str(d / "band*.h5"),
                "-N", "1", "-M", "2", "-t", "2", "-A", "2", "-P", "2",
                "-l", "6", "-p", str(d / "z.txt"), "-u", "5"]

    assert jmain(argv(jdir)) in (0, None)
    elog = tmp_path / "events.jsonl"
    monkeypatch.setenv("SAGECAL_TELEMETRY", "1")
    monkeypatch.setenv("SAGECAL_EVENT_LOG", str(elog))
    assert main(argv(tdir), device="cpu") == 0
    from sagecal_tpu_torch.io import solutions as solio

    for i in range(4):
        mj, sj = solio.read_solutions(str(jdir / f"z.txt.band{i}"))
        mt, st = solio.read_solutions(str(tdir / f"z.txt.band{i}"))
        assert mt == mj
        _close_printed(st, sj, TOL)
    kinds = [json.loads(line).get("type") for line in open(elog)]
    assert kinds.count("fed_round") == 2
    assert kinds.count("tile_done") == 1 and kinds[-1] == "run_done"
