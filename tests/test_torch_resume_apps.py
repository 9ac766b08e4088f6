"""Elastic resume of every app of the port (``elastic/``, ``--resume``).

Each case runs one app at its smallest size on the CPU three times from
the command line (``apps.cli.main(argv, device="cpu")``): once
uninterrupted with ``--checkpoint-every 1``; once stopped right after
its first checkpoint landed, by raising from a patched
``CheckpointManager.update`` (a stand-in for a kill at a tile boundary:
the subprocess kill is ``test_fullbatch_killed_at_checkpoint_resumes``);
then again with ``--resume``.  The resumed run's files (solutions,
residual columns, the apps' arrays) must equal the uninterrupted run's
bit for bit (refine's trace but its per-iteration times): the datasets
are copies of one file.  A changed
configuration refuses with exit 5 (``ResumeRefused``), as does a
solutions file that is missing or shorter than the checkpoint says.

The fullbatch app at mode 1 and float64 is also held against the JAX
package: its tile-1 checkpoint's ``p`` and ``results`` at 1e-8, the
same meta keys, and the same ``config_fingerprint``.  The port's
checkpoints carry ``rng_seed`` where the JAX package's carry
``rng_key``: each tile's generator is derived from the seed and the
tile number (``elastic/checkpoint.py``).
"""

import glob
import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from test_apps import CLUSTER, SKY

torch.set_num_threads(1)


class Stop(Exception):
    """Raised after the first checkpoint: the interrupted run."""


def _dataset(path, nstations=6, ntime=6, nchan=2, freq0=150e6, seed=0):
    """A port-simulated vis.h5 of the 2-cluster test sky (phase centre
    ra 0, dec 51 deg, as the sky file's)."""
    import h5py

    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.skymodel import load_sky

    sky = os.path.join(os.path.dirname(path), "t.sky.txt")
    clusters, _, _ = load_sky(sky, sky + ".cluster", 0.0, math.radians(51.0),
                              dtype=torch.float64, device="cpu")
    simulate_dataset(path, nstations=nstations, ntime=ntime, nchan=nchan,
                     freq0=freq0, clusters=clusters, noise_sigma=1e-4,
                     seed=seed, dec0=math.radians(51.0), device="cpu")
    with h5py.File(path, "r+") as f:
        f.attrs["ra0"] = 0.0
        f.attrs["dec0"] = math.radians(51.0)


def _sky(d):
    (d / "t.sky.txt").write_text(SKY)
    (d / "t.sky.txt.cluster").write_text(CLUSTER)
    return str(d / "t.sky.txt")


def _one(d):
    sky = _sky(d)
    _dataset(str(d / "a.h5"))
    return sky


def _bands(d):
    sky = _sky(d)
    for i, f0 in enumerate((140e6, 150e6, 160e6)):
        _dataset(str(d / f"band{i}.h5"), freq0=f0, seed=i)
    return sky


# app -> (data maker, argv maker(run dir, data dir, sky), the files
# compared, the dataset files whose columns are compared)
def _fullbatch(r, d, sky):
    return ["-d", f"{r}/a.h5", "-s", sky, "-p", f"{r}/sol.txt", "-t", "2",
            "-e", "1", "-g", "2", "-l", "3", "-j", "1"]


def _minibatch(r, d, sky):
    return ["-d", f"{r}/a.h5", "-s", sky, "-p", f"{r}/sol.txt", "-N", "1",
            "-M", "3", "-w", "2", "-A", "2", "-l", "3",
            "--consensus-staleness", "1"]


def _distributed(r, d, sky):
    return ["-f", f"{r}/band*.h5", "-s", sky, "-p", f"{r}/sol.txt", "-t",
            "2", "-A", "2", "-e", "1", "-g", "2", "-j", "1"]


def _federated(r, d, sky):
    return ["-f", f"{r}/band*.h5", "-s", sky, "-p", f"{r}/sol.txt", "-t",
            "2", "-N", "1", "-M", "2", "-A", "2", "-l", "3"]


def _spatial(r, d, sky):
    return ["spatial", "--synthetic", "3", "--nstations", "5", "-j", "1",
            "-e", "1", "-g", "2", "-l", "2", "--fista-maxiter", "10", "-o",
            f"{r}/sp"]


def _widefield(r, d, sky):
    return ["widefield", "-n", "6", "--ntiles", "3", "-S", "120", "-k", "3",
            "-j", "1", "-e", "1", "-g", "2", "-l", "3", "--out-dir",
            f"{r}/wf"]


def _refine(r, d, sky):
    return ["refine", "--synthetic", "4", "--outer-iters", "2",
            "--inner-iters", "4", "--cg-iters", "8", "-o", f"{r}/rf"]


def _serve(r, d, sky):
    return ["serve", "--requests", f"{r}/requests.json", "--batch", "1",
            "--out-dir", f"{r}/out", "-e", "1", "-g", "2", "-l", "3", "-j",
            "1"]


APPS = {
    "fullbatch": (_one, _fullbatch, ["sol.txt"], ["a.h5"]),
    "serve": (None, _serve, ["out/*.solutions"], []),
    "distributed": (_bands, _distributed, ["sol.txt", "sol.txt.band*"],
                    ["band*.h5"]),
    "minibatch": (_one, _minibatch, ["sol.txt"], ["a.h5"]),
    "federated": (_bands, _federated, ["sol.txt.band*"], []),
    "spatial": (None, _spatial, ["sp.npz"], []),
    "widefield": (None, _widefield, ["wf/solutions.npz"], []),
    "refine": (None, _refine, ["rf.npz", "rf.trace.jsonl"], []),
}


def _files(run, patterns):
    out = []
    for pat in patterns:
        found = sorted(glob.glob(os.path.join(run, pat)))
        assert found, f"{pat} missing under {run}"
        out += found
    return out


def _npz_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert np.array_equal(za[k], zb[k]), (a, k)


def _untimed(path):
    import json

    return [{k: v for k, v in json.loads(line).items() if k != "seconds"}
            for line in open(path)]


def _columns(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f.keys()
                if isinstance(f[k], h5py.Dataset)}


def _prepare(tmp_path, app):
    """Data under tmp_path/data, copied into the runs' dirs a/ and b/."""
    make = APPS[app][0]
    d = tmp_path / "data"
    d.mkdir()
    sky = _sky(d)
    if make is not None:
        make(d)
    runs = []
    for name in ("a", "b"):
        r = tmp_path / name
        shutil.copytree(d, r)
        runs.append(str(r))
    if app == "serve":
        from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

        for r in runs:  # the same seeded workload in both dirs
            make_synthetic_workload(r, 3, n_tenants=2, device="cpu")
    return runs, str(d), sky


def _interrupt(monkeypatch):
    from sagecal_tpu_torch.elastic.checkpoint import CheckpointManager

    update = CheckpointManager.update

    def stop_after_first(self, tile_index, *a, **k):
        path = update(self, tile_index, *a, **k)
        if path is not None:
            raise Stop(path)
        return path

    monkeypatch.setattr(CheckpointManager, "update", stop_after_first)


@pytest.mark.parametrize("app", list(APPS))
def test_resume_gives_the_uninterrupted_files(tmp_path, monkeypatch, app):
    from sagecal_tpu_torch.apps.cli import main

    (ra, rb), d, sky = _prepare(tmp_path, app)
    argv_of = APPS[app][1]
    assert main(argv_of(ra, d, sky) + ["--checkpoint-every", "1"],
                device="cpu") == 0
    with monkeypatch.context() as m:
        _interrupt(m)
        with pytest.raises(Stop):
            main(argv_of(rb, d, sky) + ["--checkpoint-every", "1"],
                 device="cpu")
    assert main(argv_of(rb, d, sky) + ["--resume"], device="cpu") == 0
    for fa, fb in zip(_files(ra, APPS[app][2]), _files(rb, APPS[app][2])):
        if fa.endswith(".npz"):
            _npz_equal(fa, fb)
        elif fa.endswith(".jsonl"):  # the same records but their times
            assert _untimed(fa) == _untimed(fb), fa
        else:
            assert open(fa, "rb").read() == open(fb, "rb").read(), fa
    for fa, fb in zip(_files(ra, APPS[app][3]), _files(rb, APPS[app][3])):
        ca, cb = _columns(fa), _columns(fb)
        assert ca.keys() == cb.keys()
        for k in ca:
            assert np.array_equal(ca[k], cb[k]), (fa, k)


def _stopped_fullbatch(tmp_path, monkeypatch):
    from sagecal_tpu_torch.apps.cli import main

    (ra, _), d, sky = _prepare(tmp_path, "fullbatch")
    with monkeypatch.context() as m:
        _interrupt(m)
        with pytest.raises(Stop):
            main(_fullbatch(ra, d, sky) + ["--checkpoint-every", "1"],
                 device="cpu")
    return ra, d, sky


@pytest.mark.parametrize("change", ["-e", "-g", "-j"])
def test_changed_configuration_refuses_resume(tmp_path, monkeypatch,
                                              capsys, change):
    from sagecal_tpu_torch.apps.cli import main

    ra, d, sky = _stopped_fullbatch(tmp_path, monkeypatch)
    argv = _fullbatch(ra, d, sky)
    argv[argv.index(change) + 1] = "3"
    before = open(f"{ra}/sol.txt").read()
    assert main(argv + ["--resume"], device="cpu") == 5
    assert "refusing to resume" in capsys.readouterr().err
    assert open(f"{ra}/sol.txt").read() == before


@pytest.mark.parametrize("damage", ["missing", "short"])
def test_solution_file_that_disagrees_refuses(tmp_path, monkeypatch, capsys,
                                              damage):
    from sagecal_tpu_torch.apps.cli import main

    ra, d, sky = _stopped_fullbatch(tmp_path, monkeypatch)
    sol = f"{ra}/sol.txt"
    if damage == "missing":
        os.remove(sol)
    else:
        lines = open(sol).readlines()
        open(sol, "w").writelines(lines[:len(lines) - 9])
    assert main(_fullbatch(ra, d, sky) + ["--resume"], device="cpu") == 5
    assert "disagree" in capsys.readouterr().err


def test_torn_trailing_interval_is_truncated(tmp_path, monkeypatch):
    from sagecal_tpu_torch.apps.cli import main

    (ra, rb), d, sky = _prepare(tmp_path, "fullbatch")
    assert main(_fullbatch(ra, d, sky), device="cpu") == 0
    with monkeypatch.context() as m:
        _interrupt(m)
        with pytest.raises(Stop):
            main(_fullbatch(rb, d, sky) + ["--checkpoint-every", "1"],
                 device="cpu")
    with open(f"{rb}/sol.txt", "a") as f:  # half an interval, torn
        f.write("0 1.0 0.0\n1 0.5")
    assert main(_fullbatch(rb, d, sky) + ["--resume"], device="cpu") == 0
    assert open(f"{ra}/sol.txt").read() == open(f"{rb}/sol.txt").read()


def test_fullbatch_checkpoint_matches_jax(tmp_path):
    """Mode 1, float64: the tile-1 checkpoint of both packages, their
    meta keys and fingerprints."""
    from sagecal_tpu.apps.config import RunConfig as JCfg
    from sagecal_tpu.apps.fullbatch import run_fullbatch as jrun
    from sagecal_tpu.elastic.checkpoint import read_checkpoint as jread
    from sagecal_tpu_torch.apps.config import RunConfig
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch
    from sagecal_tpu_torch.elastic.checkpoint import read_checkpoint

    (ra, rb), d, sky = _prepare(tmp_path, "fullbatch")
    common = dict(sky_model=sky, cluster_file=sky + ".cluster", tilesz=2,
                  max_emiter=1, max_iter=2, max_lbfgs=3, solver_mode=1,
                  checkpoint_every=1)
    # one dataset: each run reads "vis" and writes "corrected"
    jrun(JCfg(dataset=f"{ra}/a.h5", out_solutions=f"{ra}/j.txt",
              checkpoint_dir=f"{d}/jck", **common), log=lambda *a: None)
    run_fullbatch(RunConfig(dataset=f"{ra}/a.h5",
                            out_solutions=f"{ra}/t.txt",
                            checkpoint_dir=f"{d}/tck", **common),
                  log=lambda *a: None, device="cpu")
    jm, ja = jread(f"{d}/jck/ckpt_t000001.npz")
    tm, ta = read_checkpoint(f"{d}/tck/ckpt_t000001.npz")
    assert set(tm) == set(jm)
    assert set(ta) - {"rng_seed"} == set(ja) - {"rng_key"}
    assert tm["tiles_done"] == jm["tiles_done"] == 2
    assert tm["app"] == jm["app"] == "fullbatch"
    assert tm["fingerprint"] == jm["fingerprint"]
    np.testing.assert_allclose(ta["p"], ja["p"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(ta["results"], ja["results"], rtol=1e-8)


def test_fullbatch_killed_at_checkpoint_resumes(tmp_path):
    """The CLI in a subprocess, SIGTERMed as its first checkpoint lands
    (``elastic/faultinject.py``), then resumed: the solutions equal an
    uninterrupted run's.  The residual column of the killed process's
    tiles is in the same h5 file, so it is compared too."""
    from sagecal_tpu_torch.elastic.faultinject import (
        cli_argv, compare_files, kill_at_checkpoint, run_subprocess,
    )

    (ra, rb), d, sky = _prepare(tmp_path, "fullbatch")
    # a longer observation, so that the kill lands before the end
    for r in (ra, rb):
        os.remove(f"{r}/a.h5")
    _dataset(f"{d}/long.h5", ntime=16)
    for r in (ra, rb):
        shutil.copy(f"{d}/long.h5", f"{r}/a.h5")
    env = {"PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    script = ("import sys; from sagecal_tpu_torch.apps.cli import main; "
              "sys.exit(main(sys.argv[1:], device='cpu'))")
    argv = [sys.executable, "-c", script] + _fullbatch(rb, d, sky)
    assert cli_argv(["-h"])[1:3] == ["-m", "sagecal_tpu_torch.apps.cli"]
    rc, out, err = run_subprocess(
        [sys.executable, "-c", script] + _fullbatch(ra, d, sky),
        env=env, timeout=50)
    assert rc == 0, err
    rc, out, err = kill_at_checkpoint(
        argv + ["--checkpoint-every", "1"], f"{rb}/sol.txt.ckpt", 1,
        env=env, timeout=50, poll=0.02)
    assert rc != 0, "the run ended before the kill"
    rc, out, err = run_subprocess(argv + ["--resume"], env=env, timeout=50)
    assert rc == 0, err
    assert compare_files([f"{ra}/sol.txt"], [f"{rb}/sol.txt"]) == []
    ca, cb = _columns(f"{ra}/a.h5"), _columns(f"{rb}/a.h5")
    assert np.array_equal(ca["corrected"], cb["corrected"])
