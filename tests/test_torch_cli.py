"""Port vs JAX package: the command line (``apps/cli.py``).

``config_from_args(build_parser().parse_args(argv))`` gives the JAX
package's ``RunConfig`` field by field for a spread of argv (the same
flags and defaults); ``main(argv, device="cpu")`` runs a fullbatch and
returns 0, or 3 when ``--abort-on-divergence`` stops a diverged run;
every mode the port does not have yet exits 2 naming its ROADMAP.md
item (``load``, ``stream``, ``convert``, ``diag``, ``--device-profile``);
the elastic options of every app and the ``fleet`` subcommand run to
exit 0.  ``widefield``, ``refine`` (and
its ``--fused`` refusal, exit 2 with ``FusedSkyGradientError``) and
``-f ... --multihost`` run on the CPU; their results are held against
the JAX package in tests/test_torch_widefield.py, test_torch_refine.py
and test_torch_multihost.py.  The spatial modes (``spatial``,
``-f`` with ``-N``, ``-X``, ``--spatial-n0``, ``--spatial-diffuse-id``)
run to exit 0 on the CPU; a malformed ``-X`` is a usage error.  Their
results are held against the JAX package in
tests/test_torch_distributed_spatial.py, test_torch_spatial_app.py and
test_torch_federated_app.py.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from test_apps import CLUSTER, SKY, _make_dataset

ARGVS = [
    ["-d", "x.h5", "-s", "sky.txt"],
    ["-d", "x.h5", "-s", "sky.txt", "-c", "c.txt", "-p", "out.sol", "-t",
     "60", "-e", "1", "-g", "6", "-l", "10", "-j", "3", "--f32", "--fused"],
    ["-d", "x.h5", "-s", "sky.txt", "-q", "init.sol", "-x", "10", "-y",
     "5000", "-L", "3", "-H", "20", "-R", "-W", "-m", "5", "-K", "1", "-T",
     "2", "--abort-on-divergence", "-I", "datacopy", "--out-column", "r2"],
    ["-d", "x.h5", "-s", "sky.txt", "-a", "3", "-z", "ign.txt", "-k", "2",
     "-o", "1e-5", "-J", "1", "-F", "1", "-E", "1", "-n", "4", "-V"],
    ["-d", "x.h5", "-s", "sky.txt", "--phase-only-correction", "-B", "2",
     "-b", "-i", "--coh-dtype", "bf16", "-G", "rho.txt", "--resume",
     "--checkpoint-every", "2", "--checkpoint-dir", "ck"],
    ["-d", "x.h5", "-s", "sky.txt", "-N", "2", "-M", "3", "-w", "4", "-A",
     "5", "-P", "3", "-Q", "1", "-r", "2.5", "--consensus-zstep", "reduced",
     "--consensus-cluster-groups", "2", "--consensus-staleness", "1",
     "--consensus-staleness-discount", "0.5"],
]


@pytest.mark.parametrize("i", range(len(ARGVS)))
def test_config_from_args_matches_jax(i):
    from sagecal_tpu.apps.cli import build_parser as jparser
    from sagecal_tpu.apps.cli import config_from_args as jconfig
    from sagecal_tpu_torch.apps.cli import build_parser, config_from_args

    want = dataclasses.asdict(jconfig(jparser().parse_args(ARGVS[i])))
    got = dataclasses.asdict(config_from_args(build_parser().parse_args(
        ARGVS[i])))
    assert got == want


def test_parser_has_the_reference_flags():
    from sagecal_tpu.apps.cli import build_parser as jparser
    from sagecal_tpu_torch.apps.cli import build_parser

    def flags(p):
        return {(a.dest, tuple(a.option_strings), a.default)
                for a in p._actions}

    assert flags(build_parser()) == flags(jparser())


def test_warn_dropped_fused_matches_jax():
    from sagecal_tpu.apps.cli import _warn_dropped_fused as jwarn
    from sagecal_tpu.apps.cli import build_parser as jparser
    from sagecal_tpu_torch.apps.cli import _warn_dropped_fused, build_parser

    for argv in (["--fused"], ["--coh-dtype", "bf16"], ["--fused", "--f32"]):
        got, want = [], []
        _warn_dropped_fused(build_parser().parse_args(argv), got.append)
        jwarn(jparser().parse_args(argv), want.append)
        assert len(got) == len(want)
        assert [g.split()[1] for g in got] == [w.split()[1] for w in want]


@pytest.fixture()
def work(tmp_path):
    from sagecal_tpu.io.simulate import random_jones

    (tmp_path / "t.sky.txt").write_text(SKY)
    (tmp_path / "t.sky.txt.cluster").write_text(CLUSTER)
    jones = random_jones(2, 7, seed=6, amp=0.1, dtype=np.complex128)
    _make_dataset(tmp_path / "d.h5", ntime=4, nchan=2, jones=jones)
    return tmp_path


def test_main_runs_a_fullbatch(work):
    from sagecal_tpu.io import solutions as solio
    from sagecal_tpu_torch.apps.cli import main

    rc = main(["-d", str(work / "d.h5"), "-s", str(work / "t.sky.txt"),
               "-p", str(work / "sol.txt"), "-t", "2", "-e", "2", "-g", "4",
               "-l", "6", "-j", "1"], device="cpu")
    assert rc == 0
    _, jsol = solio.read_solutions(str(work / "sol.txt"))
    assert jsol.shape == (2, 2, 7, 2, 2) and np.isfinite(jsol).all()


def test_main_returns_3_on_abort(work, capsys, monkeypatch):
    """A run whose every tile diverges (no flag sets the residual-ratio
    guard, so the test lowers it to 1e-9) under --abort-on-divergence."""
    import sagecal_tpu_torch.apps.fullbatch as fb
    from sagecal_tpu_torch.apps.cli import main

    run = fb.run_fullbatch

    def low_ratio(cfg, **kw):
        cfg.res_ratio = 1e-9
        return run(cfg, **kw)

    monkeypatch.setattr(fb, "run_fullbatch", low_ratio)
    rc = main(["-d", str(work / "d.h5"), "-s", str(work / "t.sky.txt"),
               "-p", str(work / "sol.txt"), "-t", "4", "-e", "1", "-g", "2",
               "-l", "2", "-j", "1", "--abort-on-divergence"], device="cpu")
    assert rc == 3
    assert "diverged" in capsys.readouterr().err


@pytest.mark.parametrize("argv,item", [
    (["diag", "events"], "A11"),
    (["-d", "x.h5", "-s", "sky.txt", "--device-profile", "prof"], "A11"),
])
def test_unported_modes_exit_nonzero_naming_their_item(argv, item, capsys):
    from sagecal_tpu_torch.apps.cli import main

    assert main(argv, device="cpu") == 2
    assert f"ROADMAP.md, {item}" in capsys.readouterr().err


# the modes and options that waited for A9 (elastic/, fleet/) and exited
# 2 naming it: each now runs to exit 0 on the CPU ({d}: a directory
# with the test sky, one dataset a.h5 and three band files; their
# resumed bits: tests/test_torch_resume_apps.py)
SMALL = ["-e", "1", "-g", "2", "-l", "3", "-j", "1"]
ELASTIC = [
    ["serve", "--requests", "{d}/requests.json", "--batch", "1",
     "--out-dir", "{d}/out", "--resume", *SMALL],
    ["fleet", "--requests", "{d}/requests.json", "--workers", "1",
     "--batch", "2", "--out-dir", "{d}/fleet", "--max-idle", "5", *SMALL],
    ["widefield", "-n", "6", "--ntiles", "2", "-S", "60", "-k", "2",
     "--out-dir", "{d}/wf", "--resume", *SMALL],
    ["refine", "--synthetic", "3", "--outer-iters", "1", "--inner-iters",
     "3", "--cg-iters", "4", "-o", "{d}/rf", "--checkpoint-every", "1"],
    ["widefield", "-n", "6", "--ntiles", "2", "-S", "60", "-k", "2",
     "--out-dir", "{d}/wf", "--checkpoint-every", "2", *SMALL],
    ["-f", "{d}/band*.h5", "-s", "{d}/t.sky.txt", "-p", "{d}/s.txt", "-t",
     "2", "-N", "1", "-M", "2", "-A", "2", "-l", "3", "--resume"],
    ["-f", "{d}/band*.h5", "-s", "{d}/t.sky.txt", "-p", "{d}/s.txt", "-t",
     "2", "-N", "1", "-M", "2", "-A", "2", "-l", "3", "--checkpoint-every",
     "1"],
    ["spatial", "--synthetic", "2", "--nstations", "5", "-o", "{d}/sp",
     "--fista-maxiter", "5", "--resume", *SMALL],
    ["spatial", "--synthetic", "2", "--nstations", "5", "-o", "{d}/sp",
     "--fista-maxiter", "5", "--checkpoint-every", "1", *SMALL],
    ["-f", "{d}/band*.h5", "-s", "{d}/t.sky.txt", "-p", "{d}/s.txt", "-t",
     "2", "-A", "2", "--resume", *SMALL],
    ["-d", "{d}/a.h5", "-s", "{d}/t.sky.txt", "-p", "{d}/s.txt", "-N", "1",
     "-M", "2", "-l", "3", "--checkpoint-every", "1"],
    ["-d", "{d}/a.h5", "-s", "{d}/t.sky.txt", "-p", "{d}/s.txt", "-t", "2",
     "--resume", *SMALL],
    ["refine", "--synthetic", "3", "--outer-iters", "1", "--inner-iters",
     "3", "--cg-iters", "4", "-o", "{d}/rf", "--resume"],
]


@pytest.fixture()
def elastic_data(tmp_path):
    from test_torch_resume_apps import _bands, _dataset

    from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

    _bands(tmp_path)
    _dataset(str(tmp_path / "a.h5"))
    make_synthetic_workload(str(tmp_path), 2, n_tenants=1, device="cpu")
    return tmp_path


@pytest.mark.parametrize("i", range(len(ELASTIC)))
def test_elastic_and_fleet_modes_run_to_exit_0(elastic_data, i):
    from sagecal_tpu_torch.apps.cli import main

    argv = [a.format(d=elastic_data) for a in ELASTIC[i]]
    assert main(argv, device="cpu") == 0
    if "--checkpoint-every" in argv:
        assert glob.glob(f"{elastic_data}/**/ckpt_t*.npz", recursive=True)


@pytest.fixture()
def bands(tmp_path):
    """tests/test_torch_distributed_spatial.py's band files and skies: 4
    bands of 7 stations, two tiles, the diffuse sky t3 with its -G file."""
    from test_torch_distributed_spatial import _diffuse_bands

    _diffuse_bands(tmp_path)
    return tmp_path


@pytest.mark.parametrize("mode", [
    ["spatial", "--synthetic", "2", "--nstations", "5", "-j", "1", "-e", "1",
     "-g", "2", "-l", "2", "--fista-maxiter", "10"],
    ["-N", "1", "-M", "2", "-A", "2", "-l", "3"],
    ["-X", "1e-3,1e-4,2,10,1", "-A", "2", "-G", "{d}/t3.rho"],
    ["--spatial-n0", "2", "-A", "2", "--spatial-basis", "sharmonic"],
    ["-X", "1e-3,1e-4,2,10,1", "-A", "3", "--spatial-diffuse-id", "3",
     "-c", "{d}/t3.sky.txt.cluster"],
])
def test_spatial_modes_run_to_exit_0(bands, mode):
    from sagecal_tpu_torch.apps.cli import main

    d = str(bands)
    mode = [m.format(d=d) for m in mode]
    if mode[0] == "spatial":
        argv = mode + ["-o", f"{d}/sp"]
        want = [f"{d}/sp.json", f"{d}/sp.npz"]
    else:
        sky = f"{d}/t3.sky.txt" if "-c" in mode else f"{d}/t.sky.txt"
        argv = ["-s", sky, "-c", sky + ".cluster", "-f", f"{d}/band*.h5",
                "-t", "2", "-e", "1", "-g", "2", "-j", "1",
                "-p", f"{d}/z.txt"] + mode
        want = [f"{d}/z.txt.band3"]
        if "-X" in mode:
            want.append(f"{d}/z.txt.spatial.ppm")
    assert main(argv, device="cpu") == 0
    import os

    assert all(os.path.exists(p) for p in want), want


@pytest.mark.parametrize("x", ["1e-3,1e-4,2,20", "1e-3,1e-4,two,20,2"])
def test_malformed_x_is_a_usage_error(x, capsys):
    from sagecal_tpu_torch.apps.cli import main

    with pytest.raises(SystemExit) as e:
        main(["-f", "band*.h5", "-s", "sky.txt", "-X", x], device="cpu")
    assert e.value.code == 2
    assert "-X expects 5" in capsys.readouterr().err


@pytest.mark.parametrize("argv,want", [
    (["widefield", "-n", "6", "--ntiles", "2", "-S", "120", "--nblobs", "3",
      "-k", "2", "-j", "1", "-e", "1", "-g", "2", "-l", "2",
      "--out-dir", "{d}/wf"], ["{d}/wf/widefield.json",
                               "{d}/wf/solutions.npz"]),
    (["refine", "--synthetic", "3", "--outer-iters", "1", "--inner-iters",
      "3", "--adjoint-matvec", "jtj", "-o", "{d}/rf/r"],
     ["{d}/rf/r.json", "{d}/rf/r.npz", "{d}/rf/r.trace.jsonl"]),
])
def test_widefield_and_refine_run_to_exit_0(tmp_path, argv, want):
    from sagecal_tpu_torch.apps.cli import main

    d = str(tmp_path)
    assert main([a.format(d=d) for a in argv], device="cpu") == 0
    import os

    assert all(os.path.exists(p.format(d=d)) for p in want)


def test_refine_fused_exits_2_with_fused_sky_gradient_error(capsys):
    from sagecal_tpu_torch.apps.cli import main

    assert main(["refine", "--synthetic", "3", "--fused"], device="cpu") == 2
    assert "FusedSkyGradientError" in capsys.readouterr().err


def test_multihost_one_rank_writes_the_one_process_files(bands, monkeypatch):
    """``-f ... --multihost`` as a world of one gloo rank (the rank
    environment set here) writes the files of the run without it."""
    import socket

    from sagecal_tpu_torch.apps.cli import main

    d = str(bands)
    base = ["-s", f"{d}/t.sky.txt", "-c", f"{d}/t.sky.txt.cluster", "-f",
            f"{d}/band*.h5", "-t", "2", "-e", "1", "-g", "2", "-j", "1",
            "-A", "2"]
    assert main(base + ["-p", f"{d}/a.txt"], device="cpu") == 0
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    assert main(base + ["-p", f"{d}/b.txt", "--multihost"],
                device="cpu") == 0
    import torch.distributed as dist

    assert not dist.is_initialized()
    for suffix in ["", ".band0", ".band3"]:
        with open(f"{d}/a.txt{suffix}", "rb") as fa, \
                open(f"{d}/b.txt{suffix}", "rb") as fb:
            assert fa.read() == fb.read(), suffix


@pytest.mark.parametrize("sub", ["stream", "load", "convert"])
def test_stream_load_and_convert_subcommands_run(sub, tmp_path, monkeypatch,
                                                 capsys):
    """The subcommands the port once refused with exit 2 (A9b, A10) now
    run: ``stream`` solves a synthetic stream (exit 0); ``load`` maps a
    drained and an undrained run to 0 and 4 (the runner stubbed: a real
    run is tests/test_torch_load.py's); ``convert`` raises the
    reference's RuntimeError on a host without python-casacore."""
    from sagecal_tpu_torch.apps.cli import main

    if sub == "stream":
        out = str(tmp_path / "s")
        assert main(["stream", "--synthetic", "5", "--ntime", "3",
                     "--out-dir", out, "-j", "1", "-R", "-e", "1", "-l",
                     "3"], device="cpu") == 0
        assert sorted(n for n in os.listdir(out)
                      if n.endswith(".result.json")) == [
            f"stream_N5-w{w:04d}.result.json" for w in range(2)]
    elif sub == "load":
        import sagecal_tpu_torch.fleet.loadgen as lg

        seen = []

        def run(self, elog=None):
            seen.append((self.device, self.spec.arrival, self.cfg.workers))
            return {"drained": len(seen) == 1}

        monkeypatch.setattr(lg.LoadRunner, "run", run)
        argv = ["load", "--out-dir", str(tmp_path / "l"), "--workers", "3",
                "--arrival", "onoff"]
        assert main(argv, device="cpu") == 0
        assert main(argv, device="cpu") == 4
        assert seen == [("cpu", "onoff", 3)] * 2
    else:
        with pytest.raises(RuntimeError, match="python-casacore"):
            main(["convert", "a.ms", str(tmp_path / "b.h5")], device="cpu")
    assert "not ported yet" not in capsys.readouterr().err
