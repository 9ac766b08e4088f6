"""Port vs JAX package: the command line (``apps/cli.py``).

``config_from_args(build_parser().parse_args(argv))`` gives the JAX
package's ``RunConfig`` field by field for a spread of argv (the same
flags and defaults); ``main(argv, device="cpu")`` runs a fullbatch and
returns 0, or 3 when ``--abort-on-divergence`` stops a diverged run;
every mode the port does not have yet exits 2 naming its ROADMAP.md
item (``serve``, ``-f`` and ``-N`` are dispatched; their unported options
are refused too: tests/test_torch_serve.py, and the ``-f``/``-N`` cases
here).
"""

import dataclasses

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
    (["serve", "--requests", "r.json", "--resume"], "A9"),
    (["fleet"], "A9"), (["load"], "A9"),
    (["stream"], "A9"), (["widefield"], "A8"), (["refine"], "A8"),
    (["spatial"], "A7"), (["convert", "a.ms", "b.h5"], "A10"),
    (["diag", "events"], "A11"),
    (["-f", "band*.h5", "-s", "sky.txt", "-N", "2"], "A7"),
    (["-f", "band*.h5", "-s", "sky.txt", "-X", "1e-3,1e-4,2,20,2"], "A7"),
    (["-f", "band*.h5", "-s", "sky.txt", "--spatial-n0", "2"], "A7"),
    (["-f", "band*.h5", "-s", "sky.txt", "--spatial-diffuse-id", "3"],
     "A7"),
    (["-f", "band*.h5", "-s", "sky.txt", "--multihost"], "A7"),
    (["-f", "band*.h5", "-s", "sky.txt", "--resume"], "A9"),
    (["-d", "x.h5", "-s", "sky.txt", "-N", "1", "--checkpoint-every", "1"],
     "A9"),
    (["-d", "x.h5", "-s", "sky.txt", "--device-profile", "prof"], "A11"),
    (["-d", "x.h5", "-s", "sky.txt", "--resume"], "A9"),
])
def test_unported_modes_exit_nonzero_naming_their_item(argv, item, capsys):
    from sagecal_tpu_torch.apps.cli import main

    assert main(argv, device="cpu") == 2
    assert f"ROADMAP.md, {item}" in capsys.readouterr().err
