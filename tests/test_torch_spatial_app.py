"""Port vs JAX package: the ``spatial`` app (``apps/spatial.py``) and the
command line's spatial modes (``apps/cli.py``).

The synthetic bands (``--synthetic``: ``data/simsky.py``'s multi-band
sky, the same draws in both packages) and tests/test_distributed.py's
band files, made by the JAX package and copied (once more into the
port's in-memory ``MemFile`` registry, read through ``MemFile.glob``).
Solver mode 1 (LM) in every run: the OS-LM modes draw their subsets
from each package's own generator.  Compared: ``<out>.json`` (every key
but the wall time) and ``<out>.npz``.  Bars: 1e-8 relative (of the
largest magnitude) at float64, 5e-3 at float32.
"""

import json

import h5py
import numpy as np
import pytest

from test_distributed import _make_bands
from torch_port_common import free_jax_programs  # noqa: F401

TOL = 1e-8
F32_TOL = 5e-3


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    err = float(np.max(np.abs(a - b))) / scale
    assert err < tol, err


def _compare_outputs(tprefix, jprefix, tol):
    tj = json.load(open(f"{tprefix}.json"))
    jj = json.load(open(f"{jprefix}.json"))
    assert set(tj) == set(jj)
    for k in jj:
        if k == "wall_s":
            continue
        if isinstance(jj[k], (str, int)) and not isinstance(jj[k], bool):
            assert tj[k] == jj[k], k
        else:
            _close(tj[k], jj[k], tol)
    tn, jn = np.load(f"{tprefix}.npz"), np.load(f"{jprefix}.npz")
    assert set(tn.files) == set(jn.files)
    for k in jn.files:
        _close(tn[k], jn[k], tol)


def _argv(out, *extra):
    return ["--synthetic", "3", "--nstations", "6", "-t", "2", "-j", "1",
            "-e", "2", "-g", "4", "-l", "4", "--spatial-n0", "2",
            "--fista-maxiter", "40", "-o", out, *extra]


@pytest.mark.parametrize("extra,tol", [((), TOL), (("--f32",), F32_TOL)])
def test_spatial_app_synthetic_matches_jax(tmp_path, extra, tol):
    import jax

    from sagecal_tpu.apps.spatial import build_parser as jparser
    from sagecal_tpu.apps.spatial import config_from_args as jconfig
    from sagecal_tpu.apps.spatial import run_spatial as jrun
    from sagecal_tpu_torch.apps.cli import main

    jrun(jconfig(jparser().parse_args(_argv(str(tmp_path / "j"), *extra))),
         log=lambda *a: None)
    jax.clear_caches()
    assert main(["spatial", *_argv(str(tmp_path / "t"), *extra)],
                device="cpu") == 0
    _compare_outputs(tmp_path / "t", tmp_path / "j", tol)
    summary = json.load(open(tmp_path / "t.json"))
    assert 1 <= summary["k_aic"] <= 2 and 1 <= summary["k_mdl"] <= 2
    assert np.isfinite(summary["fista_fit_rel"])


def _mem_copy(paths):
    """Each h5 band file copied into the MemFile registry under the same
    path with a ``.mem`` suffix."""
    from sagecal_tpu_torch.io.memh5 import MemFile

    for p in paths:
        with h5py.File(p, "r") as src, MemFile(p + ".mem", "w") as dst:
            for k in src.keys():
                dst.create_dataset(k, data=np.asarray(src[k]))
            for k, v in src.attrs.items():
                dst.attrs[k] = v


def test_spatial_app_from_band_files_matches_jax(tmp_path):
    """``-f`` over the JAX package's band files (4 bands of 7 stations)
    in the spherical-harmonic basis with normalized polynomials (-Q 1),
    and the same bands from ``MemFile`` (the card's opener)."""
    from sagecal_tpu.apps.spatial import build_parser as jparser
    from sagecal_tpu.apps.spatial import config_from_args as jconfig
    from sagecal_tpu.apps.spatial import run_spatial as jrun
    from sagecal_tpu_torch.apps.spatial import main
    from sagecal_tpu_torch.io.memh5 import MemFile, remove

    paths, sky = _make_bands(tmp_path, Nf=4, ntime=2)

    def argv(out, pattern):
        return ["-f", pattern, "-s", str(sky), "-t", "2", "-j", "1", "-e",
                "2", "-g", "4", "-l", "4", "-o", out, "--spatial-n0", "2",
                "--spatial-basis", "sharmonic", "-Q", "1"]

    jrun(jconfig(jparser().parse_args(argv(str(tmp_path / "j"),
                                           str(tmp_path / "band*.h5")))),
         log=lambda *a: None)
    assert main(argv(str(tmp_path / "t"), str(tmp_path / "band*.h5")),
                device="cpu") == 0
    _compare_outputs(tmp_path / "t", tmp_path / "j", TOL)
    _mem_copy(paths)
    try:
        assert main(argv(str(tmp_path / "m"), str(tmp_path / "band*.h5.mem")),
                    device="cpu", open_file=MemFile) == 0
    finally:
        for p in paths:
            remove(p + ".mem")
    _compare_outputs(tmp_path / "m", tmp_path / "j", TOL)


@pytest.mark.parametrize("flags", [["--resume"], ["--checkpoint-every", "1"],
                                   ["--checkpoint-dir", "ck"]])
def test_spatial_app_refuses_checkpoints_naming_a9(tmp_path, flags, capsys):
    """The checkpoint flags, refused until the port had ``elastic/``
    (A9), now run to exit 0 (the resumed bits:
    tests/test_torch_resume_apps.py)."""
    from sagecal_tpu_torch.apps.cli import main

    flags = [f if f != "ck" else str(tmp_path / "ck") for f in flags]
    assert main(["spatial", *_argv(str(tmp_path / "t")), *flags],
                device="cpu") == 0
    assert (tmp_path / "t.json").exists()
    if "--resume" not in flags:
        ck = tmp_path / ("ck" if "--checkpoint-dir" in flags else "t.ckpt")
        assert ck.exists() == ("--checkpoint-every" in flags)


def test_spatial_app_needs_bands(capsys):
    from sagecal_tpu_torch.apps.spatial import main

    with pytest.raises(SystemExit) as e:
        main([], device="cpu")
    assert e.value.code == 2


def test_spatial_parser_and_config_match_jax():
    import dataclasses

    from sagecal_tpu.apps.spatial import build_parser as jparser
    from sagecal_tpu.apps.spatial import config_from_args as jconfig
    from sagecal_tpu_torch.apps.spatial import build_parser, config_from_args

    def flags(p):
        return {(a.dest, tuple(a.option_strings), a.default)
                for a in p._actions}

    assert flags(build_parser()) == flags(jparser())
    argv = _argv("x", "--spatial-basis", "sharmonic", "--f32", "-V",
                 "--mdl-kmax", "4", "--noise-sigma", "0.1", "--seed", "9")
    assert (dataclasses.asdict(config_from_args(build_parser().parse_args(
        argv))) == dataclasses.asdict(jconfig(jparser().parse_args(argv))))
