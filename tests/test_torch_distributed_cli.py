"""Port vs JAX package: the multi-band consensus-ADMM app
(``apps/distributed.py``), continued from tests/test_torch_distributed.py
with its helpers and bars: bands of unequal length, a float32 run, both
command lines (``-f ... -U 1 --mdl -C 1``) and the ``--mdl`` log.
"""

import math
import os

import h5py
import numpy as np

from test_distributed import CLUSTER, _make_bands
from test_torch_distributed import (
    F32_TOL, TOL, _cfgs, _compare_files, _compare_traces, _run_both, _twins,
)
from torch_port_common import free_jax_programs  # noqa: F401


def _unequal_bands(d):
    from sagecal_tpu.io.dataset import simulate_dataset
    from sagecal_tpu.io.skymodel import load_sky

    from test_distributed import SKY

    sky = d / "t.sky.txt"
    sky.write_text(SKY)
    (d / "t.sky.txt.cluster").write_text(CLUSTER)
    clusters, _, _ = load_sky(str(sky), str(sky) + ".cluster", 0.0,
                              math.radians(51.0), dtype=np.float64)
    for i, nt in enumerate((3, 5)):
        p = d / f"band{i}.h5"
        simulate_dataset(str(p), nstations=7, ntime=nt, nchan=1,
                         freq0=(140e6, 160e6)[i], clusters=clusters,
                         noise_sigma=1e-4, seed=i, dec0=math.radians(51.0))
        with h5py.File(str(p), "r+") as f:
            f.attrs["ra0"] = 0.0
            f.attrs["dec0"] = math.radians(51.0)


def test_distributed_unequal_band_lengths(tmp_path, devices8):
    """Bands of 3 and 5 timeslots: tiles clamp to the common 3 (a full
    tile, then a partial one loaded directly)."""
    jdir, tdir = _twins(tmp_path, _unequal_bands)
    jcfg, tcfg = _cfgs(jdir, tdir, admm_iters=2)
    tj, tt = _run_both(jcfg, tcfg, nshards=2)
    assert len(tt) == 2
    _compare_traces(tt, tj, TOL)
    _compare_files(jdir, tdir, 2, TOL)


def test_distributed_f32_plain_kernel_1(tmp_path, devices8):
    """--f32: the residual column through the plain version of kernel #1
    (CPU tensors), the JAX package's through XLA."""
    jdir, tdir = _twins(tmp_path, lambda d: _make_bands(d, Nf=4))
    jcfg, tcfg = _cfgs(jdir, tdir, use_f64=False)
    tj, tt = _run_both(jcfg, tcfg, nshards=4)
    _compare_traces(tt, tj, F32_TOL)
    _compare_files(jdir, tdir, 4, F32_TOL)


def test_cli_distributed_matches_jax_cli(tmp_path, devices8):
    """Both CLIs on the same band files, with -U 1, --mdl and -C 1 (the
    BB rho update; the CLI's default is off)."""
    from sagecal_tpu.apps.cli import main as jmain
    from sagecal_tpu_torch.apps.cli import main

    jdir, tdir = _twins(tmp_path, lambda d: _make_bands(d, Nf=4))

    def argv(d):
        sky = str(d / "t.sky.txt")
        return ["-s", sky, "-c", sky + ".cluster", "-f", str(d / "band*.h5"),
                "-t", "2", "-e", "1", "-g", "4", "-j", "1", "-A", "3",
                "-P", "2", "-r", "10", "-C", "1", "-U", "1", "--mdl",
                "-p", str(d / "z.txt")]

    assert jmain(argv(jdir)) in (0, None)
    assert main(argv(tdir), device="cpu") == 0
    _compare_files(jdir, tdir, 4, TOL)
    assert os.path.exists(tdir / "z.txt.band3")


def test_distributed_mdl_log_matches_jax(tmp_path, devices8):
    """--mdl: the per-tile AIC/MDL scan logged as the JAX package logs
    it."""
    jdir, tdir = _twins(tmp_path, lambda d: _make_bands(d, Nf=4))
    jcfg, tcfg = _cfgs(jdir, tdir, npoly=3)
    from sagecal_tpu.apps.distributed import run_distributed as jrun
    from sagecal_tpu_torch.apps.distributed import run_distributed

    logs = {"j": [], "t": []}
    jrun(jcfg, log=lambda *a: logs["j"].append(" ".join(map(str, a))),
         mdl=True)
    run_distributed(tcfg, log=lambda *a: logs["t"].append(
        " ".join(map(str, a))), mdl=True, device="cpu", nshards=4)
    pick = lambda k: [s for s in logs[k] if "MDL" in s]  # noqa: E731
    assert pick("t") and pick("t") == pick("j")
