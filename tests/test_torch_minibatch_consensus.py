"""Port vs JAX package: the minibatch app (``apps/minibatch.py``)
through both command lines in band consensus (``-N 1 -M 2 -w 4 -A 2``),
with tests/test_torch_minibatch.py's dataset and bars.
"""

import h5py
import numpy as np

from test_torch_minibatch import TOL, _close, twins  # noqa: F401
from torch_port_common import free_jax_programs  # noqa: F401


def test_cli_minibatch_matches_jax_cli(twins):  # noqa: F811
    """Both CLIs: -N 1 -w 4 -A 2 -M 2 (minibatch consensus)."""
    from sagecal_tpu.apps.cli import main as jmain
    from sagecal_tpu_torch.apps.cli import main

    def argv(tag):
        sky = str(twins / "t.sky.txt")
        return ["-d", str(twins / f"{tag}.h5"), "-s", sky, "-c",
                sky + ".cluster", "-N", "1", "-M", "2", "-w", "4", "-A", "2",
                "-P", "2", "-Q", "0", "-r", "2", "-j", "1", "-l", "6",
                "-m", "5", "-p", str(twins / f"{tag}.sol")]

    assert jmain(argv("j")) in (0, None)
    assert main(argv("t"), device="cpu") == 0
    from sagecal_tpu_torch.io import solutions as solio

    _close(solio.read_solutions(str(twins / "t.sol"))[1],
           solio.read_solutions(str(twins / "j.sol"))[1])
    with h5py.File(twins / "j.h5", "r") as fj, h5py.File(twins / "t.h5",
                                                          "r") as ft:
        scale = float(np.max(np.abs(np.asarray(fj["vis"]))))
        _close(np.asarray(ft["corrected"]), np.asarray(fj["corrected"]),
               TOL, TOL * scale)
