"""Two-process runs of the port over ``torch.distributed``
(``parallel/multihost.py``; the JAX package's ``jax.distributed`` runs of
tests/test_multihost.py).

Each case spawns two ranks (tests/torch_mh_child.py, gloo on the CPU,
each with its own time limit) and holds them to the one-process run
with the same ``nshards`` bit for bit: the collectives keep every sum's
order.  The mesh workload is tests/mh_common.py's (8 bands of 6
stations, 2 clusters), built here by the JAX package; the one-process
port mesh is held to the JAX mesh on 8 devices within 1e-8 of each
field's largest magnitude.
"""

import os
import pickle
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_port_common import free_jax_programs, tile_arrays  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "torch_mh_child.py")
NADMM = 4


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread in this process, as in the ranks: the tiles are
    tiny and a thread pool costs more than it saves."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_ranks(args, cwds=(None, None), timeout=60, expect_ok=True):
    """Run the child with ``args`` as ranks 0 and 1; returns their
    outputs (each rank's exit code must be 0, or with ``expect_ok``
    False, must not be)."""
    env = dict(os.environ)
    env.update(WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(HERE) + os.pathsep + HERE)
    procs = [subprocess.Popen([sys.executable, CHILD] + list(args),
                              env=dict(env, RANK=str(r), LOCAL_RANK="0"),
                              cwd=cwds[r], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert (p.returncode == 0) == expect_ok, out[-3000:]
    finally:
        # never leave a rank waiting in a collective
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """mh_common's 8-band workload as port inputs, pickled for the
    ranks, with the JAX mesh's result on 8 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import mh_common
    from sagecal_tpu.parallel.mesh import make_admm_mesh_fn as jmesh
    from sagecal_tpu.solvers.lm import LMConfig as JLM

    data, cdata, p0, rho, B = mh_common.build_workload()
    bands = []
    for b in range(mh_common.Nf):
        lane = lambda x: jax.tree_util.tree_map(lambda y: y[b], x)  # noqa
        bands.append(tile_arrays(lane(data), lane(cdata), p0[b]))
    mesh = Mesh(np.array(jax.devices()[:8]), ("freq",))
    out = jmesh(mesh, nadmm=NADMM, max_emiter=1, plain_emiter=1,
                lm_config=JLM(itmax=6), bb_rho=False)(
        data, cdata, jnp.asarray(p0), jnp.asarray(rho), jnp.asarray(B))
    path = tmp_path_factory.mktemp("mh") / "bands.pkl"
    with open(path, "wb") as fh:
        pickle.dump(dict(bands=bands, rho=np.asarray(rho), B=np.asarray(B),
                         nadmm=NADMM), fh)
    return path, {k: np.asarray(getattr(out, k))
                  for k in ("p", "Y", "Z", "rho", "dual_res", "primal_res")}


def _one_process_mesh(path, nshards, zstep):
    from sagecal_tpu_torch.interop import (
        admm_result_to_numpy, admm_state_from_numpy, batch_from_numpy,
    )
    from sagecal_tpu_torch.parallel import consensus
    from sagecal_tpu_torch.parallel.mesh import make_admm_mesh_fn
    from sagecal_tpu_torch.solvers.lm import LMConfig

    with open(path, "rb") as fh:
        w = pickle.load(fh)
    d, c, p0 = batch_from_numpy(w["bands"], device="cpu")
    st = admm_state_from_numpy({"rho": w["rho"], "B": w["B"]}, device="cpu")
    fn = make_admm_mesh_fn(
        nshards, nadmm=NADMM, max_emiter=1, plain_emiter=1,
        lm_config=LMConfig(itmax=6), bb_rho=False,
        consensus_cfg=consensus.ConsensusConfig(zstep=zstep), device="cpu")
    return admm_result_to_numpy(fn(d, c, p0, st["rho"], st["B"]))


@pytest.mark.parametrize("nshards,zstep", [(8, "grouped"), (4, "reduced")])
def test_two_rank_mesh_is_bit_identical_to_one_process(workload, tmp_path,
                                                       nshards, zstep):
    path, jax_out = workload
    _two_ranks(["mesh", str(path), str(tmp_path / "out"), str(nshards),
                zstep])
    one = _one_process_mesh(path, nshards, zstep)
    for r in range(2):
        got = np.load(tmp_path / f"out.{r}.npz")
        assert set(got.files) == set(one)
        for k in one:
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    if nshards == 8 and zstep == "grouped":
        # the JAX mesh on 8 devices: 1e-8 of each field's magnitude
        for k, ref in jax_out.items():
            scale = max(float(np.max(np.abs(ref))), 1e-30)
            assert float(np.max(np.abs(one[k] - ref))) <= 1e-8 * scale, k


def test_two_rank_sharded_fit_is_bit_identical(tmp_path):
    from test_sharded import _scene

    import jax.numpy as jnp

    from sagecal_tpu.core.types import identity_jones, jones_to_params
    from sagecal_tpu_torch.interop import tile_from_numpy
    from sagecal_tpu_torch.solvers import pad_rows_to, sharded_joint_fit

    data, cdata = _scene(m=2, nst=7)
    p0 = jones_to_params(jnp.broadcast_to(
        identity_jones(7, jnp.complex128), (2, 1, 7, 2, 2)))
    tile = tile_arrays(data, cdata, p0)
    path = tmp_path / "tile.pkl"
    with open(path, "wb") as fh:
        pickle.dump(dict(tile=tile, nu=5.0), fh)
    _two_ranks(["sharded", str(path), str(tmp_path / "fit"), "4"])
    d, c, p0t = tile_from_numpy(tile, device="cpu")
    d, c = pad_rows_to(d, c, 8)
    p, cost, it = sharded_joint_fit(d, c, p0t, 4, itmax=25, robust_nu=5.0,
                                    device="cpu")
    for r in range(2):
        got = np.load(tmp_path / f"fit.{r}.npz")
        np.testing.assert_array_equal(got["p"], p.numpy())
        assert float(got["cost"]) == float(cost) and int(got["it"]) == it


def test_two_rank_cli_writes_the_one_process_files(tmp_path):
    """``-f ... --multihost`` as two ranks (each with its own copy of the
    band files, as on two hosts): rank 0 writes the Z file and bands 0-1,
    rank 1 bands 2-3, each file and residual column bit-identical to the
    one-process run's."""
    import h5py

    from test_distributed import _make_bands
    from sagecal_tpu_torch.apps.cli import main

    src = tmp_path / "bands"
    src.mkdir()
    _make_bands(src, Nf=4)
    dirs = []
    for name in ("one", "rank0", "rank1"):
        d = tmp_path / name
        shutil.copytree(src, d)
        dirs.append(d)

    def argv(d, out):
        sky = os.path.join(d, "t.sky.txt")
        return ["-s", sky, "-c", sky + ".cluster",
                "-f", os.path.join(d, "band*.h5"), "-t", "2", "-e", "1",
                "-g", "4", "-j", "1", "-A", "3", "-P", "2", "-r", "10",
                "-C", "1", "-p", str(out)]

    assert main(argv(str(dirs[0]), tmp_path / "z1.txt"), device="cpu") == 0
    # each rank reads the copy in its working directory
    _two_ranks(["cli"] + argv(".", tmp_path / "z2.txt") + ["--multihost"],
               cwds=(str(dirs[1]), str(dirs[2])))
    assert (tmp_path / "z2.txt").read_bytes() == (
        tmp_path / "z1.txt").read_bytes()
    for i in range(4):
        a = (tmp_path / f"z2.txt.band{i}").read_bytes()
        assert a == (tmp_path / f"z1.txt.band{i}").read_bytes(), i
        mine = dirs[1 + i // 2]
        with h5py.File(dirs[0] / f"band{i}.h5", "r") as f1, \
                h5py.File(mine / f"band{i}.h5", "r") as f2:
            np.testing.assert_array_equal(f2["corrected"][...],
                                          f1["corrected"][...])


def test_one_failing_rank_ends_both_ranks(tmp_path):
    """A fault in one rank mid-run (its second shard gather raises while
    the other rank waits in that collective) ends both ranks with a
    non-zero exit within the time limit: the failing rank leaves the
    group without a barrier, the waiting one sees its connection close."""
    from test_distributed import _make_bands

    dirs = []
    for r in range(2):
        d = tmp_path / f"rank{r}"
        d.mkdir()
        _make_bands(d, Nf=4)
        dirs.append(str(d))
    sky = "t.sky.txt"
    argv = ["-s", sky, "-c", sky + ".cluster", "-f", "band*.h5", "-t", "2",
            "-e", "1", "-g", "4", "-j", "1", "-A", "3", "-P", "2", "-r",
            "10", "-p", str(tmp_path / "z.txt"), "--multihost"]
    outs = _two_ranks(["clifail", "1"] + argv, cwds=dirs, timeout=30,
                      expect_ok=False)
    assert "injected fault" in outs[1], outs[1][-3000:]
