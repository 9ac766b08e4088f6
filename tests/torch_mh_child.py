"""One rank of the port's two-process runs (tests/test_torch_multihost.py).

``python torch_mh_child.py MODE ...`` with RANK, WORLD_SIZE, MASTER_ADDR
and MASTER_PORT in the environment, on the CPU over gloo:

- ``mesh IN OUT NSHARDS ZSTEP``: the consensus ADMM mesh over the
  pickled band tiles ``IN`` (``make_admm_mesh_fn(group=...)``), its
  result written to ``OUT.<rank>.npz``;
- ``sharded IN OUT NSHARDS``: the rows-sharded joint fit of the pickled
  tile ``IN``, written to ``OUT.<rank>.npz``;
- ``cli ARGV...``: the command line (``-f ... --multihost``);
- ``clifail RANK ARGV...``: the same, with a fault injected in rank
  ``RANK``: its second shard gather raises before it reaches the
  collective, while the other rank waits in it.

Imports torch and the port only.
"""

import os
import pickle
import sys

import numpy as np


def _mesh(inp, out, nshards, zstep):
    from sagecal_tpu_torch.interop import (
        admm_result_to_numpy, admm_state_from_numpy, batch_from_numpy,
    )
    from sagecal_tpu_torch.parallel import consensus, multihost
    from sagecal_tpu_torch.parallel.mesh import make_admm_mesh_fn
    from sagecal_tpu_torch.solvers.lm import LMConfig

    with open(inp, "rb") as fh:
        w = pickle.load(fh)
    group = multihost.init_from_env("cpu")
    d, c, p0 = batch_from_numpy(w["bands"], device="cpu")
    st = admm_state_from_numpy({"rho": w["rho"], "B": w["B"]}, device="cpu")
    fn = make_admm_mesh_fn(
        nshards, nadmm=w["nadmm"], max_emiter=1, plain_emiter=1,
        lm_config=LMConfig(itmax=6), bb_rho=False,
        consensus_cfg=consensus.ConsensusConfig(zstep=zstep),
        group=group, device="cpu")
    res = admm_result_to_numpy(fn(d, c, p0, st["rho"], st["B"]))
    np.savez(f"{out}.{group.rank}.npz", **res)
    multihost.close(group)


def _sharded(inp, out, nshards):
    from sagecal_tpu_torch.interop import tile_from_numpy
    from sagecal_tpu_torch.parallel import multihost
    from sagecal_tpu_torch.solvers import pad_rows_to, sharded_joint_fit

    with open(inp, "rb") as fh:
        w = pickle.load(fh)
    group = multihost.init_from_env("cpu")
    data, cdata, p0 = tile_from_numpy(w["tile"], device="cpu")
    data, cdata = pad_rows_to(data, cdata, 8)
    p, cost, it = sharded_joint_fit(data, cdata, p0, nshards, itmax=25,
                                    robust_nu=w["nu"], group=group,
                                    device="cpu")
    np.savez(f"{out}.{group.rank}.npz", p=p.numpy(), cost=cost.numpy(),
             it=np.asarray(it))
    multihost.close(group)


def main():
    mode = sys.argv[1]
    if mode == "mesh":
        _mesh(sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5])
    elif mode == "sharded":
        _sharded(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    elif mode == "cli":
        from sagecal_tpu_torch.apps.cli import main as cli_main

        sys.exit(cli_main(sys.argv[2:], device="cpu"))
    elif mode == "clifail":
        from sagecal_tpu_torch.apps.cli import main as cli_main
        from sagecal_tpu_torch.parallel import multihost

        if os.environ["RANK"] == sys.argv[2]:
            real, calls = multihost.gather_shards, []

            def faulty(local, group):
                calls.append(1)
                if len(calls) == 2:
                    raise RuntimeError("injected fault")
                return real(local, group)

            multihost.gather_shards = faulty
        sys.exit(cli_main(sys.argv[3:], device="cpu"))
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
