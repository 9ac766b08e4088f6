"""Save a checkout's solves of one seeded tile, and compare two saves bit
for bit: whether a change to the solvers keeps their predecessor's bits,
host reads and kernel launches.

Run as a file (not with ``-m``)::

    python3 sagecal_tpu_torch/tools/solve_outputs.py save DIR FILE [--device cpu]
    python3 sagecal_tpu_torch/tools/solve_outputs.py compare FILE_A FILE_B

``save`` imports DIR's own package (DIR first on the import path, as
``probe_outputs.py`` does), builds a tile of 9 stations, 3 point
clusters (the first with two hybrid chunks), 4 timeslots x 2 channels
and noise 1e-3 from numpy seeds, and solves it with ``sagefit`` in
modes 0-6: float32 on the torch-op and the fused joint cost, float64 on
the torch-op one (2 EM passes, max_iter 3, 5 LBFGS iterations).  It
saves each solve's ``p`` and ``res_1``, the RTR solver's host reads
(``rtr.host_read.count``) and the objective kernels' launches (0 on the
CPU) with ``torch.save``.  ``compare`` prints each entry that differs
and exits 1 if any does or is missing from either save.  ``--device``
defaults to the CUDA device.
"""

import argparse
import importlib
import os
import sys

import numpy as np
import torch

MODES = (0, 1, 2, 3, 4, 5, 6)


def _tile(dtype, device):
    types = importlib.import_module("sagecal_tpu_torch.core.types")
    sim = importlib.import_module("sagecal_tpu_torch.io.simulate")
    rime = importlib.import_module("sagecal_tpu_torch.ops.rime")
    sage = importlib.import_module("sagecal_tpu_torch.solvers.sage")
    cdt = np.complex64 if dtype == torch.float32 else np.complex128
    rng = np.random.default_rng(3)
    data = sim.make_visdata(nstations=9, tilesz=4, nchan=2,
                            dtype=np.float32 if cdt == np.complex64
                            else np.float64, device=device)
    clusters = [rime.point_source_batch(
        rng.uniform(-0.02, 0.02, 2), rng.uniform(-0.02, 0.02, 2),
        rng.uniform(1.0, 5.0, 2), dtype=dtype, device=device)
        for _ in range(3)]
    truth = sim.random_jones(3, 9, seed=5, amp=0.2, dtype=cdt, device=device)
    data = sim.corrupt_and_observe(data, clusters, jones=truth,
                                   noise_sigma=1e-3)
    cdata = sage.build_cluster_data(data, clusters, [2, 1, 1])
    p0 = types.jones_to_params(sim.random_jones(3, 9, seed=9, amp=0.0,
                                                dtype=cdt, device=device))
    return data, cdata, p0[:, None, :].repeat(1, 2, 1)


def save(root: str, path: str, device: str):
    root = os.path.abspath(root)
    path = os.path.abspath(path)
    sys.path[0] = root  # this file's own directory would come first
    sage = importlib.import_module("sagecal_tpu_torch.solvers.sage")
    rtr = importlib.import_module("sagecal_tpu_torch.solvers.rtr")
    rk = importlib.import_module("sagecal_tpu_torch.ops.rime_kernel")
    kernels = (rk.fused_cost_fwd_cuda, rk.fused_cost_bwd_cuda)
    out = {}
    for dtype in (torch.float32, torch.float64):
        data, cdata, p0 = _tile(dtype, device)
        for mode in MODES:
            for fused in ((False, True) if dtype == torch.float32
                          else (False,)):
                rtr.host_read.count = 0
                for k in kernels:
                    k.launches = 0
                res = sage.sagefit(data, cdata, p0, sage.SageConfig(
                    solver_mode=mode, max_emiter=2, max_iter=3, max_lbfgs=5,
                    use_fused_predict=fused), device=device)
                key = f"{str(dtype)[6:]} mode {mode} fused {int(fused)}"
                out[key + " p"] = res.p.cpu()
                out[key + " res_1"] = res.res_1.cpu()
                out[key + " host reads"] = torch.tensor(rtr.host_read.count)
                out[key + " launches"] = torch.tensor(
                    [k.launches for k in kernels])
    torch.save(out, path)
    print(f"[solve-outputs] {root}: {len(out)} entries saved to {path}")


def compare(path_a: str, path_b: str) -> int:
    a, b = torch.load(path_a), torch.load(path_b)
    missing = sorted(set(a) ^ set(b))
    differ = [k for k in sorted(set(a) & set(b))
              if not torch.equal(a[k], b[k])]
    for key in differ:
        print(f"[solve-outputs] {key}: differs ({a[key].flatten()[:4]} vs "
              f"{b[key].flatten()[:4]})")
    if missing:
        print(f"[solve-outputs] in one save only: {missing}")
    print(f"[solve-outputs] {len(set(a) & set(b)) - len(differ)} entries "
          f"equal bit for bit, {len(differ)} differ, {len(missing)} missing")
    return 1 if differ or missing else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("save")
    sv.add_argument("dir")
    sv.add_argument("file")
    sv.add_argument("--device", default="cuda")
    cp = sub.add_parser("compare")
    cp.add_argument("file_a")
    cp.add_argument("file_b")
    args = ap.parse_args(argv)
    if args.cmd == "save":
        if args.device == "cuda" and not torch.cuda.is_available():
            sys.exit("no CUDA device (torch.cuda.is_available() is False)")
        save(args.dir, args.file, args.device)
    else:
        sys.exit(compare(args.file_a, args.file_b))


if __name__ == "__main__":
    main()
