"""Where one robust RTR cluster solve spends its time on the card.

Run from the root of the repository, on a machine with one CUDA card::

    python3 -m sagecal_tpu_torch.tools.rtr_profile [--json-out FILE]

On the north-star geometry (62 stations, 60 timeslots x 2 channels =
113,460 rows, 8 point clusters, gains identity + 0.2 complex-normal,
noise 1e-3) it takes cluster 0's solve of a mode-5 EM pass at the
main path's depth (``rtr_solve_robust``, ``RTRConfig(23, 28)``,
``itmax_dynamic`` 6, two Student's-t rounds) and prints:

- one per-row 2x2 complex product at the solver's shape, (rows, F, 2,
  2), as ``torch.matmul`` (a cuBLAS batched gemm) and as the solver's
  broadcast multiply and sum (``rtr._mm``), from CUDA events;
- the solve's wall time and host reads (``rtr.host_read.count``), with
  the solver's products as they are and with every per-row product
  routed through ``torch.matmul`` instead (the same results);
- a ``torch.profiler`` trace of the solve: kernel launches, host syncs,
  host milliseconds, the device's busy milliseconds (the kernels' and
  copies' own time) and idle share of the solve's wall time, and the
  five kernels of most device time.

Every line carries the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

NSTATIONS, TILESZ, NCHAN, NCLUSTERS = 62, 60, 2, 8
CFG = dict(itmax_rsd=23, itmax_rtr=28)  # max_iter 6 x iter_budget_cap 3
ITMAX_DYNAMIC = 6


def _tile(device):
    from sagecal_tpu_torch.core.types import jones_to_params
    from sagecal_tpu_torch.io.simulate import (
        corrupt_and_observe, make_visdata, random_jones,
    )
    from sagecal_tpu_torch.ops.rime import point_source_batch
    from sagecal_tpu_torch.solvers.sage import build_cluster_data

    rng = np.random.default_rng(3)
    data = make_visdata(nstations=NSTATIONS, tilesz=TILESZ, nchan=NCHAN,
                        device=device)
    clusters = [point_source_batch(rng.uniform(-0.03, 0.03, 1),
                                   rng.uniform(-0.03, 0.03, 1),
                                   rng.uniform(1.0, 10.0, 1), device=device)
                for _ in range(NCLUSTERS)]
    truth = random_jones(NCLUSTERS, NSTATIONS, seed=5, amp=0.2, device=device)
    data = corrupt_and_observe(data, clusters, jones=truth, noise_sigma=1e-3)
    cdata = build_cluster_data(data, clusters, [1] * NCLUSTERS)
    p0 = jones_to_params(random_jones(NCLUSTERS, NSTATIONS, seed=9, amp=0.0,
                                      device=device))[:, None, :]
    return data, cdata, p0


def profile(card: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    from sagecal_tpu_torch.core.types import params_to_jones
    from sagecal_tpu_torch.solvers import rtr
    from sagecal_tpu_torch.solvers.lm import NormalEqPlan
    from sagecal_tpu_torch.tools.profile_kernel import cuda_ms

    dev = torch.device("cuda")
    data, cdata, p0 = _tile(dev)
    cmap = cdata.chunk_map[0]
    args = (data.vis, cdata.coh[0], data.mask, data.ant_p, data.ant_q, cmap,
            p0[0])
    plan = NormalEqPlan(data.ant_p, data.ant_q, cmap, 1, NSTATIONS)
    out = {"card": card, "rows": data.rows}

    fns = rtr._Fns(data.vis, cdata.coh[0], data.mask, plan)
    Jp = fns._gather(params_to_jones(p0[0]))[0]
    out["matmul_ms"] = cuda_ms(lambda: Jp @ fns.C, 50)
    out["broadcast_ms"] = cuda_ms(lambda: rtr._mm(Jp, fns.C), 50)
    print(f"[rtr] ({card}) a per-row 2x2 complex product, "
          f"({data.rows}, {NCHAN}, 2, 2): torch.matmul {out['matmul_ms']:.4f}"
          f" ms, broadcast multiply and sum {out['broadcast_ms']:.4f} ms",
          flush=True)

    def solve():
        rtr.host_read.count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, _ = rtr.rtr_solve_robust(*args, rtr.RTRConfig(**CFG), nu0=2.0,
                                      em_iters=2, itmax_dynamic=ITMAX_DYNAMIC,
                                      plan=plan)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, rtr.host_read.count, res

    solve()  # warm-up
    wall, reads, res = solve()
    mm, mm_f = rtr._mm, rtr._mm_f
    try:
        rtr._mm = torch.matmul
        rtr._mm_f = lambda a, b: (a @ b).sum(1)
        solve()
        wall_mm, reads_mm, res_mm = solve()
    finally:
        rtr._mm, rtr._mm_f = mm, mm_f
    cost_rel = float((res_mm.cost - res.cost).abs().max()
                     / res.cost.abs().max())
    out.update(solve_s=wall, host_reads=reads, solve_s_matmul=wall_mm,
               host_reads_matmul=reads_mm, cost_rel_matmul=cost_rel)
    print(f"[rtr] ({card}) robust RTR cluster solve: {wall:.3f} s, "
          f"{reads} host reads; with torch.matmul products {wall_mm:.3f} s, "
          f"{reads_mm} host reads, final cost rel diff {cost_rel:.2e}",
          flush=True)

    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        wall_traced = solve()[0]
    ev = p.key_averages()
    count = lambda name: sum(e.count for e in ev if e.key == name)
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    out.update(
        launches=count("cudaLaunchKernel") + count("cudaLaunchKernelExC"),
        stream_syncs=count("cudaStreamSynchronize"),
        host_ms=sum(e.self_cpu_time_total for e in ev
                    if e.device_type != DeviceType.CUDA) / 1e3,
        sync_wait_ms=sum(e.self_cpu_time_total for e in ev
                         if e.key == "cudaStreamSynchronize") / 1e3,
        wall_traced_s=wall_traced, device_busy_ms=busy,
        device_idle_share=1.0 - busy / (wall_traced * 1e3),
        top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in
             sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]])
    print(f"[rtr] ({card}) trace of the solve ({wall_traced:.3f} s traced): "
          f"{out['launches']} kernel launches, {out['stream_syncs']} stream "
          f"syncs, host {out['host_ms']:.1f} ms ({out['sync_wait_ms']:.1f} of "
          f"it waiting on the device), device busy {busy:.1f} ms, idle "
          f"share {out['device_idle_share']:.3f}", flush=True)
    for name, ms, n in out["top"]:
        print(f"[rtr] ({card})   {name[:60]}: {ms:.3f} ms over {n} calls",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rtr_profile: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else (
        torch.cuda.get_device_name(0))
    out = profile(card)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
