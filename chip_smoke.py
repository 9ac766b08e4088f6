#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

It imports no JAX and nothing of ``sagecal_tpu``.  Phases, in order,
each printing lines of its own; any failure exits non-zero:

1. device   the card's name, the device count and ``nvidia-smi``'s name
            and power limit; no CUDA device -> exit 1;
2. build    ``nvcc`` builds every kernel source of
            ``sagecal_tpu_torch/csrc`` (one process per source, started
            together) and prints the ptxas register/shared-memory report;
3. parity   the fused-objective kernels against their plain PyTorch
            version at the north-star tile (62 stations, 100 clusters,
            60 timeslots x 2 channels = 113,460 rows): Gaussian and
            robust (nu = 5), nc 1 and 2, f32 and bf16 coherencies; cost
            relative error <= 1e-5, gradient error <= 1e-5 of its norm,
            backward bit-identical on repeat;
4. main     the port's main path from files, as a user runs it: an LSM
            sky of 100 point clusters and its cluster file -> ``load_sky``
            -> ``make_visdata`` -> ``corrupt_and_observe`` (noise 1e-3) ->
            ``build_cluster_data`` -> ``solve_tile`` (mode
            SM_OSLM_OSRLM_RLBFGS, fused joint cost) -> ``append_solutions``
            and ``read_solutions``; then ``solve_tile`` again with the
            torch-op joint cost.  Checks res_1 < res_0, fused and
            unfused res_1 within 5e-3, and that both kernels launched
            during the fused run (launch counts set to 0 just before it);
5. times    phase wall times, each kernel's time from CUDA events over
            many launches beside its bound and the plain version's time,
            and peak device memory, each beside the card's name and
            power limit.

The line before the last two is one JSON object ``{"kernels": [...]}``,
the line before the last is nvidia-smi's ``name, power.limit``, and the
last line is ``{"ok": true, "device": {...}}``.  EM and LBFGS depth can
be cut with the options below; the widths cannot.
"""

import argparse
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# north-star tile
NSTATIONS, NCLUSTERS, TILESZ, NCHAN = 62, 100, 60, 2
ROWS = NSTATIONS * (NSTATIONS - 1) // 2 * TILESZ  # 113,460
RA0, DEC0 = math.pi / 6, 0.9

# published peaks of one H100 SXM (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

COST_TOL = 1e-5
GRAD_TOL = 1e-5
RES1_TOL = 5e-3

SOURCE = "sagecal_tpu_torch/csrc/fused_cost.cu"
REPLACES = {
    "fused_cost_fwd": "sagecal_tpu/ops/rime_kernel.py:842",
    "fused_cost_bwd": "sagecal_tpu/ops/rime_kernel.py:877",
}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def sync_clock() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def phase_device():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(1)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"[device] {name} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvidia-smi: {card}", flush=True)
    return name, count, card


def phase_build():
    from sagecal_tpu_torch.kernels import build

    t = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t
    for name in paths:
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(paths)} source(s) built in {secs:.1f} s", flush=True)


def phase_parity():
    from sagecal_tpu_torch.kernels.parity import (
        compare_with_plain, random_cost_problem,
    )

    worst = {"fused_cost_fwd": 0.0, "fused_cost_bwd": 0.0}
    for nu, nc, dt in itertools.product((None, 5.0), (1, 2),
                                        (torch.float32, torch.bfloat16)):
        prob = random_cost_problem(NCLUSTERS, NSTATIONS, NCHAN, ROWS, nc=nc,
                                   coh_dtype=dt, seed=1, device="cuda")
        out = compare_with_plain(prob, nu)
        del prob
        torch.cuda.empty_cache()
        case = (f"{'robust' if nu else 'gaussian'} nc={nc} "
                f"coh={str(dt).split('.')[-1]}")
        ok = (out["cost_rel"] <= COST_TOL and out["grad_rel"] <= GRAD_TOL
              and out["bitwise_repeat"])
        print(f"[parity] {case}: cost_rel={out['cost_rel']:.3e} "
              f"grad_rel={out['grad_rel']:.3e} "
              f"bitwise_repeat={out['bitwise_repeat']} "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fail(f"kernel parity {case}: {out}")
        worst["fused_cost_fwd"] = max(worst["fused_cost_fwd"],
                                      out["cost_abs_err"])
        worst["fused_cost_bwd"] = max(worst["fused_cost_bwd"],
                                      out["grad_max_abs_err"])
    return worst


def write_sky(dirname: str, seed: int = 7):
    """An LSM sky of NCLUSTERS point sources within ~2 degrees of the
    phase centre, one per cluster, and its cluster file."""
    rng = np.random.default_rng(seed)
    sky, clus = os.path.join(dirname, "sky.txt"), os.path.join(
        dirname, "sky.txt.cluster")
    with open(sky, "w") as fs, open(clus, "w") as fc:
        fs.write("# name h m s d m s I Q U V si RM eX eY eP f0\n")
        for k in range(NCLUSTERS):
            dec = DEC0 + math.radians(rng.uniform(-2.0, 2.0))
            ra = RA0 + math.radians(rng.uniform(-2.0, 2.0)) / math.cos(DEC0)
            hrs, deg = math.degrees(ra) / 15.0, math.degrees(dec)
            h, rem = int(hrs), (hrs - int(hrs)) * 60.0
            d, drem = int(deg), (deg - int(deg)) * 60.0
            flux = rng.uniform(1.0, 10.0)
            fs.write(f"P{k} {h} {int(rem)} {(rem - int(rem)) * 60.0:.6f} "
                     f"{d} {int(drem)} {(drem - int(drem)) * 60.0:.6f} "
                     f"{flux:.6f} 0 0 0 0 0 0 0 0 150e6\n")
            fc.write(f"{k} 1 P{k}\n")
    return sky, clus


def phase_main(args, dirname: str):
    from sagecal_tpu_torch.core.types import jones_to_params, params_to_jones
    from sagecal_tpu_torch.io.simulate import (
        corrupt_and_observe, make_visdata, random_jones,
    )
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.io.solutions import (
        append_solutions, read_solutions, write_header,
    )
    from sagecal_tpu_torch.ops.rime_kernel import (
        fused_cost_bwd_cuda, fused_cost_fwd_cuda,
    )
    from sagecal_tpu_torch.solvers.sage import (
        SM_OSLM_OSRLM_RLBFGS, SageConfig, build_cluster_data, solve_tile,
    )

    sky, clus = write_sky(dirname)
    clusters, cdefs, _ = load_sky(sky, clus, RA0, DEC0)
    data = make_visdata(nstations=NSTATIONS, tilesz=TILESZ, nchan=NCHAN,
                        dec0=DEC0, seed=0)
    assert data.rows == ROWS, data.rows
    truth = random_jones(NCLUSTERS, NSTATIONS, seed=3, amp=0.2)
    data = corrupt_and_observe(data, clusters, jones=truth, noise_sigma=1e-3,
                               seed=1, fdelta=data.deltaf)
    t = sync_clock()
    cdata = build_cluster_data(data, clusters, [c.nchunk for c in cdefs])
    coh_s = sync_clock() - t
    p0 = jones_to_params(random_jones(NCLUSTERS, NSTATIONS, seed=9, amp=0.0))
    p0 = p0[:, None, :]
    cfg = SageConfig(solver_mode=SM_OSLM_OSRLM_RLBFGS, use_fused_predict=True,
                     max_emiter=args.max_emiter, max_iter=args.max_iter,
                     max_lbfgs=args.max_lbfgs)

    torch.cuda.reset_peak_memory_stats()
    fused_cost_fwd_cuda.launches = 0
    fused_cost_bwd_cuda.launches = 0
    res = solve_tile(data, cdata, p0, cfg)
    launches = {"fused_cost_fwd": fused_cost_fwd_cuda.launches,
                "fused_cost_bwd": fused_cost_bwd_cuda.launches}
    peak = torch.cuda.max_memory_allocated()

    sol = os.path.join(dirname, "tile.solutions")
    jones = params_to_jones(res.p[:, 0]).detach().cpu().numpy()
    with open(sol, "w") as fh:
        write_header(fh, data.freq0, data.deltaf, data.deltat * TILESZ / 60.0,
                     NSTATIONS, NCLUSTERS, NCLUSTERS)
        append_solutions(fh, jones)
    meta, back = read_solutions(sol)
    sol_err = float(np.abs(back[0] - jones).max() / np.abs(jones).max())

    res_u = solve_tile(data, cdata, p0, cfg.replace(use_fused_predict=False))

    r0, r1, r1u = float(res.res_0), float(res.res_1), float(res_u.res_1)
    floor = 1e-3 / math.sqrt(ROWS * NCHAN * 8)  # res of the noise alone
    print(f"[main] rows={ROWS} clusters={NCLUSTERS} stations={NSTATIONS} "
          f"channels={NCHAN} emiter={args.max_emiter} "
          f"max_iter={args.max_iter} max_lbfgs={args.max_lbfgs}", flush=True)
    print(f"[main] fused: res_0={r0:.6e} res_1={r1:.6e} "
          f"mean_nu={float(res.mean_nu):.3f} "
          f"lbfgs_iterations={res.lbfgs_iterations} "
          f"(noise alone would give {floor:.3e})", flush=True)
    print(f"[main] torch-op joint cost: res_0={float(res_u.res_0):.6e} "
          f"res_1={r1u:.6e} rel diff fused vs torch-op="
          f"{abs(r1 - r1u) / r1u:.3e}", flush=True)
    print(f"[main] solutions file: {meta['nclus_eff']} columns x "
          f"{meta['nstations']} stations, max rel diff on read-back "
          f"{sol_err:.2e}", flush=True)
    print(f"[main] launches in the fused run: {launches}", flush=True)

    if not (np.isfinite(r0) and np.isfinite(r1) and np.isfinite(r1u)):
        fail("non-finite residuals")
    if not torch.isfinite(res.p).all():
        fail("non-finite solutions")
    if not r1 < r0:
        fail(f"fused run did not reduce the residual: {r1} >= {r0}")
    if not r1u < float(res_u.res_0):
        fail("torch-op run did not reduce the residual")
    if abs(r1 - r1u) / r1u > RES1_TOL:
        fail(f"fused vs torch-op res_1 differ by more than {RES1_TOL}")
    if back.shape != (1, NCLUSTERS, NSTATIONS, 2, 2) or sol_err > 1e-5:
        fail("solutions file did not read back")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
    return {
        "launches": launches, "lbfgs_iterations": res.lbfgs_iterations,
        "coherencies_s": coh_s, "em_s": res.phase_seconds["em"],
        "lbfgs_s": res.phase_seconds["lbfgs"],
        "em_s_torch_op": res_u.phase_seconds["em"],
        "lbfgs_s_torch_op": res_u.phase_seconds["lbfgs"],
        "peak_bytes": peak, "nu": float(res.mean_nu),
    }


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_times(nu: float):
    """Kernel and plain-version times at the main path's shapes (nc = 1,
    f32 coherencies, robust cost as the default mode runs it)."""
    from sagecal_tpu_torch.kernels.parity import (
        fused_cost_work, random_cost_problem,
    )
    from sagecal_tpu_torch.ops.rime_kernel import (
        _nu_cell, fused_cost_bwd_cuda, fused_cost_fwd_cuda,
        fused_cost_packed_plain,
    )

    prob = random_cost_problem(NCLUSTERS, NSTATIONS, NCHAN, ROWS, nc=1,
                               seed=2, device="cuda")
    nu_arr = _nu_cell(nu, "cuda")
    args = (prob.tab_re, prob.tab_im, *prob.inputs, nu_arr, True)
    out = {
        "fused_cost_fwd": {"ms": cuda_ms(lambda: fused_cost_fwd_cuda(*args),
                                         50)},
        "fused_cost_bwd": {"ms": cuda_ms(lambda: fused_cost_bwd_cuda(*args),
                                         20)},
    }
    with torch.no_grad():
        out["fused_cost_fwd"]["plain_ms"] = cuda_ms(
            lambda: fused_cost_packed_plain(prob.tab_re, prob.tab_im,
                                            *prob.inputs, nu_arr), 10)
    a = prob.tab_re.clone().requires_grad_(True)
    b = prob.tab_im.clone().requires_grad_(True)
    cost = fused_cost_packed_plain(a, b, *prob.inputs, nu_arr)
    out["fused_cost_bwd"]["plain_ms"] = cuda_ms(
        lambda: torch.autograd.grad(cost, (a, b), retain_graph=True), 10)
    for name, (nbytes, flops) in (("fused_cost_fwd",
                                   fused_cost_work(prob)["fwd"]),
                                  ("fused_cost_bwd",
                                   fused_cost_work(prob)["bwd"])):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        out[name].update(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes=nbytes, flops=flops)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-emiter", type=int, default=2)
    ap.add_argument("--max-iter", type=int, default=6)
    ap.add_argument("--max-lbfgs", type=int, default=10)
    ap.add_argument("--json-out", default=None,
                    help="also write every number printed to this file")
    args = ap.parse_args()
    t_start = time.perf_counter()

    name, count, card = phase_device()
    phase_build()
    worst = phase_parity()
    with tempfile.TemporaryDirectory() as d:
        main_out = phase_main(args, d)
    times = phase_times(main_out["nu"])

    print(f"[times] ({card}) coherencies {main_out['coherencies_s']:.3f} s, "
          f"EM {main_out['em_s']:.3f} s, joint LBFGS (fused) "
          f"{main_out['lbfgs_s']:.3f} s over {main_out['lbfgs_iterations']} "
          f"iterations, joint LBFGS (torch-op) "
          f"{main_out['lbfgs_s_torch_op']:.3f} s", flush=True)
    print(f"[times] ({card}) peak device memory of the fused solve "
          f"{main_out['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    for k, v in times.items():
        print(f"[times] ({card}) {k}: {v['ms']:.4f} ms, bound "
              f"{v['bound_ms']:.4f} ms ({v['bound_by']}: {v['bytes']} B, "
              f"{v['flops']} flop), plain {v['plain_ms']:.4f} ms, "
              f"{main_out['launches'][k] / max(main_out['lbfgs_iterations'], 1):.2f}"
              f" launches per LBFGS iteration", flush=True)

    kernels = []
    for k in ("fused_cost_fwd", "fused_cost_bwd"):
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[k], "launches": main_out["launches"][k],
            "max_abs_err": worst[k], "ms": times[k]["ms"],
            "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
            "bound_by": times[k]["bound_by"], "library_ms": None,
            "parity": "pass",
        })
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({"card": card, "main": main_out, "times": times,
                       "kernels": kernels,
                       "seconds": time.perf_counter() - t_start}, fh, indent=1)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
