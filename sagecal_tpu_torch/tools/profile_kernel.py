"""On-card timing of the fused predict, kernels #1 and #2 (the port of the
root ``profile_kernel.py``), and ``kdiag.py``'s shape ladder for kernel #1.

Run from the root of the repository, on a machine with one CUDA card::

    python3 -m sagecal_tpu_torch.tools.profile_kernel [--json-out FILE]

At the north-star tile (62 stations, 100 point clusters, 60 timeslots x
2 channels = 113,460 rows, built from an LSM sky file by
``chip_smoke.main_tile``, f32 coherencies, nc = 1) it times with CUDA
events, from the tile's starting gains:

- the fused predict forward (kernel #1, gain tables packed per call)
  beside the torch-op ``predict_full_model``;
- the composed robust cost ``sum log1p(|vis - model|^2 mask / nu)``
  (nu = 5) on kernel #1;
- that cost with its gradient (kernels #1 and #2, #2 on the tile's
  station plan, built once);
- a 20-iteration ``lbfgs_fit`` on the composed cost, which must lower it,
  and the launches of #1 and #2 it made (the path's use of the kernels,
  without the timing repeats above);
- the HBM bandwidth the forward implies (coherency bytes over its time).

Then kernel #1 alone at ``kdiag.py``'s three rungs (Mp 8/40/104, F 2,
4,096/32,768/113,664 rows, 62 stations, random inputs), on the device
alone and host-paced, beside each rung's bytes bound.  Every line carries the card's name and power limit.
"""

import argparse
import json
import sys
import tempfile
import time

import torch

from sagecal_tpu_torch.kernels.parity import HBM_BYTES_PER_S

NU = 5.0
LBFGS_ITERS = 20  # the JAX script's bench.LBFGS_ITERS
KDIAG_RUNGS = ((8, 2, 4096), (40, 2, 32768), (104, 2, 113664))  # Mp, F, rows
KDIAG_STATIONS, KDIAG_NPAD = 62, 128


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, from
    CUDA events around the whole run."""
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


def device_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` with the host's per-call work
    hidden: a sleep kernel holds the stream while the host enqueues all
    ``reps`` calls, so the events time the device running them back to
    back.  For calls whose host work (checks, allocation, the launch
    itself) outlasts their kernels, which ``cuda_ms`` times by the host's
    enqueue rate.  Raises if the host cannot enqueue them inside the
    longest sleep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    # twice the host's time for the calls, at up to 2 GHz
    cycles = int(4e9 * (time.perf_counter() - t0)) + 1_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        covered = not start.query()  # the sleep still holds the stream
        end.record()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("the host did not enqueue the calls inside the sleep")


def profile(data, cdata, p0, card: str) -> dict:
    """Time the fused predict path at this tile (module doc); prints one
    line per number and returns them.  ``p0``: (M, 1, 8N) on the tile's
    device."""
    from sagecal_tpu_torch.core.types import params_to_jones
    from sagecal_tpu_torch.ops.rime_kernel import (
        BwdPlan, fused_predict_bwd_cuda, fused_predict_fwd_cuda,
        fused_predict_packed, pack_gain_tables, pack_predict_inputs,
    )
    from sagecal_tpu_torch.solvers.lbfgs import lbfgs_fit
    from sagecal_tpu_torch.solvers.sage import predict_full_model

    M, nchunk, n8 = p0.shape
    if nchunk != 1:
        raise ValueError("profile_kernel times the nc = 1 predict")
    vis_ri, mask_p, coh_ri, antp, antq, _ = pack_predict_inputs(
        data.vis, data.mask, cdata.coh, data.ant_p, data.ant_q)
    p = p0.float().reshape(-1).contiguous()
    # #2's station plan, built once for the tile as a solve builds #4's
    plan = BwdPlan(antp, antq, None, 1, n8 // 8)

    def model_of(pflat):
        jones = params_to_jones(pflat.reshape(M, n8))
        tre, tim = pack_gain_tables(jones, M)
        return fused_predict_packed(tre, tim, coh_ri, antp, antq, plan=plan)

    def cost_fn(pflat):
        d = (vis_ri - model_of(pflat)) * mask_p[:, None, :]
        e2 = d[:, :4] ** 2 + d[:, 4:] ** 2
        return torch.log1p(e2 / NU).sum()

    def cost_and_grad():
        x = p.clone().requires_grad_(True)
        return torch.autograd.grad(cost_fn(x), x)[0]

    out = {"rows": int(coh_ri.shape[3]), "clusters": M}
    with torch.no_grad():
        out["predict_ms"] = cuda_ms(lambda: model_of(p), 20)
        out["torch_op_predict_ms"] = cuda_ms(
            lambda: predict_full_model(p0, cdata, data), 5)
        out["cost_ms"] = cuda_ms(lambda: cost_fn(p), 20)
        cost0 = float(cost_fn(p))
    out["cost_grad_ms"] = cuda_ms(cost_and_grad, 10)
    counters = {"fused_predict_fwd": fused_predict_fwd_cuda,
                "fused_predict_bwd": fused_predict_bwd_cuda}
    before = {k: c.launches for k, c in counters.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = lbfgs_fit(cost_fn, None, p, itmax=LBFGS_ITERS, M=7)
    torch.cuda.synchronize()
    out["lbfgs_s"] = time.perf_counter() - t0
    # the LBFGS's own launches: the path's use, without timing repeats
    out["lbfgs_launches"] = {k: c.launches - before[k]
                             for k, c in counters.items()}
    out["lbfgs_iterations"] = fit.iterations
    out["lbfgs_cost0"], out["lbfgs_cost1"] = cost0, float(fit.cost)
    coh_bytes = coh_ri.numel() * coh_ri.element_size()
    out["predict_gb_s"] = coh_bytes / (out["predict_ms"] * 1e-3) / 1e9

    print(f"[predict] ({card}) north-star tile, {out['rows']} rows x {M} "
          f"clusters, f32 coherencies:", flush=True)
    print(f"[predict] ({card}) fused predict fwd (#1) "
          f"{out['predict_ms']:.4f} ms; torch-op predict_full_model "
          f"{out['torch_op_predict_ms']:.4f} ms", flush=True)
    print(f"[predict] ({card}) fused cost eval {out['cost_ms']:.4f} ms; "
          f"cost + grad (#1 + #2) {out['cost_grad_ms']:.4f} ms", flush=True)
    print(f"[predict] ({card}) {LBFGS_ITERS}-iteration LBFGS on the composed "
          f"cost: {out['lbfgs_s']:.3f} s, {fit.iterations} iterations, "
          f"{out['lbfgs_s'] / max(fit.iterations, 1) * 1e3:.2f} ms per "
          f"iteration; cost {cost0:.6e} -> {out['lbfgs_cost1']:.6e}; "
          f"launches {out['lbfgs_launches']}", flush=True)
    print(f"[predict] ({card}) implied bandwidth of the forward: "
          f"{out['predict_gb_s']:.0f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f} "
          f"GB/s (data sheet)", flush=True)
    out["kdiag"] = kdiag_ladder(card)
    return out


def kdiag_ladder(card: str) -> list:
    """Kernel #1 at ``kdiag.py``'s rungs: random inputs, 62 stations in
    tables padded to 128, nc = 1.  Timed on the device alone
    (``device_ms``: at the small rungs the host's per-call work outlasts
    the kernel) and host-paced (``cuda_ms``) beside it.  Returns one dict
    per rung."""
    from sagecal_tpu_torch.kernels.parity import (
        CostProblem, fused_predict_work, roofline,
    )
    from sagecal_tpu_torch.ops.rime_kernel import fused_predict_fwd_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    rungs = []
    for mp, F, rows in KDIAG_RUNGS:
        randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        stations = lambda: torch.randint(0, KDIAG_STATIONS, (1, rows),
                                         generator=gen, device="cuda",
                                         dtype=torch.int32)
        prob = CostProblem(
            tab_re=randn(4, mp, KDIAG_NPAD), tab_im=randn(4, mp, KDIAG_NPAD),
            coh_ri=randn(mp, F, 8, rows), ant_p=stations(), ant_q=stations(),
            vis_ri=None, mask_p=None, cmap=None, nc=1)
        launch = lambda: fused_predict_fwd_cuda(
            prob.tab_re, prob.tab_im, prob.coh_ri, prob.ant_p, prob.ant_q)
        ms = device_ms(launch, 20)
        work = fused_predict_work(prob)["fwd"]
        rung = {"mp": mp, "F": F, "rows": rows, "ms": ms,
                "host_paced_ms": cuda_ms(launch, 20),
                "gb_s": work[0] / (ms * 1e-3) / 1e9, **roofline(*work)}
        rungs.append(rung)
        print(f"[kdiag] ({card}) Mp={mp} F={F} rows={rows}: "
              f"{ms:.4f} ms on the device ({rung['host_paced_ms']:.4f} ms "
              f"host-paced), bound {rung['bound_ms']:.4f} ms "
              f"({rung['bound_by']}), "
              f"{rung['gb_s']:.0f} GB/s", flush=True)
        del prob
    return rungs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json-out", default=None,
                    help="also write every number printed to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device (torch.cuda.is_available() is False)")
    import chip_smoke as cs
    from sagecal_tpu_torch.kernels import build

    _, _, card = cs.phase_device()
    build.build_all()
    with tempfile.TemporaryDirectory() as d:
        data, cdata, p0, _ = cs.main_tile(d)
    out = profile(data, cdata, p0.to(data.device), card)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({"card": card, **out}, fh, indent=1)


if __name__ == "__main__":
    main()
