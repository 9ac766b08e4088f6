"""What collecting solver telemetry and quality costs a solve on the card.

Run from the root of the repository, on a machine with one CUDA card::

    python3 -m sagecal_tpu_torch.tools.telemetry_cost [--pairs 5] [--mode 5] [--json-out FILE]

It builds ``chip_smoke.py``'s warm-phase tile (the north-star geometry,
8 point clusters) and solves it with ``solve_tile`` at the main path's
depth (fused joint cost) with ``collect_telemetry`` and
``collect_quality`` off and on, in ``--pairs`` alternating pairs (off
first in even pairs, on first in odd ones).  Each solve prints its EM
and LBFGS seconds and the RTR solver's host reads; the two solves of a
pair must give the same ``p`` and ``res_1`` bits and the same host
reads.  Then one solve of each side runs under a CPU-only
``torch.profiler``, which counts the host's kernel launches
(``cudaLaunchKernel``) and synchronizations.  The summary: each side's
median EM seconds and quartile distance, and how many pairs had the
slower solve on.
"""

import argparse
import json
import statistics
import sys
import tempfile

import torch


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], q[2]


def _host_events(solve):
    """Kernel launches and synchronizations the host makes in one call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve()
    n = {"launches": 0, "syncs": 0}
    for e in prof.key_averages():
        if e.key == "cudaLaunchKernel":
            n["launches"] += e.count
        elif "Synchronize" in e.key:
            n["syncs"] += e.count
    return n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--mode", type=int, default=5)
    ap.add_argument("--json-out", default=None,
                    help="also write every number printed to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device (torch.cuda.is_available() is False)")
    import chip_smoke as cs
    from sagecal_tpu_torch.kernels import build
    from sagecal_tpu_torch.solvers import rtr
    from sagecal_tpu_torch.solvers.sage import solve_tile

    _, _, card = cs.phase_device()
    build.build_all()
    with tempfile.TemporaryDirectory() as d:
        data, cdata, p0, _ = cs.main_tile(d, cs.WARM_CLUSTERS)
    base = cs.main_config(cs.parse_args([])).replace(solver_mode=args.mode)
    cfgs = {on: base.replace(collect_telemetry=on, collect_quality=on)
            for on in (False, True)}

    def solve(on):
        rtr.host_read.count = 0
        res = solve_tile(data, cdata, p0, cfgs[on])
        return res, {"em_s": res.phase_seconds["em"],
                     "lbfgs_s": res.phase_seconds["lbfgs"],
                     "host_reads": rtr.host_read.count}

    solve(False)  # warm-up: the kernels' first launches, the plans' caches
    runs = {False: [], True: []}
    slower_on = 0
    for k in range(args.pairs):
        order = (False, True) if k % 2 == 0 else (True, False)
        pair = {}
        for on in order:
            pair[on] = solve(on)
            runs[on].append(pair[on][1])
            print(f"[telemetry-cost] ({card}) pair {k} telemetry "
                  f"{'on ' if on else 'off'}: {pair[on][1]}", flush=True)
        (a, ra), (b, rb) = pair[False], pair[True]
        if not (torch.equal(a.p, b.p) and torch.equal(a.res_1, b.res_1)
                and ra["host_reads"] == rb["host_reads"]):
            sys.exit(f"pair {k}: telemetry on changed the solve or its "
                     "host reads")
        slower_on += rb["em_s"] > ra["em_s"]
    events = {on: _host_events(lambda: solve(on)) for on in (False, True)}
    out = {"card": card, "mode": args.mode, "clusters": cs.WARM_CLUSTERS,
           "runs": {"off": runs[False], "on": runs[True]},
           "host_events": {"off": events[False], "on": events[True]}}
    for on in (False, True):
        em = [r["em_s"] for r in runs[on]]
        q1, q3 = _quartiles(em) if len(em) > 1 else (em[0], em[0])
        out["on" if on else "off"] = {"em_median_s": statistics.median(em),
                                      "em_iqr_s": q3 - q1}
    print(f"[telemetry-cost] ({card}) mode {args.mode}, "
          f"{cs.WARM_CLUSTERS} clusters, {args.pairs} pairs: EM median off "
          f"{out['off']['em_median_s']:.3f} s (IQR "
          f"{out['off']['em_iqr_s']:.3f}), on {out['on']['em_median_s']:.3f}"
          f" s (IQR {out['on']['em_iqr_s']:.3f}); on slower in {slower_on} "
          f"of {args.pairs} pairs; host launches and syncs of one solve: "
          f"off {events[False]}, on {events[True]}", flush=True)
    out["slower_on"] = slower_on
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
