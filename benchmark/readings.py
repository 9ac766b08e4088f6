"""The readings that set a cell's limits: the program on many seeds and
each named control (:mod:`benchmark.harness.control`) on a few, each
one app run (``--seconds 0``, no warm-up) at the cell's own sizes, in
one process, one JSON line a seed:

    python3 -m benchmark.readings --workload <name> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--controls coherencies,joint_cost] \\
        [--out readings.jsonl]

The benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.harness import control
from benchmark.run import _cache_dirs, run_cell
from benchmark.harness.cell import BENCH_DIR


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default=",".join(control.CONTROLS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _cache_dirs(BENCH_DIR)
    plan = [(int(s), "program") for s in args.seeds.split(",") if s]
    plan += [(int(s), name) for name in args.controls.split(",") if name
             for s in args.control_seeds.split(",") if s]
    for seed, variant in plan:
        res = run_cell(args.workload, seed, 0.0, False, "cuda",
                       patches=[] if variant == "program"
                       else [control.CONTROLS[variant]], warmup=False)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "variant": variant, "correct": res["correct"],
                           "failed": res["failed"], "check": res["check"],
                           "metrics": res["metrics"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
