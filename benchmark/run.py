"""Run one cell of the benchmark once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted`` and ``failed`` (tiles),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``check``: each number the check compared with its limit, which
are also the last lines of standard error.  Exits non-zero with no
result when the card or the program is missing, when a JAX module was
loaded, or when a traced run loses sight of a layer or of the kernels
that a per-layer metric listing the cell reads.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark.harness.cell import (  # noqa: E402
    BENCH_DIR, LayerContext, applies, base_name, benchmark_spec, load_cell,
    read_metric,
)


def _cache_dirs(bench_dir: str) -> None:
    """Fixed cache directories inside the checkout, and nothing of the
    program's own switches from the caller's environment."""
    root = os.path.join(os.path.dirname(bench_dir), ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "torch_extensions")
    for key in [k for k in os.environ if k.startswith("SAGECAL_")]:
        del os.environ[key]


def result_line(spec: dict, cell, out) -> dict:
    """The result object (module doc) of a finished cell."""
    from benchmark.harness.check import is_correct

    name = cell.name
    if cell.trace:
        ctx = LayerContext(reduction=out.reduction, spans=out.spans,
                           tiles=out.tiles_profiled, shapes=out.shapes)
        metrics = {}
        for m in spec["per_layer"]:
            if applies(m, name):
                v = read_metric(cell.bench_dir, m["name"], ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
                elif "workloads" in m:
                    raise RuntimeError(
                        f"{m['name']} read nothing in {name}, which it "
                        f"lists: its layer or kernels went out of sight")
    else:
        metrics = {}
        for m in spec["end_to_end"]:
            key = m["name"] if m["name"] in out.e2e else base_name(m["name"])
            if applies(m, name) and key in out.e2e:
                metrics[m["name"]] = {"value": float(out.e2e[key]),
                                      "unit": m["unit"]}
    res = {"correct": is_correct(out.checks), "attempted": out.attempted,
           "failed": out.failed, "metrics": metrics, "device": out.device}
    if cell.trace and out.reduction is not None:
        from benchmark.harness.devtrace import breakdown

        res["device"].update(busy_s=out.reduction.busy_s,
                             window_s=out.reduction.window_s)
        res["breakdown"] = breakdown(out.reduction)
    res["check"] = {k: {"value": v, "limit": lim} for k, v, lim in out.checks}
    return res


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str, bench_dir: str = BENCH_DIR, patches=(),
             t_start: float = T_START, warmup: bool = True) -> dict:
    """One run of cell ``name`` on ``device``; the result object."""
    spec = benchmark_spec(bench_dir)
    cell = load_cell(name, seed, seconds, trace, device, t_start,
                     bench_dir=bench_dir, spec=spec)
    cell.program_patches = list(patches)
    cell.warmup = warmup
    out = cell.driver().run(cell)
    if device == "cuda":
        import torch

        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    out.device.update(platform="gpu" if device == "cuda" else device,
                      kind=kind, count=int(cell.workload["chips"]))
    return result_line(spec, cell, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs(BENCH_DIR)
    spec = benchmark_spec()
    wl = next((w for w in spec["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda")
    from benchmark.harness.check import banned_modules

    bad = banned_modules()
    if bad:
        print(f"refused: JAX modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, v in res["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
