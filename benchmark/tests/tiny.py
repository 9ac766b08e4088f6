"""A copy of the benchmark in a temporary directory with one tiny
configuration added as new files (8 stations, 3 clusters of 3 sources,
two tiles of 4 timeslots), for CPU tests that run whole cells."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY = {"nstations": 8, "nclusters": 3, "sources_per_cluster": 3,
        "tilesz": 4,
        "layout": [{"count": 6, "kind": "disk", "radius_m": 1000.0},
                   {"count": 2, "kind": "log_ring", "rmin_m": 3000.0,
                    "rmax_m": 20000.0}]}
# the deployments' limits (benchmark/limits/), but the joint fit's: at
# this size float32 reads fit_cost_gap ~2e-6 and fit_grad_gap ~1e-4
# (the joint-cost control 1e-4 and 8e-3), and ten LBFGS steps leave
# fit_drop ~0.83
LIMITS = {"calibrate": {"resid_gap": 0.05, "cost_gap": 1e-3,
                        "tile_res_ratio": 1.0, "fit_cost_gap": 2e-5,
                        "fit_grad_gap": 2e-3, "fit_drop": 0.95},
          "subtract": {"resid_gap": 0.05}}


def tiny_copy(dest: str, name: str = "tiny", base: str = "lofar_hba_62st",
              extra_metric: str = None) -> str:
    """Copy the benchmark to ``dest`` and add configuration ``name`` (the
    ``base`` configuration cut to :data:`TINY`) with a calibrate and a
    subtract cell, each a new file and a new entry; ``extra_metric``: the
    name of a new per-layer metric whose reader is a new file.  Nothing
    already there is edited but ``BENCHMARK.json``'s lists.  Returns the
    copy's benchmark directory."""
    bench = os.path.join(dest, "benchmark")
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(BENCH, "configs", f"{base}.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, name=name)
    with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    spec["configs"].append({"name": name, "source": "https://example.org",
                            "file": f"benchmark/configs/{name}.json",
                            "reduced": [], "why": "a CPU test"})
    for traffic, lim in LIMITS.items():
        wl = f"{name}.{traffic}"
        spec["workloads"].append({"name": wl, "config": name,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a CPU test"})
        with open(os.path.join(bench, "limits", f"{wl}.json"), "w") as f:
            json.dump({"limits": lim}, f)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and traffic == "calibrate" and \
                    f"{base}.calibrate" in m["workloads"]:
                m["workloads"].append(wl)
    if extra_metric:
        with open(os.path.join(bench, "metrics", f"{extra_metric}.py"),
                  "w") as f:
            f.write("def read(ctx):\n"
                    "    spans = ctx.spans.get('coherencies')\n"
                    "    return None if not spans else max(spans)\n")
        spec["per_layer"].append({
            "name": extra_metric, "unit": "s", "better": "lower",
            "source": "program_span", "layer": "coherencies",
            "moves": "peak_mem_gib"})
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return bench
