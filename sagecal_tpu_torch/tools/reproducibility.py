"""How far two runs of one solve drift apart on a CUDA card, and whether
the fused and torch-op joint costs still agree within ``chip_smoke.py``'s
bar (``RES1_TOL``).

Run from the root of the repository, on a machine with one CUDA card::

    python3 -m sagecal_tpu_torch.tools.reproducibility [--json-out FILE]

Everything runs in torch's default mode, the mode users run.  The EM
assembles its normal equations with fixed-order segment sums
(``solvers/lm.py``), the gain gathers have a fixed-order backward
(``core/segment.py``) and the fused kernels use no float atomics, so two
runs of one route should give the same bits: every same-route pair
should read 0.  The script measures the spread of ``res_1`` (and whether
``p`` is bit-identical) at the two shapes of ``chip_smoke.py``, whose
builders it reuses:

- main: phase 4's north-star tile, ``solve_tile`` twice with the fused
  joint cost and twice with the torch-op one; every fused vs torch-op
  pair is held to ``RES1_TOL`` as phase 4 holds its pair;
- serve: phase 10's bucket of 8 requests, the ``fused_batch`` route
  twice, the per-lane torch-op route twice and the per-lane fused route
  once.

Each line prints the worst per-lane ``|a - b| / |b|`` of ``res_1``.
"""

import argparse
import itertools
import json
import sys
import tempfile

import torch


def _pairs(runs: dict, rel_max) -> dict:
    """Worst res_1 difference of every pair of runs and whether their
    ``p`` are bit-identical, keyed "a vs b"."""
    return {f"{a} vs {b}": {"res_1": rel_max(runs[a].res_1, runs[b].res_1),
                            "p_bitwise": bool(torch.equal(runs[a].p,
                                                          runs[b].p))}
            for a, b in itertools.combinations(runs, 2)}


def _report(tag: str, card: str, pairs: dict):
    for k, v in pairs.items():
        print(f"[{tag}] ({card}) {k}: res_1 {v['res_1']:.3e}, p bit-identical "
              f"{v['p_bitwise']}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json-out", default=None,
                    help="also write every number printed to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device (torch.cuda.is_available() is False)")
    import chip_smoke as cs
    from sagecal_tpu_torch.kernels import build
    from sagecal_tpu_torch.solvers.sage import solve_tile

    _, _, card = cs.phase_device()
    build.build_all()
    out = {"card": card, "res1_tol": cs.RES1_TOL}

    with tempfile.TemporaryDirectory() as d:
        data, cdata, p0, _ = cs.main_tile(d)
    cfg = cs.main_config(cs.parse_args([]))
    unfused = cfg.replace(use_fused_predict=False)
    runs = {}
    for name, c in (("fused1", cfg), ("fused2", cfg), ("torch_op1", unfused),
                    ("torch_op2", unfused)):
        runs[name] = solve_tile(data, cdata, p0, c)
        print(f"[main] {name}: EM {runs[name].phase_seconds['em']:.3f} s, "
              f"res_1 {float(runs[name].res_1):.9e}", flush=True)
    out["main"] = _pairs(runs, cs.rel_max)
    del data, cdata, runs
    torch.cuda.empty_cache()
    _report("main", card, out["main"])
    cross = [v["res_1"] for k, v in out["main"].items()
             if k.startswith("fused") and "torch_op" in k]
    print(f"[main] worst fused vs torch-op {max(cross):.3e}, bar "
          f"{cs.RES1_TOL}", flush=True)

    with tempfile.TemporaryDirectory() as d:
        reqs = cs.serve_requests(d)
    cfg = cs.serve_config()
    unfused = cfg.replace(use_fused_predict=False)
    lanes = list(range(cs.SERVE_B))
    runs = {}
    for name, c, fused in (("batch1", cfg, True), ("batch2", cfg, True),
                           ("torch_op1", unfused, False),
                           ("torch_op2", unfused, False),
                           ("solo_fused", cfg, False)):
        runs[name], wall = cs.serve_solve(reqs, lanes, c, fused=fused)
        print(f"[serve] {name}: {wall:.3f} s, res_1 "
              f"{[f'{x:.6e}' for x in runs[name].res_1.tolist()]}",
              flush=True)
    out["serve"] = _pairs(runs, cs.rel_max)
    _report("serve", card, out["serve"])
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
