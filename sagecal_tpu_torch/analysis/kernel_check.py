"""Kernel budget checker: proofs of the Hopper kernels' shared-memory,
register and thread budgets (counterpart of
``sagecal_tpu/analysis/kernel_check.py``).

:func:`run_kernel_check` runs the model's contracts
(:mod:`sagecal_tpu_torch.analysis.kernelmodel`) and, with
``crosscheck``, holds the model against the card, producing violations
of stable kinds:

======================  =================================================
kind                    meaning
======================  =================================================
``model-extraction``    the model could not read a constant or kernel
                        from ``csrc/*.cu`` (teach it the new idiom)
``threads``             a ``__launch_bounds__`` beyond 1,024 threads
``static-smem``         a kernel's static ``__shared__`` beyond 48 KiB
``smem-optin``          a launch's dynamic shared memory beyond the
                        opt-in maximum (``kSmemMax``, 232,448 B)
``smem-occupancy``      the blocks a design keeps on an SM do not fit
                        its 233,472 B (1 KiB reserved a block)
``grid``                a grid's y extent beyond 65,535
``threshold``           the staged / key-split threshold the source
                        gives disagrees with the records (2,695 at f32)
``ptxas``               (crosscheck) a kernel's registers beyond its
                        launch bounds' limit, a spill, or static shared
                        memory other than the model's
``trace``               (crosscheck) a traced launch's shared memory or
                        registers other than the model's
``lint``                a gate finding of the lint's kernel rules: JL013
                        (an ``autograd.Function`` backward that drops a
                        gradient) or JL014 (a float atomic or narrow
                        arithmetic in ``csrc/``, TF32, an atomic
                        accumulation on the solve path)
======================  =================================================

The reference's ``_check_table`` (the banked ``KERNEL_VMEM_TABLE.json``)
has no counterpart: the port has no VMEM table (``choose_batched_path``
dropped that bound).

``--crosscheck`` needs the card: it builds each source fresh into a
temporary directory with ``-Xptxas -v`` and reads ptxas's report per
``__global__``, then runs each kernel row at small shapes under one
``torch.profiler`` capture of the card's activity (a second of small
launches first, each configuration opened by a ``torch.cuda._sleep``
kernel; taken once more when a configuration's records are missing),
and compares every traced launch's ``shared memory`` (static plus
dynamic, as Kineto reports it) and ``registers per thread`` (at least
16, the card's allocation floor) with the model.  Exit codes: 0 all contracts hold, 1 a
violation, 2 an internal or usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
from typing import Any, Dict, List, Optional

from sagecal_tpu_torch.analysis import kernelmodel as km

# registers the H100 allocates a thread at the least: a kernel ptxas
# builds with 12 runs with 16 (the trace's "registers per thread")
MIN_REGISTERS = 16

# the records' staged / key-split threshold of #4's gradient kernel at
# f32 (ROADMAP.md's records)
RECORDED_F32_THRESHOLD = 2695

# the shapes the contracts prove: the north-star tile (nc 1 and 2, f32
# and bf16), a tile past the staged threshold (key split), the serve
# bucket, and the probes
_NS = km.NORTH_STAR
CONTRACT_CONFIGS = tuple(
    dict(row=row, mp=_NS["mp"], nc=nc, npad=_NS["npad"], F=_NS["F"],
         rowsp=_NS["rowsp"], coh=coh)
    for row in (1, 2, 3, 4) for nc in (1, 2) for coh in ("f32", "bf16")
) + tuple(
    dict(row=row, mp=2, nc=50, npad=_NS["npad"], F=_NS["F"],
         rowsp=_NS["rowsp"], coh="f32") for row in (2, 4)
) + tuple(
    dict(row=row, mp=_NS["serve_mp"], nc=1, npad=_NS["npad"], F=_NS["F"],
         rowsp=_NS["rowsp"], B=_NS["B"], coh=coh)
    for row in (5, 6) for coh in ("f32", "bf16")
) + (dict(row=7), dict(row=8), dict(row=9), dict(row=9, npad=128,
                                                  one_launch=True),
     dict(row=10), dict(row=10, npad=128, one_launch=True))


def _violation(kind: str, message: str, **detail: Any) -> Dict[str, Any]:
    v: Dict[str, Any] = {"kind": kind, "message": message}
    if detail:
        v["detail"] = detail
    return v


def _check_model_contracts(model: km.KernelModel) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    fc = model.fc
    for s in model.sources.values():
        for k in s.kernels.values():
            if k.threads > km.THREADS_PER_BLOCK_MAX:
                out.append(_violation(
                    "threads", f"{k.name}: {k.threads} threads a block",
                    kernel=k.name))
            if k.static_smem > km.STATIC_SMEM_MAX:
                out.append(_violation(
                    "static-smem", f"{k.name}: {k.static_smem} B static "
                    f"shared memory > {km.STATIC_SMEM_MAX}", kernel=k.name))
    if fc["kSmemMax"] > km.SMEM_OPTIN_MAX:
        out.append(_violation(
            "smem-optin", f"kSmemMax {fc['kSmemMax']} > the H100's opt-in "
            f"maximum {km.SMEM_OPTIN_MAX}"))
    # the designs' two blocks an SM: the gradient kernel at its target,
    # the cotangent ring at f32
    grad_min = model.kernel("fused_cost_grad_kernel").min_blocks
    for what, smem, blocks in (
            ("kGradSmemTarget", fc["kGradSmemTarget"], grad_min),
            ("the cotangent ring (f32)", model.cot_ring_bytes(4), 2)):
        if blocks * (smem + km.SMEM_RESERVED) > km.SMEM_PER_SM:
            out.append(_violation(
                "smem-occupancy", f"{what}: {blocks} blocks x ({smem} + "
                f"{km.SMEM_RESERVED}) B > {km.SMEM_PER_SM} B an SM"))
    got = model.staged_threshold(4)
    if got != RECORDED_F32_THRESHOLD:
        out.append(_violation(
            "threshold", f"staged threshold at f32 is nc npad <= {got}, the "
            f"records say {RECORDED_F32_THRESHOLD}", model=got))
    for cfg in CONTRACT_CONFIGS:
        try:
            launches = model.launches(**cfg)
        except km.ModelExtractionError as exc:
            out.append(_violation("model-extraction", f"{cfg}: {exc}"))
            continue
        for ln in launches:
            dyn, total = ln["dynamic_smem"], ln["dynamic_smem"] \
                + ln["static_smem"]
            if dyn > fc["kSmemMax"] or dyn > km.SMEM_OPTIN_MAX:
                out.append(_violation(
                    "smem-optin", f"#{cfg['row']} {ln['kernel']} at {cfg}: "
                    f"{dyn} B dynamic shared memory", config=cfg))
            if model.resident_blocks(ln["kernel"], total) < 1:
                out.append(_violation(
                    "smem-occupancy", f"#{cfg['row']} {ln['kernel']} at "
                    f"{cfg}: {total} B do not fit an SM", config=cfg))
            grid = ln["grid"]
            if grid is not None and grid[1] > km.GRID_Y_MAX:
                out.append(_violation(
                    "grid", f"#{cfg['row']} {ln['kernel']} at {cfg}: grid "
                    f"y {grid[1]} > {km.GRID_Y_MAX}", config=cfg))
    return out


# ------------------------------------------------------------ crosscheck

_PTXAS_ENTRY = re.compile(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(log: str) -> Dict[str, dict]:
    """Per mangled ``__global__``: {registers, spill_stores, spill_loads,
    smem} from an ``nvcc -Xptxas -v`` log."""
    out: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": None,
                                             "spill_stores": 0,
                                             "spill_loads": 0, "smem": 0})
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = _PTXAS_USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _PTXAS_SMEM.search(line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


def kernel_of_mangled(mangled: str, names) -> Optional[str]:
    """The kernel function a mangled entry name instantiates."""
    for n in sorted(names, key=len, reverse=True):
        if f"{len(n)}{n}" in mangled:
            return n
    return None


def check_ptxas(model: km.KernelModel, logs: Dict[str, str]
                ) -> List[Dict[str, Any]]:
    """ptxas's report of each source against the model: registers within
    the launch bounds' limit, no spill, static shared memory equal to the
    model's."""
    out: List[Dict[str, Any]] = []
    for src, log in logs.items():
        kernels = model.sources[src].kernels
        entries = parse_ptxas(log)
        seen = set()
        for mangled, e in entries.items():
            name = kernel_of_mangled(mangled, kernels)
            if name is None:
                continue
            seen.add(name)
            k = kernels[name]
            if e["registers"] is None or e["registers"] > k.reg_limit:
                out.append(_violation(
                    "ptxas", f"{name}: {e['registers']} registers, limit "
                    f"{k.reg_limit} under __launch_bounds__({k.threads}, "
                    f"{k.min_blocks})", kernel=name))
            if e["spill_stores"] or e["spill_loads"]:
                out.append(_violation(
                    "ptxas", f"{name}: spills {e['spill_stores']} B stores, "
                    f"{e['spill_loads']} B loads", kernel=name))
            if e["smem"] != k.static_smem:
                out.append(_violation(
                    "ptxas", f"{name}: {e['smem']} B static shared memory, "
                    f"model {k.static_smem}", kernel=name))
        for name in set(kernels) - seen:
            out.append(_violation("ptxas", f"{name}: not in ptxas's report "
                                           f"of {src}", kernel=name))
    return out


def expected_launch(model: km.KernelModel, cfg: dict, name: str,
                    batched: bool, one_launch: bool = False) -> Optional[dict]:
    """The model's launch of kernel ``name`` in row ``cfg['row']`` at the
    configuration's shape."""
    kw = {k: v for k, v in cfg.items()
          if k not in ("make", "probe", "stages")}
    kw["one_launch"] = one_launch
    for ln in model.launches(**kw):
        if ln["kernel"] == name and (ln["batched"] == batched
                                     or name == "sum_partials_kernel"):
            return ln
    return None


def check_trace(model: km.KernelModel, cfg: dict, attribution: dict,
                ptxas: Dict[str, dict]) -> List[Dict[str, Any]]:
    """Every traced launch of the port's kernels in one configuration's
    capture: ``shared memory`` equal to the model's static plus dynamic
    bytes, ``registers per thread`` within the launch bounds' limit and
    one of ptxas's counts for that kernel."""
    out: List[Dict[str, Any]] = []
    regs: Dict[str, set] = {}
    names = [k for s in model.sources.values() for k in s.kernels]
    for mangled, e in ptxas.items():
        name = kernel_of_mangled(mangled, names)
        if name is not None:
            regs.setdefault(name, set()).add(e["registers"])
    if not attribution["launches"]:
        out.append(_violation("trace", f"#{cfg['row']}: no kernel of the "
                                       f"port in the capture", config=cfg))
    for ln in attribution["launches"]:
        one = bool(re.search(r"gather_kernel<true>", ln.get("full", "")))
        want = expected_launch(model, cfg, ln["name"], ln["batched"],
                               one or ln.get("one_launch", False))
        if want is None:
            out.append(_violation("trace", f"#{cfg['row']}: unexpected "
                                           f"{ln['name']}", config=cfg))
            continue
        smem = want["static_smem"] + want["dynamic_smem"]
        if ln["shared_memory"] != smem:
            out.append(_violation(
                "trace", f"#{cfg['row']} {ln['name']}: trace shared memory "
                f"{ln['shared_memory']} B, model {smem} B", config=cfg))
        k = model.kernel(ln["name"])
        r = ln["registers"]
        # the card allocates a thread at least MIN_REGISTERS (ptxas's 12
        # run as 16)
        allowed = {max(x, MIN_REGISTERS) for x in regs.get(ln["name"], ())}
        if r is None or r > k.reg_limit or (allowed and r not in allowed):
            out.append(_violation(
                "trace", f"#{cfg['row']} {ln['name']}: trace registers {r}, "
                f"limit {k.reg_limit}, ptxas {sorted(regs.get(ln['name'], ()))}",
                config=cfg))
    return out


def build_fresh(tmpdir: str) -> Dict[str, str]:
    """nvcc every source into ``tmpdir`` (one process each, started
    together) and return ptxas's log of each."""
    from sagecal_tpu_torch.kernels import build

    started = {n: build._start(n, os.path.join(tmpdir, f"lib{n}.so"))
               for n in build.SIGNATURES}
    logs = {}
    for n, st in started.items():
        proc = st[0]
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{n}.cu:\n{log}")
        logs[n] = log
    return logs


def crosscheck_configs() -> List[dict]:
    """Small launches of every row (milliseconds): the solo kernels at
    62 stations, 8 clusters (nc 1 and 2, f32 and bf16) and 2 clusters in
    50 chunks (past the staged threshold), the batch at 2 lanes, the
    probes at the kbisect tool's shapes."""
    from sagecal_tpu_torch.kernels import parity as P

    rows = 1891 * 2
    cfgs = []
    for nc, coh in ((1, "f32"), (2, "f32"), (1, "bf16"), (50, "f32")):
        M = 2 if nc == 50 else 8
        dt = "bfloat16" if coh == "bf16" else "float32"
        base = dict(mp=M, nc=nc, npad=62, F=2, rowsp=rows, coh=coh)

        def make(M=M, nc=nc, dt=dt):
            import torch

            return P.random_cost_problem(M, 62, 2, rows, nc=nc,
                                         coh_dtype=getattr(torch, dt))
        for row in (1, 2, 3, 4):
            cfgs.append(dict(base, row=row, make=make))
    for row in (5, 6):
        cfgs.append(dict(row=row, mp=4, nc=1, npad=62, F=2, rowsp=rows, B=2,
                         coh="f32", make=lambda: P.random_cost_problem_batch(
                             2, 4, 62, 2, rows)))
    for row, p in ((7, "c"), (8, "b"), (9, "a"), (10, "f")):
        cfgs.append(dict(row=row, npad=128, mp=8, probe=p))
    # a and f in their two-launch form too (reduce, then gather)
    for row, p in ((9, "a"), (10, "f")):
        cfgs.append(dict(row=row, npad=128, mp=8, probe=p, stages=3))
    return cfgs


def _run_row(cfg: dict) -> None:
    """One launch of ``cfg``'s row through its wrapper."""
    import torch

    from sagecal_tpu_torch.kernels import parity as P

    row = cfg["row"]
    if row >= 7:
        from sagecal_tpu_torch.tools import kbisect

        gen = torch.Generator(device="cuda").manual_seed(row)
        inputs = P.random_probe_inputs(cfg["probe"], gen, cfg["mp"], 256,
                                       R=2, npad=cfg["npad"])
        if "stages" in cfg:
            getattr(kbisect, f"probe_{cfg['probe']}_cuda")(
                *inputs, stages=cfg["stages"])
        else:
            getattr(kbisect, f"probe_{cfg['probe']}")(*inputs)
    else:
        prob = cfg["make"]()
        if row == 1:
            P.predict_and_grad(prob, P.model_cotangent(prob))
        elif row == 2:
            P.predict_and_grad(prob, P.model_cotangent(prob))
        elif row in (3, 4):
            P.value_and_grad(prob)
        else:
            P.value_and_grad_batch(prob)
    torch.cuda.synchronize()


def crosscheck_table(model: km.KernelModel, ptxas: Dict[str, dict],
                     launches: List[dict]) -> Dict[str, dict]:
    """Per kernel function: the model's static shared memory and register
    limit, ptxas's registers and static shared memory (every
    instantiation), and the shared memory and registers of its traced
    launches."""
    names = [k for s in model.sources.values() for k in s.kernels]
    table = {n: {"model_static_smem": model.kernel(n).static_smem,
                 "model_reg_limit": model.kernel(n).reg_limit,
                 "ptxas_registers": [], "ptxas_smem": [],
                 "trace_smem": [], "trace_registers": []} for n in names}
    for mangled, e in ptxas.items():
        n = kernel_of_mangled(mangled, names)
        if n is not None:
            table[n]["ptxas_registers"].append(e["registers"])
            table[n]["ptxas_smem"].append(e["smem"])
    for ln in launches:
        t = table[ln["name"]]
        t["trace_smem"].append(ln["shared_memory"])
        t["trace_registers"].append(ln["registers"])
    for t in table.values():
        for k in ("ptxas_registers", "ptxas_smem", "trace_smem",
                  "trace_registers"):
            t[k] = sorted(set(t[k]))
    return table


# seconds of device activity a crosscheck capture starts with: on the card
# the first records of a capture were lost (a configuration's, or a short
# capture's all) in full smoke runs
CAPTURE_WARMUP_S = 1.0
DELIMITER = "spin_kernel"  # torch.cuda._sleep's kernel


def split_launches(path: str, n: int) -> Optional[List[List[dict]]]:
    """The port's kernel launches of a crosscheck capture, in ``n``
    segments, each opened by one ``torch.cuda._sleep`` kernel on the
    stream; each kernel's row by launch order (``obs/devprof.py``).
    None unless exactly ``n`` delimiters were recorded."""
    from sagecal_tpu_torch.obs import devprof

    events, _ = devprof.read_trace_events(path)
    ops = sorted(devprof.device_op_events(events, gpu=True),
                 key=lambda e: float(e["ts"]))
    rows = devprof._sequence_rows(ops)
    segments: List[List[dict]] = []
    for i, e in enumerate(ops):
        name = e.get("name", "")
        if DELIMITER in name:
            segments.append([])
        elif segments and devprof.own_kernel(name):
            rec = devprof.launch_record(e)
            rec["row"] = rows[i][0] if i in rows else None
            segments[-1].append(rec)
    return segments if len(segments) == n else None


def _capture(tmp: str, cfgs: List[dict]) -> Optional[List[List[dict]]]:
    """Every configuration under one capture of the card's activity
    alone, after CAPTURE_WARMUP_S of small launches, each opened by a
    delimiter kernel -> :func:`split_launches`."""
    import time

    import torch

    from sagecal_tpu_torch.obs import devprof

    trace_dir = os.path.join(tmp, f"trace{len(os.listdir(tmp))}")
    cap = devprof.begin_capture(trace_dir, cpu_ops=False)
    try:
        end = time.perf_counter() + CAPTURE_WARMUP_S
        while time.perf_counter() < end:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.01)
        for cfg in cfgs:
            torch.cuda._sleep(1000)
            _run_row(cfg)
        time.sleep(0.2)
    finally:
        path = devprof.end_capture(cap)
    return split_launches(path, len(cfgs))


def _check_crosscheck(model: km.KernelModel,
                      table: Optional[dict] = None) -> List[Dict[str, Any]]:
    """ptxas's report and one capture of every row's launches, on the
    card; ``table`` (a dict) receives :func:`crosscheck_table`.  A
    capture missing a delimiter or a configuration's kernels is taken
    once more."""
    out: List[Dict[str, Any]] = []
    traced: List[dict] = []
    with tempfile.TemporaryDirectory() as tmp:
        logs = build_fresh(tmp)
        out.extend(check_ptxas(model, logs))
        ptxas: Dict[str, dict] = {}
        for log in logs.values():
            ptxas.update(parse_ptxas(log))
        cfgs = crosscheck_configs()
        per_cfg = _capture(tmp, cfgs)
        if per_cfg is None or not all(per_cfg):
            per_cfg = _capture(tmp, cfgs)
        if per_cfg is None:
            raise RuntimeError("kernel check: the capture lost a "
                               "configuration's delimiter kernel twice")
        for cfg, launches in zip(cfgs, per_cfg):
            # a forward row's launch also runs its backward (the
            # wrappers differentiate): keep the launches of this row
            att = {"launches": [ln for ln in launches
                                if ln["row"] in (None, cfg["row"])]}
            out.extend(check_trace(model, cfg, att, ptxas))
            traced.extend(att["launches"])
    if table is not None:
        table.update(crosscheck_table(model, ptxas, traced))
    return out


def _check_lint(csrc: Optional[str] = None,
                fused_cost: Optional[str] = None) -> List[Dict[str, Any]]:
    """JL013 and JL014 over the package and its kernel sources (plus the
    ``csrc``/``fused_cost`` overrides): each gate finding is a ``lint``
    violation (the reference's ``_check_lint``)."""
    from sagecal_tpu_torch.analysis.engine import analyze_paths
    from sagecal_tpu_torch.analysis.rules.jl013 import BackwardCompleteness
    from sagecal_tpu_torch.analysis.rules.jl014 import KernelNumerics

    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [package] + [p for p in (csrc, fused_cost) if p]
    findings, _stats, _graph = analyze_paths(
        paths, rules=[BackwardCompleteness(), KernelNumerics()])
    return [_violation("lint", f"{f.path}:{f.line}: {f.rule} {f.message}",
                       rule=f.rule, symbol=f.symbol)
            for f in findings if not f.report_only]


def run_kernel_check(csrc: Optional[str] = None,
                     fused_cost: Optional[str] = None,
                     crosscheck: bool = False) -> Dict[str, Any]:
    """Every kernel contract: ``{"violations": [...], "summary":
    {...}}``.  ``csrc`` / ``fused_cost``: source overrides (tests)."""
    violations: List[Dict[str, Any]] = []
    model = None
    try:
        model = km.load_model(csrc, fused_cost)
    except (km.ModelExtractionError, OSError, KeyError) as exc:
        violations.append(_violation(
            "model-extraction", f"cannot build the model: {exc}"))
    lint = _check_lint(csrc, fused_cost)
    violations.extend(lint)
    summary: Dict[str, Any] = {"csrc": csrc or km.default_csrc(),
                               "crosscheck": crosscheck,
                               "lint_findings": len(lint)}
    if model is not None:
        violations.extend(_check_model_contracts(model))
        if crosscheck:
            table: Dict[str, dict] = {}
            violations.extend(_check_crosscheck(model, table))
            summary["crosscheck_table"] = table
        summary["staged_threshold"] = {
            "f32": model.staged_threshold(4),
            "bf16": model.staged_threshold(2)}
        summary["cot_ring_bytes"] = {"f32": model.cot_ring_bytes(4),
                                     "bf16": model.cot_ring_bytes(2)}
        summary["kernels"] = {
            k.name: {"threads": k.threads, "min_blocks": k.min_blocks,
                     "static_smem": k.static_smem, "reg_limit": k.reg_limit}
            for s in model.sources.values() for k in s.kernels.values()}
    summary["violations"] = len(violations)
    summary["kinds"] = sorted({v["kind"] for v in violations})
    return {"violations": violations, "summary": summary}


def render_text(result: Dict[str, Any]) -> str:
    s = result["summary"]
    lines = [f"kernelcheck: csrc={s['csrc']} crosscheck={s['crosscheck']}",
             f"  lint JL013/JL014: {s['lint_findings']} gate finding(s)"]
    if "staged_threshold" in s:
        lines.append("  staged threshold nc*npad <= %(f32)d (f32), "
                     "%(bf16)d (bf16)" % s["staged_threshold"])
        lines.append("  cotangent ring %(f32)d B (f32), %(bf16)d B (bf16)"
                     % s["cot_ring_bytes"])
        for name, k in sorted(s["kernels"].items()):
            lines.append(
                f"  {name}: {k['threads']} threads x {k['min_blocks']} "
                f"blocks, {k['static_smem']} B static smem, <= "
                f"{k['reg_limit']} registers")
    if not result["violations"]:
        lines.append("  OK — all kernel contracts hold")
    for v in result["violations"]:
        lines.append(f"  VIOLATION [{v['kind']}] {v['message']}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="kernelcheck",
        description="Hopper shared-memory, register and thread budgets of "
                    "the port's kernels")
    parser.add_argument("--json", action="store_true",
                        help="emit machine-readable JSON")
    parser.add_argument("--csrc", default=None,
                        help="kernel source directory override (tests)")
    parser.add_argument("--fused-cost", default=None,
                        help="fused_cost.cu override (mutation tests)")
    parser.add_argument("--crosscheck", action="store_true",
                        help="also build fresh (ptxas -v) and trace every "
                             "row's launches on the card")
    args = parser.parse_args(argv)
    try:
        result = run_kernel_check(args.csrc, args.fused_cost,
                                  crosscheck=args.crosscheck)
    except Exception as exc:  # internal error, not a violation
        print(f"kernelcheck: internal error: {exc}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(result, indent=2, sort_keys=True, default=str))
    else:
        print(render_text(result))
    return 1 if result["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
