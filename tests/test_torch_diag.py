"""Port vs JAX package: the ``diag`` command line (``obs/diag.py``).

Every subcommand of the port but ``manifest``, ``roofline``,
``kernelcheck`` and ``lint`` runs beside the JAX package's ``diag`` on
the same files: manifests and event logs, bench records and a bench
history, quality events, a served out-dir, a synthetic fleet and load
run (``tests/test_audit.py``'s ``synth_run``), a drift ledger, a span log
and a flight dump.  Standard output, with package names and the two
scratch directories normalised, and exit codes are equal.

The stated differences: ``manifest`` describes torch and CUDA (the
reference's validator misses only its JAX versions in it); ``flight``
names torch's CUDA state on its device line; ``roofline`` reads Kineto's
format and attributes to the kernel table's rows
(tests/test_torch_devprof.py), and exits 1 on a file that is no trace,
where the reference raises; ``kernelcheck`` proves Hopper budgets
(tests/test_torch_kernelmodel.py); ``lint`` runs the port's own rules
over the port (tests/test_torch_lint.py), not jaxlint over JAX source.
"""

import json
import os
import re
import shutil

import pytest

from test_audit import synth_run

DIAG = {}


def _run(pkg, argv, capsys, monkeypatch):
    """(exit code, stdout) of one package's ``diag main(argv)`` with a
    fresh process registry (``prom`` dumps it)."""
    import importlib

    diag = importlib.import_module(f"{pkg}.obs.diag")
    reg = importlib.import_module(f"{pkg}.obs.registry")
    monkeypatch.setattr(reg, "_GLOBAL", reg.MetricsRegistry())
    capsys.readouterr()
    try:
        rc = diag.main(list(argv))
    except SystemExit as e:  # argparse usage errors
        rc = e.code
    return rc, capsys.readouterr().out


def both(argv, capsys, monkeypatch, jax_argv=None):
    """Run the port's and the JAX package's diag; return both results,
    normalised (``{p}`` and ``{j}`` in argv are each side's directory)."""
    got = _run("sagecal_tpu_torch", [a.replace("{j}", "{p}").format(
        p=DIAG["p"]) for a in argv], capsys, monkeypatch)
    want = _run("sagecal_tpu", [a.format(p=DIAG["p"], j=DIAG["j"])
                                for a in (jax_argv or argv)],
                capsys, monkeypatch)
    norm = lambda s: s.replace("sagecal_tpu_torch", "sagecal_tpu").replace(
        DIAG["p"], "<dir>").replace(DIAG["j"], "<dir>")  # noqa: E731
    return (got[0], norm(got[1])), (want[0], norm(want[1]))


def _same(argv, capsys, monkeypatch, rc=None, jax_argv=None,
          seconds=False):
    """Both packages' diag on ``argv``: equal exit codes and stdout
    (``seconds``: each wall-clock reading "<x.y>s" taken as equal)."""
    got, want = both(argv, capsys, monkeypatch, jax_argv)
    if seconds:
        got, want = [(rc_, re.sub(r"\b\d+\.\d+s\b", "<s>", out))
                     for rc_, out in (got, want)]
    assert got == want, (argv, got, want)
    if rc is not None:
        assert got[0] == rc, got
    return got


EVENTS = [
    {"type": "run_manifest", "run_id": "r1", "schema_version": 1,
     "created_unix": 1.0, "argv": [], "pid": 1, "platform": "gpu",
     "device_kind": "NVIDIA H100 80GB HBM3", "num_devices": 1,
     "kernel_path": "fused", "ts": 10.0, "x64_enabled": False,
     "jax_version": "0.9", "jaxlib_version": "0.9", "torch_version": "2",
     "cuda_version": "12.8"},
    {"type": "cluster_convergence", "run_id": "r1", "ts": 11.0,
     "cost": [3.0, 2.0, 1.5]},
    {"type": "cluster_convergence", "run_id": "r1", "ts": 11.5,
     "cost": [4.0, float("nan"), 0.5]},
    {"type": "admm_round", "run_id": "r1", "ts": 12.0,
     "primal_res": [1.0, 0.5], "dual_res": [0.2, 0.1]},
    {"type": "tile_done", "run_id": "r1", "ts": 13.0,
     "phase_seconds": {"solve": 1.25, "load": 0.5}},
    {"type": "tile_done", "run_id": "r1", "ts": 14.0,
     "phase_seconds": {"solve": 1.0}},
    {"type": "checkpoint_written", "run_id": "r1", "ts": 14.5,
     "path": "c.npz", "tile_index": 1},
    {"type": "resume_refused", "run_id": "r2", "ts": 15.0,
     "mismatch": "config", "path": "c.npz"},
    {"type": "jit_compile", "fn": "sagefit_packed", "lower_seconds": 0.5,
     "compile_seconds": 2.0, "flops": 3e9, "bytes_accessed": 4e8,
     "ts": 16.0},
    {"type": "memory_watermark", "phases": {"solve": 3e8}, "ts": 17.0,
     "snapshot": {"source": "device", "device_kind": "x"}},
    {"type": "transfer_audit", "counts": {"device_to_host": 4}, "ts": 18.0},
    {"type": "bench_result", "value": 12.5, "fused_kernel": True,
     "ts": 19.0},
    {"type": "solve_quality", "tile": 0, "cluster": 0, "ts": 20.0,
     "chi2_station": [1.0, 1.2, 0.9, 1.1], "chi2_total": 4.2, "nu": 5.0,
     "downweighted_frac": 0.1,
     "chi2_baseline": [[0, 1, 1, 1], [0, 0, 1, 1], [0, 0, 0, 1],
                       [0, 0, 0, 0]]},
    {"type": "solve_quality", "tile": 1, "cluster": 0, "ts": 21.0,
     "chi2_station": [1.0, 90.0, 0.9, 1.1], "chi2_total": 93.0,
     "nu": 5.0, "downweighted_frac": 0.1},
]

REC = {"value": 100.0, "peak_device_memory_bytes": 1e9,
       "serve_p50_latency_s": 2.0, "admm_collective_bytes_per_round": 4e6,
       "platform": "tpu",
       "evidence_classes": {"admm_collective_bytes_per_round": "aot-hlo"}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One set of input files per side (their paths differ only by the
    side's directory)."""
    from sagecal_tpu.obs.events import RunManifest

    root = tmp_path_factory.mktemp("diag")
    for side in ("p", "j"):
        d = root / side
        d.mkdir()
        DIAG[side] = str(d)
        with open(d / "ev.jsonl", "w") as f:
            for e in EVENTS:
                f.write(json.dumps(e) + "\n")
        with open(d / "empty.jsonl", "w"):
            pass
        # a manifest of both packages' keys: each validator requires
        # its own versions (jax/jaxlib, torch/cuda)
        man = dict(RunManifest.collect().to_dict(), torch_version="2",
                   cuda_version="12.8", run_id="run1", num_devices=8)
        json.dump(man, open(d / "man.json", "w"))
        json.dump({"run_id": "x"}, open(d / "bad_man.json", "w"))
        recs = {
            "base": REC, "pass": dict(REC, value=95.0),
            "fail": dict(REC, value=70.0, peak_device_memory_bytes=2e9),
            "gpu": dict(REC, platform="gpu", value=101.0),
            "cpu": dict(REC, platform="cpu"),
            "empty": {"other": 1},
            "unclassified": {"value": 1.0, "evidence_classes":
                             {"value": "bogus"}},
        }
        for k, r in recs.items():
            json.dump(r, open(d / f"{k}.json", "w"))
        with open(d / "hist.jsonl", "w") as f:
            for i, ev in enumerate(("tpu-wallclock", "tpu-wallclock",
                                    "gpu-wallclock", None)):
                row = {"config_fingerprint": "fp", "git_rev": f"r{i}",
                       "value": 100.0 + i, "serve_p50_latency_s": 2.0}
                if ev:
                    row["evidence"] = ev
                f.write(json.dumps(row) + "\n")
        synth_run(str(d / "fleet"))
        shutil.copytree(d / "fleet", d / "load")
        json.dump({"schema_version": 2, "kind": "load_steps",
                   "writer": "load", "seed": 0, "arrival": "poisson",
                   "t_start": 95.0,
                   "steps": [{"index": 0, "t0": 95.0, "t1": 125.0,
                              "offered_rate": 0.1, "arrivals": 3}],
                   "submitted": [{"t": 5.0, "request_id": "req000"},
                                 {"t": 6.0, "request_id": "req001"},
                                 {"t": 7.0, "request_id": "req002"}]},
                  open(d / "load" / "load_steps.json", "w"))
        rows = [{"schema_version": 1, "kind": "shadow_drift",
                 "ts": 100.0 + i, "request_id": f"req{i:03d}",
                 "path_pair": "xla/f32|xla/f32", "kernel_path": "xla",
                 "kernel_path_reason": "r", "bucket": "B", "coh_dtype":
                 "f32", "solver_dtype": "float64",
                 "cost_rel_delta": 1e-6 * (i + 1),
                 "gain_rel_err_max": 2e-6, "chi2_rel_delta": 3e-6,
                 "verdict": "ok", "reasons": [], "shadow_s": 0.1}
                for i in range(5)]
        os.makedirs(d / "drift")
        with open(d / "drift" / "drift.jsonl", "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        from sagecal_tpu_torch.obs.trace import Tracer

        tr = Tracer(str(d / "spans.jsonl"), trace_id="t1")
        root_id = tr.add_span("admm", 3.0, start_unix=1.0, kind="run")
        for band, sec in enumerate((1.0, 1.1, 2.5)):
            tr.add_span("xstep", sec, parent_id=root_id, start_unix=1.0,
                        band=band, lane=f"band{band}")
        tr.close()  # the spans are written as the tracer closes
        json.dump({"reason": "stall", "pid": 7, "run_id": "r1", "ts": 5.0,
                   "last_activity_age": 61.5,
                   "exception": {"type": "RuntimeError", "value": "x"},
                   "last_checkpoint": "c.npz",
                   "threads": [{"name": "MainThread", "tid": 1,
                                "daemon": False,
                                "stack": ["frame a\n  line", "frame b"]}],
                   "ring": [{"kind": "tile", "name": "tile0", "t": 1.0,
                             "age_s": 3.0}]},
                  open(d / "flight.json", "w"))
        json.dump({"nothing": 1}, open(d / "notflight.json", "w"))
    return root


CASES = {
    "validate_manifest": (["validate", "{j}/man.json"], 0),
    "validate_bad": (["validate", "{j}/bad_man.json"], 1),
    "validate_log": (["validate", "{j}/ev.jsonl"], 0),
    "events": (["events", "{j}/ev.jsonl"], 0),
    "events_empty": (["events", "{j}/empty.jsonl"], 1),
    "prom": (["prom", "--events", "{j}/ev.jsonl"], 0),
    "perf": (["perf", "{j}/ev.jsonl"], 0),
    "perf_empty": (["perf", "{j}/empty.jsonl"], 1),
    "gate_pass": (["gate", "{j}/pass.json", "--baseline", "{j}/base.json"],
                  0),
    "gate_fail": (["gate", "{j}/fail.json", "--baseline", "{j}/base.json"],
                  1),
    "gate_tpu_vs_gpu": (["gate", "{j}/gpu.json", "--baseline",
                         "{j}/base.json"], 2),
    "gate_strict": (["gate", "{j}/gpu.json", "--baseline", "{j}/base.json",
                     "--strict"], 0),
    "gate_metric": (["gate", "{j}/fail.json", "--baseline", "{j}/base.json",
                     "--metric", "value=0.5", "--tol", "1.5"], 0),
    "gate_bad_spec": (["gate", "{j}/pass.json", "--baseline",
                       "{j}/base.json", "--metric", "value=x"], 2),
    "gate_nothing": (["gate", "{j}/empty.json", "--baseline",
                      "{j}/base.json"], 1),
    "evidence": (["evidence", "{j}/base.json", "--history",
                  "{j}/hist.jsonl"], 1),
    "evidence_gpu": (["evidence", "{j}/gpu.json"], 0),
    "evidence_unclassified": (["evidence", "{j}/unclassified.json"], 1),
    "quality": (["quality", "{j}/ev.jsonl", "--out-dir", "{j}/q"], 0),
    "quality_degraded": (["quality", "{j}/ev.jsonl", "--out-dir", "{j}/q",
                          "--fail-degraded"], 1),
    "serve": (["serve", "{j}/fleet", "--bench-history", "{j}/hist.jsonl"],
              None),
    "load": (["load", "{j}/load"], None),
    "drift": (["drift", "{j}/drift"], 0),
    "drift_none": (["drift", "{j}/fleet"], 0),
    "trace": (["trace", "{j}/spans.jsonl"], 0),
    "trace_empty": (["trace", "{j}/empty.jsonl"], 1),

    "flight_not_a_dump": (["flight", "{j}/notflight.json"], 1),
    "audit": (["audit", "{j}/fleet"], 0),
    "audit_json": (["audit", "{j}/fleet", "--json"], 0),
    "audit_inject": (["audit", "{j}/fleet", "--inject", "drop_event"], 1),
    "audit_empty": (["audit", "{j}/drift"], 2),
    "replay": (["replay", "{j}/fleet"], 0),
    "replay_empty": (["replay", "{j}/drift"], 2),
    "protocol": (["protocol", "--workers", "1", "--crashes", "0",
                  "--ticks", "1"], 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_subcommand_matches_jax(case, files, capsys, monkeypatch):
    argv, rc = CASES[case]
    monkeypatch.delenv("SAGECAL_BENCH_HISTORY", raising=False)
    if case.startswith("quality"):
        for side in ("p", "j"):
            shutil.rmtree(os.path.join(DIAG[side], "q"), ignore_errors=True)
    # the protocol checker prints each scenario's wall seconds
    got = _same(argv, capsys, monkeypatch, rc, seconds=case == "protocol")
    if case == "quality":
        rep = json.load(open(os.path.join(DIAG["p"], "q",
                                          "quality_report.json")))
        want = json.load(open(os.path.join(DIAG["j"], "q",
                                           "quality_report.json")))
        norm = lambda r: json.loads(json.dumps(r).replace(  # noqa: E731
            DIAG["p"], "").replace(DIAG["j"], ""))
        assert norm(rep) == norm(want)
    if case == "protocol":
        assert "ok" in got[1].lower()


def test_flight_matches_jax_but_the_device_line(files, capsys,
                                               monkeypatch):
    """The dump's device section names torch's CUDA state in the port,
    JAX's backend in the reference; every other line is equal."""
    got, want = both(["flight", "{j}/flight.json"], capsys, monkeypatch)
    drop = lambda out: [ln for ln in out.splitlines()  # noqa: E731
                        if not ln.startswith("devices:")]
    assert got[0] == want[0] == 0
    assert drop(got[1]) == drop(want[1]) and len(drop(got[1])) > 5


def test_manifest_validates_under_both(files, capsys, monkeypatch):
    from sagecal_tpu.obs.events import validate_manifest as jvalidate
    from sagecal_tpu_torch.obs.diag import main
    from sagecal_tpu_torch.obs.events import validate_manifest

    out = os.path.join(DIAG["p"], "port_man.json")
    assert main(["manifest", "--out", out, "--kernel-path", "fused"]) == 0
    doc = json.load(open(out))
    # the reference's validator asks for its own versions only
    assert validate_manifest(doc) == []
    assert jvalidate(doc) == ["missing key: jax_version",
                              "missing key: jaxlib_version"]
    assert doc["kernel_path"] == "fused" and doc["platform"] == "cpu"
    assert doc["torch_version"] and doc["cuda_version"]
    capsys.readouterr()
    assert main(["manifest"]) == 0
    assert json.loads(capsys.readouterr().out)["kernel_path"] == "torch"


def test_roofline_lint_and_kernelcheck_stated_differences(files, capsys,
                                                          monkeypatch):
    from sagecal_tpu_torch.apps.cli import main as cli

    from sagecal_tpu_torch.obs.diag import main

    # a file that is not a trace: exit 1 (the reference raises on it)
    assert main(["roofline", os.path.join(DIAG["p"], "ev.jsonl")]) == 1
    assert cli(["diag", "lint"], device="cpu") == 0
    assert cli(["diag", "lint", "--format", "json", "x.py"],
               device="cpu") == 2
    assert "no such path: x.py" in capsys.readouterr().err
    assert cli(["diag", "lint", "--rules", "JL003"], device="cpu") == 2
    assert "no counterpart" in capsys.readouterr().err
    assert cli(["diag", "kernelcheck"], device="cpu") == 0
