"""Whole cells on the CPU at a tiny size, the harness's look for a card
skipped: a sound run is correct; the control and each fault the cells
can have, planted under the timed path, make ``correct`` false; a new
configuration, mix and metric reader added as new files run as a new
cell.  (The cells run on one chip: no exchange between chips to leave
out.)"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import control
from benchmark.run import run_cell
from benchmark.tests.tiny import ROOT, tiny_copy

SEED = 3000000077


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("bench")))


def _run(bench, cell, patches=(), trace=False):
    return run_cell(f"tiny.{cell}", SEED, 0.0, trace, "cpu", bench_dir=bench,
                    patches=patches, warmup=False)


def _patch(name, make):
    """A program patch: ``apps.fullbatch``'s ``name`` replaced by
    ``make(real)`` for the run."""
    def install(fb, obs):
        real = getattr(fb, name)
        setattr(fb, name, make(real))
        return lambda: setattr(fb, name, real)
    return install


def _unchanged_solve(real):
    def solve(data, cdata, p0, *a, **kw):
        out = real(data, cdata, p0, *a, **kw)
        out.p, out.res_1 = p0.clone(), out.res_0
        return out
    return solve


def _half(real):
    """Half of the rows left out of the step: passed through unchanged."""
    def step(data, *a, **kw):
        out = real(data, *a, **kw).clone()
        h = out.shape[-1] // 2
        out[..., h:] = data.vis[..., h:]
        return out
    return step


def _half_solve(real):
    """Half of the rows left out of the solve (masked), the norms taken
    over the rest."""
    def solve(data, *a, **kw):
        mask = data.mask.clone()
        mask[..., mask.shape[-1] // 2:] = 0
        return real(data.replace(mask=mask), *a, **kw)
    return solve


def _altered(real):
    """The step's answer altered where it is produced: scaled by 1.1."""
    def step(*a, **kw):
        return real(*a, **kw) * 1.1
    return step


def _sage_patch(name, make):
    """A program patch of ``solvers/sage.py``'s ``name``."""
    def install(fb, obs):
        from sagecal_tpu_torch.solvers import sage

        real = getattr(sage, name)
        setattr(sage, name, make(real))
        return lambda: setattr(sage, name, real)
    return install


def _fit_skipped(real):
    """The joint LBFGS skipped: the solve ends with the EM."""
    def solve(data, cdata, p0, config, *a, **kw):
        return real(data, cdata, p0, dataclasses.replace(config, max_lbfgs=0),
                    *a, **kw)
    return solve


def _fit_unchanged(real):
    """The joint LBFGS returns its start."""
    def fit(cost_fn, grad_fn, p0, *a, **kw):
        return real(cost_fn, grad_fn, p0, *a, **kw)._replace(p=p0.clone())
    return fit


def _half_gradient(real):
    """#4 over half the rows: the cost of every row, the gradient of the
    first half."""
    def make(data, *a, **kw):
        full = real(data, *a, **kw)
        mask = data.mask.clone()
        mask[..., mask.shape[-1] // 2:] = 0
        half = real(data.replace(mask=mask), *a, **kw)

        def cost_fn(p):
            h = half(p)
            return full(p).detach() + (h - h.detach())
        return cost_fn
    return make


def _altered_gain(fb, obs):
    real = fb.solio.append_solutions

    def write(fh, jones, *a, **kw):
        jones = jones.copy()
        jones[0, 0] *= 1.1
        return real(fh, jones, *a, **kw)
    fb.solio.append_solutions = write
    return lambda: setattr(fb.solio, "append_solutions", real)


@pytest.mark.parametrize("cell", ["calibrate", "subtract"])
def test_a_sound_run_is_correct(bench, cell):
    res = _run(bench, cell)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] == (2 if cell ==
                                                        "calibrate" else 8)
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("cell,name,numbers", [
    ("calibrate", "coherencies", ["resid_gap"]),
    ("subtract", "coherencies", ["resid_gap"]),
    ("calibrate", "joint_cost", ["fit_cost_gap", "fit_grad_gap"])])
def test_the_control_is_not_correct(bench, cell, name, numbers):
    res = _run(bench, cell, [control.CONTROLS[name]])
    assert not res["correct"]
    assert any(res["check"][k]["value"] > res["check"][k]["limit"]
               for k in numbers), res["check"]


FAULTS = {
    "calibrate": {
        "state_unchanged": _patch("solve_tile", _unchanged_solve),
        "half_of_the_residual": _patch("calculate_residuals", _half),
        "half_of_the_solve": _patch("solve_tile", _half_solve),
        "residual_altered": _patch("calculate_residuals", _altered),
        "gain_altered": _altered_gain,
        "joint_fit_skipped": _patch("solve_tile", _fit_skipped),
        "joint_fit_unchanged": _sage_patch("lbfgs_fit", _fit_unchanged),
        "joint_gradient_over_half_the_rows": _sage_patch(
            "_make_fused_joint_cost", _half_gradient)},
    "subtract": {
        "state_unchanged": _patch("simulate_visibilities",
                                  lambda real: lambda data, *a, **k:
                                  data.vis.clone()),
        "half_of_the_rows": _patch("simulate_visibilities", _half),
        "answer_altered": _patch("simulate_visibilities", _altered)},
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs])
def test_a_fault_under_the_timed_path_is_not_correct(bench, cell, fault):
    res = _run(bench, cell, [FAULTS[cell][fault]])
    assert not res["correct"], (fault, res["check"])


def test_a_new_configuration_mix_and_metric_run_as_a_new_cell(tmp_path):
    before = {}
    for d, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                before[os.path.relpath(p, ROOT)] = open(p, "rb").read()
    bench = tiny_copy(str(tmp_path), name="tiny2", base="ska_low_512st",
                      extra_metric="coh_wall_s_max")
    # the new cell uses a new mix too: the calibrate mix over one tile
    with open(os.path.join(bench, "mixes", "calibrate.json")) as f:
        mix = json.load(f)
    mix["tiles_per_run"] = 1
    with open(os.path.join(bench, "mixes", "calibrate1.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(tmp_path, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "tiny2.calibrate1", "config": "tiny2",
                              "traffic": "calibrate1", "chips": 1,
                              "why": "a CPU test"})
    # its own rate, a quantity of the harness split by a new entry
    spec["end_to_end"].append({"name": "vis_rows_per_s.tiny2", "unit":
                               "rows/s", "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny2.calibrate1"]})
    with open(os.path.join(bench, "limits", "tiny2.calibrate.json")) as f:
        lim = f.read()
    with open(os.path.join(bench, "limits", "tiny2.calibrate1.json"),
              "w") as f:
        f.write(lim)
    with open(os.path.join(tmp_path, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    for rel, data in before.items():
        if not rel.startswith("benchmark/tests"):
            with open(os.path.join(tmp_path, rel), "rb") as f:
                assert f.read() == data, rel
    res = run_cell("tiny2.calibrate1", SEED, 0.0, False, "cpu",
                   bench_dir=bench, warmup=False)
    assert res["correct"] and res["attempted"] == 1
    assert set(res["metrics"]) == {"vis_rows_per_s.tiny2", "peak_mem_gib",
                                   "setup_s"}
    # the new reader reads the window's spans in a traced run; without a
    # card there is no device trace, so the device readers stay silent,
    # and the metrics that list their cells do not name this one
    import benchmark.harness.devtrace as devtrace

    real = devtrace.profiled
    devtrace.profiled = _no_device_trace
    try:
        res = run_cell("tiny2.calibrate1", SEED, 0.0, True, "cpu",
                       bench_dir=bench, warmup=False)
    finally:
        devtrace.profiled = real
    assert set(res["metrics"]) == {"coh_wall_s_max"}


def _no_device_trace(fn, probe):
    return fn(), 1.0, []


def test_a_traced_run_that_loses_sight_of_a_listed_metric_fails(bench,
                                                                monkeypatch):
    import benchmark.harness.devtrace as devtrace

    # the tiny calibrate cell is listed by the device-trace metrics; a
    # trace with nothing in it leaves them nothing to read
    monkeypatch.setattr(devtrace, "profiled", _no_device_trace)
    with pytest.raises(RuntimeError, match="read nothing in tiny.calibrate"):
        _run(bench, "calibrate", trace=True)


def test_a_traced_run_fails_when_a_wrapped_layer_is_never_entered(tmp_path):
    # a driver whose layers name a function the app has but no longer
    # calls on this path (as if a later change inlined it)
    bench = tiny_copy(str(tmp_path))
    with open(os.path.join(bench, "drivers", "inlined.py"), "w") as f:
        f.write("from benchmark.harness import check, fullbatch\n"
                "SPEC = fullbatch.Spec(flags=lambda obs: ['-a', '0'],\n"
                "    judge=check.calibrate_numbers,\n"
                "    layers={'solve_tile': 'solve',\n"
                "            'simulate_visibilities': 'residual'},\n"
                "    keep_solutions=True, record_fits=True)\n"
                "def run(cell):\n"
                "    return fullbatch.run(cell, SPEC)\n")
    with open(os.path.join(bench, "mixes", "inlined.json"), "w") as f:
        json.dump({"driver": "inlined", "tiles_per_run": 2}, f)
    spec_path = os.path.join(tmp_path, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "tiny.inlined", "config": "tiny",
                              "traffic": "inlined", "chips": 1,
                              "why": "a CPU test"})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    with open(os.path.join(bench, "limits", "tiny.inlined.json"), "w") as f:
        json.dump({"limits": {"resid_gap": 0.05}}, f)
    with pytest.raises(RuntimeError, match="never entered.*residual"):
        run_cell("tiny.inlined", SEED, 0.0, True, "cpu", bench_dir=bench,
                 warmup=False)


def test_without_a_card_the_command_exits_non_zero_with_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "lofar_hba_62st.calibrate", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_the_command_exits_non_zero(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "lofar_hba_62st.calibrate", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_the_control_on_the_card_is_not_correct(bench):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run_cell("tiny.calibrate", SEED, 0.0, False, "cuda",
                   bench_dir=bench, warmup=False)
    assert res["correct"], res["check"]
    res = run_cell("tiny.calibrate", SEED, 0.0, False, "cuda",
                   bench_dir=bench, warmup=False,
                   patches=[control.joint_cost, control.coherencies])
    assert not res["correct"]
