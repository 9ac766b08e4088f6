"""The port's static-analysis gate (``sagecal_tpu_torch/analysis/``, the
counterpart of jaxlint in ``sagecal_tpu/analysis/``).

- parity: the protocol rules JL008, JL009, JL010, JL016 and the
  report-only JL900 run through both linters on the reference's own
  fixtures (``tests/fixtures/jaxlint/``; the port reads a copy with its
  pragmas spelled ``torchlint:``) and report the same (rule, line,
  column) set;
- every re-aimed rule fires on a fixture written here and stays silent
  on its clean counterpart, the kernel rule JL014 also on ``.cu``
  sources and on mutated copies of ``csrc/fused_cost.cu`` (a float
  ``atomicAdd``) and ``core/segment.py`` (an ``index_add_``, the port's
  first fault);
- reachability: the real tree's roots are its 16 ``instrumented`` wrap
  sites and the forward/backward of its 7 ``autograd.Function``s;
- the machinery: pragmas, the baseline round trip, the command line's
  formats and exit codes, ``diag lint`` and ``kernelcheck``'s lint check;
- the package gate: zero gate findings with no baseline, every
  report-only finding recorded with its reason, under 25 s.

Runs on the CPU; the linter imports neither torch nor JAX.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from sagecal_tpu_torch.analysis import baseline as baseline_mod
from sagecal_tpu_torch.analysis import cli as lint_cli
from sagecal_tpu_torch.analysis.engine import analyze_paths, default_rules

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sagecal_tpu_torch")
FIXDIR = os.path.join(REPO, "tests", "fixtures", "jaxlint")
BASELINE = os.path.join(PORT, "analysis", "lint_baseline.json")

HEAD = ("import numpy as np\nimport torch\n"
        "from sagecal_tpu_torch.obs.perf import instrumented\n\n")


def write(tmp_path, rel, text):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return str(path)


def fired(path, rule):
    rules = [r for r in default_rules() if r.id == rule]
    return analyze_paths([path], rules)[0]


# ----------------------------------------------------- parity with jaxlint


PARITY = [
    ("JL008", "fleet/jl008_fire.py"), ("JL008", "fleet/jl008_clean.py"),
    ("JL010", "fleet/jl010_fire.py"), ("JL010", "fleet/jl010_clean.py"),
    ("JL016", "fleet/jl016_fire.py"), ("JL016", "fleet/jl016_clean.py"),
    ("JL009", "jl009_fire.py"), ("JL009", "jl009_clean.py"),
    ("JL900", "jl900_fixture.py"),
]


@pytest.mark.parametrize("rule,fixture", PARITY)
def test_protocol_rules_match_the_reference(rule, fixture, tmp_path):
    from sagecal_tpu.analysis.engine import analyze_paths as ref_analyze
    from sagecal_tpu.analysis.rules import all_rules as ref_rules

    src = os.path.join(FIXDIR, fixture)
    ref = ref_analyze([src], [c() for c in ref_rules() if c.id == rule])[0]
    copy = write(tmp_path, fixture,
                 open(src).read().replace("jaxlint:", "torchlint:"))
    port = fired(copy, rule)
    assert {(f.rule, f.line, f.col) for f in port} == \
        {(f.rule, f.line, f.col) for f in ref}
    if fixture.endswith(("_fire.py", "fixture.py")):
        assert ref


# ------------------------------------------------------ fire and clean cases


JL001_FIRE = HEAD + '''
def solve(x: torch.Tensor):
    r = torch.sum(x)
    if r > 0:
        x = x / r
    while torch.any(x > 1):
        x = x * 0.5
    assert torch.isfinite(x).all()
    return x


solve = instrumented(solve, name="solve")
'''
JL001_CLEAN = HEAD + '''
def solve(x: torch.Tensor, collect: bool = False, p=None):
    r = torch.sum(x)
    if p is None and x.shape[0] > 2 and collect:
        x = x * 2
    if isinstance(x, torch.Tensor) and len(x) > 1:
        x = x + 1
    if r.item() > 0 and float(r) < 9:
        x = x / 2
    k = torch.zeros(1)
    k = 0
    while k < 3:
        k += 1
    return x


def host_only(x):
    if torch.sum(x) > 0:
        return x


solve = instrumented(solve, name="solve")
'''
JL002_FIRE = HEAD + '''
def host_read(flag: torch.Tensor) -> bool:
    return bool(flag)


def solve(x: torch.Tensor):
    a = x.sum().item()
    b = x.tolist()
    c = x.cpu()
    d = x.detach().numpy()
    torch.cuda.synchronize()
    e = float(torch.linalg.norm(x))
    L = torch.linalg.cholesky(x)
    same = torch.equal(x, L)
    while host_read(x.any()):
        x = x * 0.5
    return a, b, c, d, e, same


solve = instrumented(solve, name="solve")
'''
JL002_CLEAN = HEAD + '''
def solve(x: torch.Tensor, tol: float = 1e-6):
    n = int(x.shape[0])
    t = float(tol)
    L, info = torch.linalg.cholesky_ex(x)
    return L, n, t, np.asarray([1.0, 2.0])


def report(x):
    return x.sum().item()


solve = instrumented(solve, name="solve")
'''
JL002_DECORATED = HEAD + '''
@instrumented
def solve(x: torch.Tensor):
    return x.sum().item()


@instrumented(name="fit")
def fit(x: torch.Tensor):
    return x.tolist()
'''
JL004_FIRE = '''import torch


def widen(x):
    y = torch.zeros(3, dtype=torch.float64)
    return x.to(torch.complex128), y
'''
JL004_CLEAN = '''import numpy as np
import torch


def follow(x):
    cdt = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    if x.dtype == torch.float64:
        return x.to(torch.complex128)
    return x.to(cdt), np.zeros(3, np.float64)
'''
JL005_FIRE = HEAD + '''
def solve(x: torch.Tensor, m: torch.Tensor):
    a = torch.nonzero(m)
    b = x.unique()
    c = x[x > 0]
    d = torch.where(m)
    return a, b, c, d


solve = instrumented(solve, name="solve")
'''
JL005_CLEAN = HEAD + '''
def solve(x: torch.Tensor, m: torch.Tensor):
    return torch.where(m, x, torch.zeros_like(x)), np.unique([3, 1, 3])


def plan(m):
    return torch.nonzero(m)


solve = instrumented(solve, name="solve")
'''
JL006_SRC = '''import torch
import torch.distributed as dist


def exchange(t):
    dist.all_reduce(t)
    torch.distributed.barrier()
    return t
'''
JL012_FIRE = '''import torch


def converged(x_bf16, y_f32, a, b):
    if x_bf16 < y_f32:
        return torch.allclose(a, b)
    return False
'''
JL012_CLEAN = '''import torch


def converged(cfg, a, b):
    if cfg.coh_dtype == "bf16":
        return torch.allclose(a, b, rtol=1e-6, atol=0.0)
    return False
'''
JL013_FIRE = '''import torch


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x * w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return g * w, None


class _Short(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, z):
        return x + y + z

    @staticmethod
    def backward(ctx, g):
        return g, g


def scale(x, w):
    return _Scale.apply(x, w)
'''
JL013_CLEAN = '''import torch

SKY_COTANGENT = False
SKY_COTANGENT_ARGS = ("coh",)


class _Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tab, coh, vis, ant_p, nc, plan, damping, flag):
        ctx.save_for_backward(tab, coh, vis, ant_p)
        ctx.nc, ctx.plan = nc, plan
        return tab * coh * vis

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[2]:
            raise NotImplementedError("no visibility gradient")
        tab, coh, vis, ant_p = ctx.saved_tensors
        return ((g * coh * vis,) + (None,) * 7)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tab, idx, w):
        ctx.save_for_backward(idx)
        return tab.index_select(0, idx) * w

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        return grad, None, None


def fused(tab, coh, vis, ant_p, nc, plan, damping: float = 1e-6):
    return _Fused.apply(tab, coh, vis.detach(), ant_p, nc, plan, damping,
                        nc is not None)


def gather(tab, idx, w):
    wd = w.detach()
    return _Gather.apply(tab, idx, wd)
'''
CU_FIRE = '''#include <cuda_bf16.h>
template <typename CT>
__global__ void k(const CT* __restrict__ coh, float* out,
                  const __nv_bfloat16* b) {
  __shared__ float s[32];
  float w = 2.f;
  float y = coh[threadIdx.x] * w;
  float z = w * b[threadIdx.x];
  atomicAdd(&s[0], y);
  atomicAdd(out + 3, z);
  __nv_bfloat16 h = __hmul(b[0], b[1]);
  out[0] = y + z;
}
void launch() { k<__nv_bfloat16><<<1, 1>>>(0, 0, 0); }
'''
CU_CLEAN = '''#include <cuda_bf16.h>
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename CT>
__device__ __forceinline__ float to_f(CT x) { return x; }
template <typename CT>
__global__ void k(const CT* __restrict__ coh, float* out, int* cnt,
                  const __nv_bfloat16* b) {
  // atomicAdd(&out[0], 1.f) in a comment is no call
  float w = 2.f;
  float y = to_f(coh[threadIdx.x]) * w;
  float z = w * __bfloat162float(b[threadIdx.x]) + ld(b + 1);
  float q = static_cast<float>(b[2]) * w;
  atomicAdd(cnt, 1);
  out[threadIdx.x] = y + z + q;
}
void launch() { k<__nv_bfloat16><<<1, 1>>>(0, 0, 0, 0); }
'''
JL014_PY_FIRE = HEAD + '''
torch.backends.cuda.matmul.allow_tf32 = True


def enable(flag):
    torch.backends.cudnn.allow_tf32 = flag
    torch.set_float32_matmul_precision("high")


def solve(x: torch.Tensor, idx: torch.Tensor):
    out = torch.zeros(4)
    out.index_add_(0, idx, x)
    out.index_put_((idx,), x, accumulate=True)
    out.scatter_reduce_(0, idx, x, "sum")
    return out


solve = instrumented(solve, name="solve")
'''
JL014_PY_CLEAN = HEAD + '''
torch.backends.cuda.matmul.allow_tf32 = False


def exact():
    torch.set_float32_matmul_precision("highest")


def solve(x: torch.Tensor, idx: torch.Tensor):
    out = torch.zeros(4)
    out.index_put_((idx,), x, accumulate=False)
    out.scatter_reduce_(0, idx, x, "amin")
    counts = np.bincount(np.asarray([0, 1, 1]), np.ones(3))
    return out, counts


def offline(x, idx):
    return torch.zeros(4).index_add_(0, idx, x)


solve = instrumented(solve, name="solve")
'''

CASES = [
    ("JL001", "jl001.py", JL001_FIRE, 3),
    ("JL001", "jl001_clean.py", JL001_CLEAN, 0),
    ("JL002", "jl002.py", JL002_FIRE, 10),
    ("JL002", "jl002_clean.py", JL002_CLEAN, 0),
    ("JL002", "jl002_decorated.py", JL002_DECORATED, 2),
    ("JL004", "solvers/jl004.py", JL004_FIRE, 2),
    ("JL004", "solvers/jl004_clean.py", JL004_CLEAN, 0),
    ("JL004", "io/jl004_outside.py", JL004_FIRE, 0),
    ("JL005", "jl005.py", JL005_FIRE, 4),
    ("JL005", "jl005_clean.py", JL005_CLEAN, 0),
    ("JL006", "fleet/jl006.py", JL006_SRC, 2),
    ("JL006", "parallel/jl006_clean.py", JL006_SRC, 0),
    ("JL012", "solvers/jl012.py", JL012_FIRE, 2),
    ("JL012", "solvers/jl012_clean.py", JL012_CLEAN, 0),
    ("JL013", "jl013.py", JL013_FIRE, 2),
    ("JL013", "jl013_clean.py", JL013_CLEAN, 0),
    ("JL014", "csrc/fire.cu", CU_FIRE, 5),
    ("JL014", "csrc/clean.cu", CU_CLEAN, 0),
    ("JL014", "jl014.py", JL014_PY_FIRE, 6),
    ("JL014", "jl014_clean.py", JL014_PY_CLEAN, 0),
]


@pytest.mark.parametrize("rule,rel,text,expected", CASES,
                         ids=[c[1] for c in CASES])
def test_rule_fires_and_stays_silent(rule, rel, text, expected, tmp_path):
    found = fired(write(tmp_path, rel, text), rule)
    assert len(found) == expected, [(f.line, f.message) for f in found]
    assert all(f.rule == rule for f in found)


def test_report_only_rules_never_gate(tmp_path):
    path = write(tmp_path, "jl002.py", JL002_FIRE)
    assert lint_cli.main([path, "--rules", "JL001,JL002,JL005",
                          "--baseline", str(tmp_path / "none.json")]) == 0
    assert lint_cli.main([write(tmp_path, "jl013.py", JL013_FIRE),
                          "--baseline", str(tmp_path / "none.json")]) == 1


def test_jl013_names_the_dropped_input_and_the_arity(tmp_path):
    msgs = [f.message for f in fired(write(tmp_path, "f.py", JL013_FIRE),
                                     "JL013")]
    assert any("returns None for input `w`" in m for m in msgs)
    assert any("returns 2 gradient(s) for 3 input(s)" in m for m in msgs)


# ------------------------------------------------------------- mutations


def test_float_atomic_in_fused_cost_fires(tmp_path):
    src = open(os.path.join(PORT, "csrc", "fused_cost.cu")).read()
    body = "sum_partials_kernel("
    at = src.index("{", src.index(body)) + 1
    mutated = src[:at] + "\n  atomicAdd(out, 1.0f);" + src[at:]
    clean = write(tmp_path, "clean/fused_cost.cu", src)
    mut = write(tmp_path, "mut/fused_cost.cu", mutated)
    assert fired(clean, "JL014") == []
    found = fired(mut, "JL014")
    assert len(found) == 1 and "float atomic" in found[0].message
    assert found[0].symbol == "sum_partials_kernel"


def test_index_add_in_segment_plan_fires(tmp_path):
    src = open(os.path.join(PORT, "core", "segment.py")).read()
    old = "        return padded[self.index].sum(dim=1)\n"
    assert old in src
    mutated = src.replace(old, (
        "        return values.new_zeros((self.ndest,) + values.shape[1:])"
        ".index_add_(0, self.dest, values)\n"))
    assert fired(write(tmp_path, "clean/segment.py", src), "JL014") == []
    found = fired(write(tmp_path, "mut/segment.py", mutated), "JL014")
    assert len(found) == 1 and "index_add_" in found[0].message
    assert found[0].symbol.endswith("SegmentPlan._sum")


# ------------------------------------------------------------ reachability


@pytest.fixture(scope="module")
def package_run():
    return analyze_paths([PORT])


def test_roots_are_the_instrumented_sites_and_autograd_functions(
        package_run):
    _findings, stats, graph = package_run
    sites = sorted((fi.wrap_sites[0][0].rsplit(".", 1)[-1],
                    fi.wrap_sites[0][1])
                   for fi in graph.roots("instrumented"))
    assert len(sites) == 16, sites
    assert {m for m, _ in sites} == {
        "batched", "lbfgs", "lm", "mesh", "predict", "rime", "robust",
        "rtr", "sage", "sharded"}
    classes = {fi.qualname.rsplit(".", 1)[0]
               for fi in graph.roots("autograd")}
    assert {c.rsplit(".", 1)[-1] for c in classes} == {
        "_FusedCost", "_FusedPredict", "_FusedCostBatch", "_ImplicitSolve",
        "_SegmentSum", "_DestGather", "_GatherRows"}
    assert stats["device_roots"] == 16 + 2 * 7
    for q in ("sagecal_tpu_torch.solvers.lm.lm_solve",
              "sagecal_tpu_torch.solvers.rtr._rtr",
              "sagecal_tpu_torch.core.segment.SegmentPlan._sum"):
        assert q in graph.reachable


def test_reader_finds_every_modelled_kernel():
    from sagecal_tpu_torch.analysis import cuda, kernelmodel

    csrc = kernelmodel.default_csrc()
    for name in sorted(os.listdir(csrc)):
        if name.endswith(".cu"):
            path = os.path.join(csrc, name)
            assert set(cuda.global_names(path)) == set(
                kernelmodel.parse_source(path).kernels), name
    src = cuda.parse_cuda(os.path.join(csrc, "fused_cost.cu"))
    assert src.atomics() == [] and src.narrow_reads() == []
    assert "CT" in src.narrow and {"ld", "to_f"} <= src.converters
    loads, stores = src.accesses(src.kernels["sum_partials_kernel"])
    assert stores and {a.name for a in stores} <= {"out", "partial"}


# ----------------------------------------------------------- the machinery


def test_pragmas_suppress_by_line_and_file(tmp_path):
    line = JL014_PY_FIRE.replace(
        "out.index_add_(0, idx, x)",
        "out.index_add_(0, idx, x)  # torchlint: disable=JL014 — fixture")
    assert len(fired(write(tmp_path, "a.py", line), "JL014")) == 5
    whole = "# torchlint: disable-file=JL014\n" + JL014_PY_FIRE
    assert fired(write(tmp_path, "b.py", whole), "JL014") == []
    cu = CU_FIRE.replace("atomicAdd(&s[0], y);",
                         "atomicAdd(&s[0], y);  // torchlint: disable=JL014")
    assert len(fired(write(tmp_path, "c/fire.cu", cu), "JL014")) == 4
    jax_spelling = line.replace("torchlint", "jaxlint")
    assert len(fired(write(tmp_path, "d.py", jax_spelling), "JL014")) == 6


def test_baseline_round_trip_keeps_each_why(tmp_path):
    path = write(tmp_path, "jl002.py", JL002_FIRE)
    findings = analyze_paths([path])[0]
    bl = str(tmp_path / "bl.json")
    baseline_mod.save_baseline(bl, findings)
    data = json.load(open(bl))
    for rec in data["findings"]:
        rec["why"] = f"reason for {rec['message'][:20]}"
    json.dump(data, open(bl, "w"))
    baseline_mod.save_baseline(bl, findings)
    again = json.load(open(bl))["findings"]
    assert again and all(r["why"].startswith("reason for") for r in again)
    assert sum(r["count"] for r in again) == len(findings)
    gate = analyze_paths([write(tmp_path, "jl013.py", JL013_FIRE)])[0]
    baseline_mod.save_baseline(bl, gate)
    new, old = baseline_mod.partition(gate, baseline_mod.load_baseline(bl))
    assert new == [] and len(old) == len(gate)
    new, old = baseline_mod.partition(gate, baseline_mod.load_baseline(
        str(tmp_path / "absent.json")))
    assert len(new) == len(gate) and old == []


def test_cli_formats_and_exit_codes(tmp_path, capsys):
    fire = write(tmp_path, "jl013.py", JL013_FIRE)
    none = str(tmp_path / "none.json")
    assert lint_cli.main([fire, "--format", "json", "--baseline", none]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["summary"]["new"] == 2 and doc["stats"]["files"] == 1
    assert {f["rule"] for f in doc["findings"]} == {"JL013"}
    assert lint_cli.main([fire, "--baseline", none]) == 1
    out = capsys.readouterr().out
    assert "jl013.py:" in out and "torchlint: 2 finding(s) (2 new" in out
    bl = str(tmp_path / "bl.json")
    assert lint_cli.main([fire, "--baseline", bl, "--update-baseline"]) == 0
    assert lint_cli.main([fire, "--baseline", bl]) == 0
    assert "[baselined]" in capsys.readouterr().out
    assert lint_cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("JL001", "JL014", "JL900", "JL003", "JL015"):
        assert rid in out
    assert lint_cli.main([fire, "--rules", "JL042"]) == 2
    assert "unknown rule" in capsys.readouterr().err
    for absent in ("JL003", "JL007", "JL011", "JL015"):
        assert lint_cli.main([fire, "--rules", absent]) == 2
        assert "no counterpart" in capsys.readouterr().err
    assert lint_cli.main([str(tmp_path / "nowhere")]) == 2


def test_diag_lint_gates_and_kernel_check_runs_the_lint(tmp_path, capsys):
    from sagecal_tpu_torch.analysis import kernel_check as kc
    from sagecal_tpu_torch.obs.diag import main as diag

    bad = tmp_path / "tree"
    write(bad, "ops/jl013.py", JL013_FIRE)
    assert diag(["lint", str(bad)]) == 1
    assert diag(["lint", "--rules", "JL003"]) == 2
    assert "no counterpart" in capsys.readouterr().err
    result = kc.run_kernel_check()
    assert [v for v in result["violations"] if v["kind"] == "lint"] == []
    assert result["summary"]["lint_findings"] == 0
    csrc = tmp_path / "csrc"
    shutil.copytree(os.path.join(PORT, "csrc"), csrc)
    src = (csrc / "kbisect_b.cu").read_text()
    at = src.index("{", src.index("kbisect_b_kernel(")) + 1
    (csrc / "kbisect_b.cu").write_text(
        src[:at] + "\n  atomicAdd(out, 1.0f);" + src[at:])
    result = kc.run_kernel_check(str(csrc))
    lint = [v for v in result["violations"] if v["kind"] == "lint"]
    assert len(lint) == 1 and "JL014" in lint[0]["message"]
    assert kc.main(["--csrc", str(csrc)]) == 1


def test_fused_cost_backward_refuses_data_gradients():
    """The repair JL013 asked for: a data gradient (coherencies,
    visibilities, mask, nu) through the fused objectives raises instead
    of coming back as a silent zero on the card."""
    torch = pytest.importorskip("torch")
    from sagecal_tpu_torch.ops import rime_kernel as rk

    for fn, n in ((rk._FusedCost, 12), (rk._FusedCostBatch, 10)):
        for slot in range(2, n):
            need = tuple(i in (0, 1, slot) for i in range(n))
            ctx = types.SimpleNamespace(needs_input_grad=need)
            with pytest.raises(rk.FusedSkyGradientError):
                fn.backward(ctx, torch.ones(()))


# --------------------------------------------------------- the package gate


def test_package_gate_is_clean_and_fast(package_run):
    findings, stats, _graph = package_run
    gate = [f for f in findings if not f.report_only]
    assert gate == [], gate
    records = json.load(open(BASELINE))["findings"]
    assert records and all(r.get("why", "").strip() for r in records)
    assert all(r["rule"] in ("JL001", "JL002", "JL005", "JL012", "JL900")
               for r in records)
    known = baseline_mod.load_baseline(BASELINE)
    seen = {}
    for f in findings:
        seen[f.key()] = seen.get(f.key(), 0) + 1
    assert seen == dict(known)
    assert stats["elapsed_seconds"] < 25.0, stats


def _lint_json(argv):
    proc = subprocess.run([sys.executable] + argv, capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    doc = json.loads(proc.stdout)
    return proc.returncode, doc["findings"], doc["summary"]


def test_module_and_diag_entry_points_agree():
    a = _lint_json(["-m", "sagecal_tpu_torch.analysis", "sagecal_tpu_torch",
                    "--format", "json", "--baseline", BASELINE])
    b = _lint_json(["-m", "sagecal_tpu_torch.obs.diag", "lint", "--format",
                    "json"])
    assert a[0] == b[0] == 0
    assert a[2] == b[2] and a[2]["total"] == 0
    assert [(f["rule"], f["line"], f["message"]) for f in a[1]] == \
        [(f["rule"], f["line"], f["message"]) for f in b[1]]
    assert all(re.match(r"JL0(01|02|05)", f["rule"]) for f in a[1])
