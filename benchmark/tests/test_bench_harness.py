"""The yardstick's pieces on the CPU: the frozen work counts against hand
counts, the import check, the trace reduction and the metric readers on
a made-up trace, and BENCHMARK.json against the files it names."""

from __future__ import annotations

import json
import os
import re

import numpy as np

import pytest

from benchmark.harness import check, devtrace, work
from benchmark.harness.cell import LayerContext, load_module, read_metric
from benchmark.tests.tiny import BENCH, ROOT


def test_work_counts_match_hand_counts():
    # M 2 clusters, 1 chunk, N 3 stations, F 1 channel, 10 rows
    tables = 2 * 4 * 2 * 3 * 4  # re and im, 4 entries, M x N, float32
    coh = 2 * 1 * 8 * 10 * 4
    idx = 2 * 10 * 4
    vis, mask, nu = 8 * 10 * 4, 10 * 4, 4
    w = work.fused_cost(2, 1, 3, 1, 10)
    assert w["fwd"] == (tables + coh + idx + vis + mask + nu + 4,
                        128 * 2 * 10 + 40 * 10)
    assert w["bwd"] == (tables + coh + idx + vis + mask + nu + tables,
                        384 * 2 * 10 + 80 * 10)
    assert work.fused_predict(2, 1, 3, 2, 10) == (
        tables + 2 * coh + idx + 2 * 8 * 10 * 4, 128 * 2 * 2 * 10)
    # hybrid chunks add the chunk map
    assert work.fused_predict(2, 2, 3, 1, 10)[0] == (
        2 * tables + coh + idx + 2 * 10 * 4 + 8 * 10 * 4)
    assert work.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 67e12) == pytest.approx(1.0)


def test_the_import_check_compares_whole_top_level_names():
    mods = ["sagecal_tpu_torch", "sagecal_tpu_torch.ops.rime", "torch",
            "jaxtyping", "flaxen", "sagecal_tpu", "sagecal_tpu.ops.rime",
            "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    assert check.banned_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "sagecal_tpu",
        "sagecal_tpu.ops.rime"]


def _trace():
    # us: app copy, [coh: 2 kernels], gap, [solve: #3, #4 x3], gap, #1;
    # all on stream 7
    ev = [("Memcpy HtoD", 0, 10), ("spin_kernel(long)", 10, 1),
          ("void (anonymous namespace)::coh_a(int)", 12, 8),
          ("coh_b", 30, 10), ("spin_kernel(long)", 40, 1),
          ("spin_kernel(long)", 100, 1),
          ("void (anonymous namespace)::fused_cost_fwd_kernel<float>(T)",
           101, 20),
          ("void (anonymous namespace)::fused_cost_cot_kernel<float>(T)",
           150, 10),
          ("void (anonymous namespace)::fused_cost_grad_kernel<float>(T)",
           160, 30),
          ("void (anonymous namespace)::sum_partials_kernel(float*)", 190,
           5),
          ("spin_kernel(long)", 195, 1),
          ("void (anonymous namespace)::fused_predict_fwd_kernel<float>(T)",
           300, 40)]
    marks = [("coherencies", "begin"), ("coherencies", "end"),
             ("solve", "begin"), ("solve", "end")]
    return [e + (7,) for e in ev], marks


def test_reduce_trace_attributes_layers_and_labels_gaps():
    ev, marks = _trace()
    red = devtrace.reduce_trace(ev, marks, window_s=400e-6)
    assert red.markers == (4, 4)
    assert red.busy_s == pytest.approx(133e-6)
    assert red.layer_busy_s == pytest.approx({"coherencies": 18e-6,
                                              "solve": 65e-6})
    assert red.op_counts["fused_cost_fwd_kernel<float>"] == 1
    # 10-12 opens coh (app), 20-30 in coh, 40-101 opens solve (app),
    # 121-150 in solve, 195-300 after the layers (app)
    assert [g[0] for g in red.gaps] == ["app", "coherencies", "app",
                                        "solve", "app"]
    assert [g[1] for g in red.gaps] == pytest.approx([2e-6, 10e-6, 61e-6,
                                                      29e-6, 105e-6])
    b = devtrace.breakdown(red)
    assert b["idle_gaps"][0] == ["app", pytest.approx(168e-6)]
    assert b["device_ops"][0] == ["fused_predict_fwd_kernel<float>",
                                  pytest.approx(40e-6)]


def test_operations_on_another_stream_belong_to_no_layer():
    ev, marks = _trace()
    # a copy on stream 9 inside the coherency layer's markers: busy, but
    # no layer's; the layers keep their times
    ev.append(("Memcpy DtoH", 22, 4, 9))
    red = devtrace.reduce_trace(ev, marks, window_s=400e-6)
    assert red.layer_busy_s == pytest.approx({"coherencies": 18e-6,
                                              "solve": 65e-6})
    assert red.op_counts["Memcpy DtoH"] == 1
    assert red.busy_s == pytest.approx(137e-6)  # 22-26 was idle


def test_a_trace_that_would_misattribute_layers_raises():
    ev, marks = _trace()
    with pytest.raises(ValueError, match="4 layer markers in the trace, 3"):
        devtrace.reduce_trace(ev, marks[:3], window_s=400e-6)
    moved = [e if i != 4 else e[:3] + (9,) for i, e in enumerate(ev)]
    with pytest.raises(ValueError, match="markers on 2 streams"):
        devtrace.reduce_trace(moved, marks, window_s=400e-6)


def _read(name, ctx):
    return load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                       "m_" + name.replace(".", "_")).read(ctx)


def test_readers_on_a_made_up_trace():
    ev, marks = _trace()
    red = devtrace.reduce_trace(ev, marks, window_s=400e-6)
    sh = dict(M=2, N=3, rows=1000, F=2, nc=1)
    ctx = LayerContext(reduction=red, spans={"solve": [1.0, 3.0]}, tiles=2,
                       shapes=sh)
    assert _read("coh_device_s_per_tile", ctx) == pytest.approx(9e-6)
    assert _read("solve_device_s_per_tile", ctx) == pytest.approx(32.5e-6)
    assert _read("solve_wall_s_per_tile", ctx) == pytest.approx(2.0)
    assert _read("idle_share", ctx) == pytest.approx(100 * (1 - 133 / 400))
    # a quantity split by cells is read by the file of its first part
    assert read_metric(BENCH, "idle_share.lofar_hba_62st", ctx) == \
        _read("idle_share", ctx)
    w = work.fused_cost(2, 1, 3, 1, 1000)
    least = work.least_seconds(*w["fwd"]) + work.least_seconds(*w["bwd"])
    assert _read("fused_cost_roofline", ctx) == pytest.approx(
        100 * least / 65e-6)
    least1 = work.least_seconds(*work.fused_predict(2, 1, 3, 2, 1000))
    assert _read("fused_predict_roofline", ctx) == pytest.approx(
        100 * least1 / 40e-6)
    empty = LayerContext(reduction=None, spans={}, tiles=0, shapes=sh)
    for name in ("coh_device_s_per_tile", "solve_device_s_per_tile",
                 "solve_wall_s_per_tile", "idle_share",
                 "fused_cost_roofline", "fused_predict_roofline"):
        assert _read(name, empty) is None
    no_kernels = devtrace.reduce_trace(ev[:5], marks[:2], 1e-4)
    ctx = LayerContext(reduction=no_kernels, spans={}, tiles=1, shapes=sh)
    assert _read("fused_cost_roofline", ctx) is None
    assert _read("fused_predict_roofline", ctx) is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_benchmark_json_names_only_files_that_exist():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    assert spec["command"] == ["python3", "-m", "benchmark.run"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["reduced"]) <= set(cfg) and "assumed" in cfg
        names.add(c["name"])
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        with open(os.path.join(BENCH, "mixes", f"{w['traffic']}.json")) as f:
            mix = json.load(f)
        assert os.path.exists(os.path.join(BENCH, "drivers",
                                           f"{mix['driver']}.py"))
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           f"{w['name']}.json"))
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert os.path.exists(os.path.join(
            BENCH, "metrics", f"{m['name'].split('.')[0]}.py"))
        # every cell it lists reports the end-to-end metric it moves
        moved = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                    m["workloads"]))


def test_a_seed_draws_only_the_noise_of_one_observation(tmp_path):
    from sagecal_tpu_torch.io.memh5 import remove

    from benchmark.harness.inputs import make_observation, read_solutions
    from benchmark.tests.tiny import TINY

    with open(os.path.join(BENCH, "configs", "lofar_hba_62st.json")) as f:
        cfg = dict(json.load(f), **TINY)
    obs = {}
    for name, seed in (("a", 3000000001), ("b", 3000000001),
                       ("c", 3000000002)):
        d = tmp_path / name
        d.mkdir()
        o = make_observation(cfg, 2, seed, "cpu", str(d))
        obs[name] = (o, o.read("vis", 0, o.ntime),
                     read_solutions(o.truth_path, o.nstations),
                     open(o.sky_path).read(), open(o.cluster_path).read())
    (a, va, ga, sa, ca), (b, vb, gb, sb, cb), (c, vc, gc, sc, cc) = (
        obs["a"], obs["b"], obs["c"])
    assert (va == vb).all() and sa == sb and (ga == gb).all()
    # another seed: the same sky, clusters, stations and gains, in the
    # same order; only the noise differs
    assert sa == sc and ca == cc and (ga == gc).all()
    assert (a.u == c.u).all() and (a.ant_p == c.ant_p).all()
    assert not (va == vc).all()
    sigma = cfg["noise_jy"]
    diff = (va.astype(np.complex128) - vc).ravel()
    assert np.std(diff.real) == pytest.approx(sigma * np.sqrt(2), rel=0.1)
    for o in (a, b, c):
        remove(o.path)
