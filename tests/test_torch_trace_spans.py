"""The port's spans and host-read counts inside the tile solve and the app
loop (``obs/trace.py``, ``apps/fullbatch.py``, ``solvers/``): a tiny
calibration on the CPU records the tree ``tile > solve > sage.em >
sage.em.cluster > read:lm.done``, as many ``read:lm.done`` spans as the
LM loops made stopping tests, ``sage.em``/``sage.lbfgs`` on the stamps
of ``SageResult.phase_seconds``; off, it records nothing and writes no
file; under a ``torch.profiler`` capture it keeps its record in memory
and writes no file; a ``record_function`` opened inside a span nests in
it on the profiler's clock; ``diag roofline``'s gaps by span."""

import gzip
import json
import math
import os

import numpy as np
import pytest
import torch

from sagecal_tpu_torch.obs import trace as tracemod

SKY = """P1 0 0 0.0 51 0 0.0 2.0 0 0 0 0 0 0 0 0 0 0 150e6
P2 0 2 0.0 50 30 0.0 1.0 0 0 0 0 0 0 0 0 0 0 150e6
"""
CLUSTER = "1 1 P1\n2 1 P2\n"


@pytest.fixture(autouse=True)
def _clean_tracer(monkeypatch):
    for k in ("SAGECAL_TRACE", "SAGECAL_TRACE_LOG", "SAGECAL_TELEMETRY",
              "SAGECAL_EVENT_LOG", "SAGECAL_PROFILE_DIR"):
        monkeypatch.delenv(k, raising=False)
    tracemod.close_tracer()
    tracemod.set_trace(None)
    monkeypatch.setattr(tracemod, "_LAST", None)
    yield
    tracemod.close_tracer()
    tracemod.set_trace(None)


@pytest.fixture()
def work(tmp_path, monkeypatch):
    """7 stations, 2 clusters, 4 timeslots of 2 channels in a ``vis.h5``
    (two tiles of 2); the working directory is the test's own."""
    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.skymodel import load_sky

    d = tmp_path / "run"
    d.mkdir()
    (d / "t.sky.txt").write_text(SKY)
    (d / "t.sky.txt.cluster").write_text(CLUSTER)
    dec0 = math.radians(51.0)
    clusters, _, _ = load_sky(str(d / "t.sky.txt"),
                              str(d / "t.sky.txt.cluster"), 0.0, dec0,
                              dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    jones = (np.eye(2)[None, None] + 0.15 * (
        rng.standard_normal((2, 7, 2, 2))
        + 1j * rng.standard_normal((2, 7, 2, 2))))
    simulate_dataset(str(d / "t.h5"), nstations=7, ntime=4, nchan=2,
                     clusters=clusters, jones=torch.as_tensor(jones),
                     noise_sigma=1e-3,
                     seed=1, dec0=dec0, device="cpu")
    import h5py

    with h5py.File(str(d / "t.h5"), "r+") as f:
        f.attrs["ra0"] = 0.0
        f.attrs["dec0"] = dec0
    monkeypatch.chdir(d)
    return d


def _cfg(work, **kw):
    from sagecal_tpu_torch.apps.config import RunConfig

    args = dict(dataset=str(work / "t.h5"),
                sky_model=str(work / "t.sky.txt"),
                cluster_file=str(work / "t.sky.txt.cluster"),
                out_solutions=str(work / "t.sol"), tilesz=2, max_emiter=2,
                max_iter=3, max_lbfgs=4, lbfgs_m=5, solver_mode=3)
    args.update(kw)
    return RunConfig(**args)


def _count_done_tests(monkeypatch):
    """Every LM loop's stopping tests, counted from its iterations and
    bound: one a step taken, and one more where it stopped early."""
    from sagecal_tpu_torch.solvers import lm, robust, sage

    real = lm.lm_solve
    made = []

    def counted(*a, **kw):
        res = real(*a, **kw)
        config = a[7] if len(a) > 7 else kw.get("config", lm.LMConfig())
        bound = config.itmax
        if kw.get("itmax_dynamic") is not None:
            bound = min(bound, int(kw["itmax_dynamic"]))
        made.append(res.iterations + (1 if res.iterations < bound else 0))
        return res

    for mod in (lm, robust, sage):
        monkeypatch.setattr(mod, "lm_solve", counted)
    return made


def _keep_results(monkeypatch):
    from sagecal_tpu_torch.apps import fullbatch

    real = fullbatch.solve_tile
    outs = []

    def keep(*a, **kw):
        outs.append(real(*a, **kw))
        return outs[-1]

    monkeypatch.setattr(fullbatch, "solve_tile", keep)
    return outs


def _files(d):
    return sorted(p for p in os.listdir(d))


def _ancestors(by_id, s):
    out = []
    while s.get("parent_id") in by_id:
        s = by_id[s["parent_id"]]
        out.append(s["name"])
    return out


@pytest.mark.parametrize("mode", [1, 3])
def test_a_run_under_a_profiler_keeps_its_spans_and_reads(work, monkeypatch,
                                                          mode):
    from torch.profiler import ProfilerActivity, profile

    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch

    made = _count_done_tests(monkeypatch)
    outs = _keep_results(monkeypatch)
    before = _files(work)
    with profile(activities=[ProfilerActivity.CPU]):
        results = run_fullbatch(_cfg(work, solver_mode=mode),
                                log=lambda *a: None, device="cpu")
    assert len(results) == 2
    # kept in memory: no span file, no Chrome trace
    assert _files(work) == sorted(before + ["t.sol"])
    assert tracemod.get_tracer() is tracemod._NULL
    rec = tracemod.last_record()
    assert rec is not None
    spans = rec.spans
    by_id = {s["span_id"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert names.count("tile") == 2 and names.count("fullbatch") == 1
    assert names.count("sage.em") == names.count("sage.lbfgs") == 2
    assert names.count("sage.em.cluster") == 2 * 2 * 2  # tiles, passes, k
    # the tree: tile > solve > sage.em > sage.em.cluster > read:lm.done
    done = [s for s in spans if s["name"] == "read:lm.done"]
    assert done
    for s in done:
        assert _ancestors(by_id, s)[:4] == ["sage.em.cluster", "sage.em",
                                            "solve", "tile"]
    clusters = [s for s in spans if s["name"] == "sage.em.cluster"]
    assert sorted(s["attrs"]["k"] for s in clusters) == [0] * 4 + [1] * 4
    assert all(isinstance(s["attrs"]["iterations"], int) for s in clusters)
    # as many reads as the LM loops made stopping tests; the counts agree
    assert len(done) == sum(made) == rec.counts["lm.done"]
    for site, n in rec.counts.items():
        assert names.count(f"read:{site}") == n, site
    for site in ("sage.nerr", "lm.solve_check", "fullbatch.readback",
                 "fullbatch.solutions", "fullbatch.residual"):
        assert rec.counts.get(site, 0) > 0, site
    assert rec.counts["fullbatch.readback"] == 2
    # the solve's phase seconds are the spans' stamps
    for which in ("em", "lbfgs"):
        got = [s["dur"] for s in spans if s["name"] == f"sage.{which}"]
        want = [o.phase_seconds[which] for o in outs]
        assert got == pytest.approx(want, rel=1e-9, abs=1e-9)
    # every child inside its parent on the one clock
    for s in spans:
        p = by_id.get(s["parent_id"])
        if p is not None:
            assert p["ts"] <= s["ts"] + 1e-6
            assert s["ts"] + s["dur"] <= p["ts"] + p["dur"] + 1e-6


def test_off_records_nothing_and_writes_nothing(work, monkeypatch):
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch

    seen = []
    real = tracemod.get_tracer

    def watch():
        seen.append(real())
        return seen[-1]

    monkeypatch.setattr(tracemod, "get_tracer", watch)
    before = _files(work)
    off = run_fullbatch(_cfg(work), log=lambda *a: None, device="cpu")
    assert tracemod.last_record() is None
    assert _files(work) == sorted(before + ["t.sol"])
    assert seen and all(t is tracemod._NULL for t in seen)
    assert tracemod.host_read("lm.done") is tracemod._NULL_SPAN
    # forced off, a profiler capture records nothing either, and the
    # results are the same bits
    tracemod.set_trace(False)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        again = run_fullbatch(_cfg(work), log=lambda *a: None, device="cpu")
    assert tracemod.last_record() is None and again == off


def test_trace_env_writes_the_record_at_close(work, monkeypatch):
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch

    monkeypatch.setenv("SAGECAL_TRACE", "1")
    monkeypatch.setenv("SAGECAL_TRACE_LOG", str(work / "s.jsonl"))
    monkeypatch.setenv("SAGECAL_TELEMETRY", "1")
    monkeypatch.setenv("SAGECAL_EVENT_LOG", str(work / "ev.jsonl"))
    run_fullbatch(_cfg(work), log=lambda *a: None, device="cpu")
    rec = tracemod.last_record()
    spans = tracemod.read_spans(str(work / "s.jsonl"))
    assert [s["span_id"] for s in spans] == [s["span_id"] for s in rec.spans]
    assert os.path.exists(work / "s.trace.json")
    # tile_done carries the solve's EM and LBFGS seconds in phase_seconds
    from sagecal_tpu_torch.obs.events import read_events

    done = [e for e in read_events(str(work / "ev.jsonl"))
            if e["type"] == "tile_done"]
    assert len(done) == 2
    for e in done:
        ph = e["phase_seconds"]
        assert {"sage.em", "sage.lbfgs", "solve", "app.readback",
                "app.solutions", "residual", "app.write"} <= set(ph)
        assert ph["sage.em"] + ph["sage.lbfgs"] <= ph["solve"] + 1e-6
    ems = [s["dur"] for s in spans if s["name"] == "sage.em"]
    assert [e["phase_seconds"]["sage.em"] for e in done] == \
        pytest.approx(ems, rel=1e-9, abs=1e-9)


def test_a_record_function_inside_a_span_nests_on_the_shared_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = tracemod.Tracer(None, trace_id="t")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with record_function("inner_range"):
                torch.ones(64).sum()
    span, = tr.record().spans
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "inner_range"]
    start_ns = int(round(span["ts"] * 1e9))
    end_ns = int(round((span["ts"] + span["dur"]) * 1e9))
    # float seconds of a Unix-epoch stamp hold ~0.24 us
    assert start_ns - 1000 <= ev.start_ns() <= ev.end_ns() <= end_ns + 1000
    assert tr.path is None and tr.counts == {}


def test_host_read_counts_by_site_and_nests():
    tr = tracemod.configure_tracer(capture=True)
    assert isinstance(tr, tracemod.Tracer) and tr.path is None
    with tr.span("sage.em"):
        for _ in range(3):
            with tracemod.host_read("lm.done"):
                pass
        with tracemod.host_read("sage.nerr"):
            pass
    tracemod.close_tracer()
    rec = tracemod.last_record()
    assert rec.counts == {"lm.done": 3, "sage.nerr": 1}
    em, = [s for s in rec.spans if s["name"] == "sage.em"]
    reads = [s for s in rec.spans if s["name"].startswith("read:")]
    assert len(reads) == 4
    assert all(s["parent_id"] == em["span_id"] for s in reads)
    # a later run that records nothing leaves no record behind
    assert tracemod.configure_tracer() is None
    assert tracemod.last_record() is None


def _kineto(path, base_ns, ops):
    """A Kineto-style trace: device ops (name, ts us relative to
    ``base_ns``, dur us) on one stream."""
    doc = {"baseTimeNanoseconds": base_ns,
           "traceEvents": [{"ph": "X", "cat": "kernel", "name": n,
                            "pid": 0, "tid": 7, "ts": ts, "dur": dur}
                           for n, ts, dur in ops]}
    with gzip.open(path, "wt") as f:
        json.dump(doc, f)


def test_gaps_by_the_innermost_span_over_them(tmp_path):
    from sagecal_tpu_torch.obs.devprof import attribute_trace, idle_by_span

    base_ns = 1_790_000_000_000_000_000
    # device busy 0-10, 20-30, 100-110, 130-140 us after base; gaps
    # 10-20, 30-100 and 110-130
    _kineto(str(tmp_path / "k.trace.json.gz"), base_ns,
            [("k1", 0.0, 10.0), ("k2", 20.0, 10.0), ("k3", 100.0, 10.0),
             ("k4", 130.0, 10.0)])
    t0 = base_ns * 1e-9  # spans in Unix seconds
    us = 1e-6
    spans = [
        {"name": "tile", "span_id": "a", "ts": t0 + 5 * us, "dur": 150 * us},
        {"name": "sage.em", "span_id": "b", "parent_id": "a",
         "ts": t0 + 15 * us, "dur": 80 * us},
        {"name": "read:lm.done", "span_id": "c", "parent_id": "b",
         "ts": t0 + 40 * us, "dur": 30 * us},
    ]
    att = attribute_trace(str(tmp_path / "k.trace.json.gz"),
                          gap_threshold_us=0.0, program_spans=spans)
    by = att["dispatch"]["gaps_by_span"]
    # 10-15 tile, 15-20 em; 30-40 em, 40-70 read, 70-95 em, 95-100 tile;
    # 110-130 tile
    assert by == pytest.approx({"tile": 30 * us, "sage.em": 40 * us,
                                "read:lm.done": 30 * us}, abs=1e-9)
    assert sum(by.values()) == pytest.approx(
        att["dispatch"]["gap_total_us"] * 1e-6, abs=1e-9)
    # without spans the report is as it was; gaps under no span
    assert "gaps_by_span" not in attribute_trace(
        str(tmp_path / "k.trace.json.gz"), gap_threshold_us=0.0)["dispatch"]
    assert idle_by_span([(0.0, 5.0)], []) == {"(none)": pytest.approx(5e-6)}
    # diag roofline --spans prints them from a span file
    from sagecal_tpu_torch.obs.diag import main

    tr = tracemod.Tracer(str(tmp_path / "s.jsonl"))
    for s in spans:
        tr.add_span(s["name"], s["dur"], start_unix=s["ts"],
                    parent_id=s.get("parent_id") or "")
    tr.close()
    assert main(["roofline", str(tmp_path / "k.trace.json.gz"), "--spans",
                 str(tmp_path / "s.jsonl"), "--gap-threshold-us", "0"]) == 0


def test_a_file_tracer_appends_in_batches_and_keeps_no_more(tmp_path,
                                                           monkeypatch):
    """With a path the tracer holds at most ``FLUSH_SPANS`` finished spans:
    it appends each full batch to the file, reads them back for its
    record, and writes the rest at close."""
    monkeypatch.setattr(tracemod, "FLUSH_SPANS", 4)
    path = str(tmp_path / "s.jsonl")
    tr = tracemod.Tracer(path, trace_id="t")
    with tr.span("run"):
        for i in range(9):
            with tr.read("lm.done"):
                pass
    # 10 spans: two batches of 4 written, 2 held
    assert len(tracemod.read_spans(path)) == 8 and len(tr._done) == 2
    rec = tr.record()
    assert [s["name"] for s in rec.spans] == ["read:lm.done"] * 9 + ["run"]
    assert [s["seq"] for s in rec.spans] == list(range(10))
    assert rec.counts == {"lm.done": 9}
    # another writer's lines in the same file are not this tracer's
    other = tracemod.Tracer(path, trace_id="u")
    with other.span("elsewhere"):
        pass
    other.close()
    tr.close()
    spans = tracemod.read_spans(path)
    assert [s["name"] for s in spans] == (["read:lm.done"] * 8
                                          + ["elsewhere", "read:lm.done",
                                             "run"])
    assert [s["seq"] for s in tr.record().spans] == list(range(10))
    with open(tmp_path / "s.trace.json") as f:
        assert len([e for e in json.load(f)["traceEvents"]
                    if e["ph"] == "X"]) == 11


def test_the_crash_handlers_close_the_tracer(tmp_path, monkeypatch):
    from sagecal_tpu_torch.obs import flight

    monkeypatch.setenv("SAGECAL_TRACE", "1")
    path = str(tmp_path / "s.jsonl")
    tr = tracemod.configure_tracer(run_id="r", path=path)
    with tr.span("tile"):
        with tracemod.host_read("lm.done"):
            pass
    assert not os.path.exists(path)
    flight._run_crash_flushers()  # what SIGTERM and the excepthook run
    assert [s["name"] for s in tracemod.read_spans(path)] == [
        "read:lm.done", "tile"]
    assert os.path.exists(tmp_path / "s.trace.json")
    assert tracemod.last_record().counts == {"lm.done": 1}


def test_a_block_that_raises_ends_its_span(work, monkeypatch):
    """The solve's spans end, marked with the error, when their block
    raises: nothing is left open, and the spans around it end too."""
    from torch.profiler import ProfilerActivity, profile

    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch
    from sagecal_tpu_torch.solvers import lbfgs, robust, sage

    tr = tracemod.configure_tracer(capture=True)
    calls = []

    def cost(x):
        calls.append(1)
        if len(calls) > 2:
            raise FloatingPointError("cost")
        return (x * x).sum()

    with pytest.raises(FloatingPointError):
        lbfgs.lbfgs_fit(cost, None, torch.ones(4, dtype=torch.float64),
                        itmax=5, M=3)
    assert tr._stack() == []
    with tr.span("after"):
        pass
    tracemod.close_tracer()
    by = {s["name"]: s for s in tracemod.last_record().spans}
    assert by["lbfgs.iter"]["attrs"]["error"] == "FloatingPointError"
    assert by["after"]["parent_id"] is None

    # the second cluster solve of a calibration fails
    real, solves = robust.robust_lm_solve, []

    def failing(*a, **kw):
        solves.append(1)
        if len(solves) == 2:
            with tracemod.host_read("lm.done"):
                raise ValueError("solve")
        return real(*a, **kw)

    monkeypatch.setattr(sage, "robust_lm_solve", failing)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            run_fullbatch(_cfg(work), log=lambda *a: None, device="cpu")
    spans = tracemod.last_record().spans
    by_id = {s["span_id"]: s for s in spans}
    read, = [s for s in spans if s["name"] == "read:lm.done"
             and (s.get("attrs") or {}).get("error")]
    chain = [read] + [by_id[i] for i in _ancestor_ids(by_id, read)]
    assert [s["name"] for s in chain] == [
        "read:lm.done", "sage.em.cluster", "sage.em", "solve", "tile",
        "fullbatch"]
    assert all(s["attrs"]["error"] == "ValueError" for s in chain)
    assert not [s for s in spans if s["name"] == "sage.lbfgs"]


def _ancestor_ids(by_id, s):
    out = []
    while s.get("parent_id") in by_id:
        out.append(s["parent_id"])
        s = by_id[s["parent_id"]]
    return out
