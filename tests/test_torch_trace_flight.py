"""Port vs JAX package: the span tracer (``obs/trace.py``) and the flight
recorder (``obs/flight.py``), mirroring ``tests/test_trace_obs.py``:
span trees, the Chrome-trace export, the straggler math, the disabled
path, the flight ring, heartbeat and hang watchdog, and the crash
handlers (excepthook and SIGTERM).

Parity: both packages get the same span sequence under one patched
clock (``time.time``/``time.monotonic`` from a counter) and write the
same span JSONL and ``trace.json``, record for record; the straggler
gauges agree on the same band seconds (the median of an even count
averages the two middle values, as ``jnp.median``).  The apps: the
fullbatch app and the service with ``SAGECAL_TRACE=1`` write the same
span names, kinds and parent structure in both packages.  Each test
that waits on a thread or a subprocess has its own short timeout.
"""

import itertools
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from sagecal_tpu_torch.obs import flight as flightmod
from sagecal_tpu_torch.obs import trace as tracemod
from sagecal_tpu_torch.obs.events import EventLog, read_events
from sagecal_tpu_torch.obs.flight import FlightRecorder, format_dump, read_dump
from sagecal_tpu_torch.obs.trace import (
    Tracer, aggregate_by_name, band_attribution, band_seconds_from_spans,
    build_span_tree, critical_path, format_straggler_table, read_spans,
    straggler_stats, to_chrome_trace,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset(tm, fm):
    tm.close_tracer()
    tm.set_trace(None)
    fm.reset_flight_recorder()
    fm.set_flight(None)
    fm.uninstall_crash_handlers()
    fm._EVENT_LOGS.clear()


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """The tracers, recorders and crash handlers of both packages are
    process-global: every test starts and ends clean."""
    from sagecal_tpu.obs import flight as jflight
    from sagecal_tpu.obs import trace as jtrace

    for pair in ((tracemod, flightmod), (jtrace, jflight)):
        _reset(*pair)
    yield
    for pair in ((tracemod, flightmod), (jtrace, jflight)):
        _reset(*pair)


# ---------------------------------------------------------------------------
# span trees and the Chrome trace


class TestSpanTree:
    def test_nested_spans_form_tree(self, tmp_path):
        p = str(tmp_path / "spans.jsonl")
        tr = Tracer(p, trace_id="rid123")
        with tr.span("run", kind="run"):
            with tr.span("tile", tile=0):
                with tr.span("band", band=0):
                    pass
                with tr.span("band", band=1):
                    pass
        tr.close()
        spans = read_spans(p)
        assert len(spans) == 4
        assert all(s["trace_id"] == "rid123" for s in spans)
        by_name = {}
        for s in spans:
            by_name.setdefault(s["name"], []).append(s)
        run, = by_name["run"]
        tile, = by_name["tile"]
        assert run["parent_id"] is None
        assert tile["parent_id"] == run["span_id"]
        assert all(b["parent_id"] == tile["span_id"] for b in by_name["band"])
        roots, children = build_span_tree(spans)
        assert [r["name"] for r in roots] == ["run"]
        assert len(children[tile["span_id"]]) == 2
        assert run["dur"] >= tile["dur"] >= sum(
            b["dur"] for b in by_name["band"])
        assert [s["name"] for s in critical_path(spans)][:2] == ["run", "tile"]
        assert aggregate_by_name(spans)["band"]["count"] == 2

    def test_unbalanced_exit_truncates_stack(self, tmp_path):
        p = str(tmp_path / "spans.jsonl")
        tr = Tracer(p)
        outer = tr.span("outer").__enter__()
        tr.span("inner").__enter__()  # never exited
        outer.__exit__(None, None, None)
        assert tr.current_span_id() is None
        with tr.span("next"):
            pass
        tr.close()
        nxt = [s for s in read_spans(p) if s["name"] == "next"]
        assert nxt and nxt[0]["parent_id"] is None

    def test_error_exit_tags_span(self, tmp_path):
        p = str(tmp_path / "spans.jsonl")
        tr = Tracer(p)
        with pytest.raises(RuntimeError):
            with tr.span("boom"):
                raise RuntimeError("x")
        tr.close()
        s, = read_spans(p)
        assert s["attrs"]["error"] == "RuntimeError"

    def test_add_span_synthetic_parenting(self, tmp_path):
        p = str(tmp_path / "spans.jsonl")
        tr = Tracer(p)
        admm_id = tr.add_span("admm", 2.0, kind="admm")
        for b, s in enumerate((1.25, 0.75)):
            tr.add_span("admm.band", s, parent_id=admm_id, band=b,
                        synthetic=True)
        tr.close()
        spans = read_spans(p)
        assert all(s["parent_id"] == admm_id for s in spans
                   if s["name"] == "admm.band")
        assert band_seconds_from_spans(spans) == {0: 1.25, 1: 0.75}


class TestChromeTrace:
    def test_roundtrip_loadable(self, tmp_path):
        p = str(tmp_path / "spans.jsonl")
        tr = Tracer(p, trace_id="rid")
        with tr.span("run"):
            with tr.span("band", band=3, lane="band3"):
                pass
        tr.close()
        chrome = tracemod.default_chrome_path(p)
        with open(chrome) as f:
            doc = json.load(f)
        x = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
        assert len(x) == 2
        assert all(e["dur"] >= 0.0 and e["ts"] >= 0.0 for e in x)
        assert any(e["name"] == "process_name" for e in meta)
        assert any(e["name"] == "thread_name"
                   and e["args"]["name"] == "band3" for e in meta)
        band = [e for e in x if e["name"] == "band"][0]
        assert band["args"]["parent_id"] and band["args"]["trace_id"] == "rid"

    def test_empty_input(self):
        assert to_chrome_trace([]) == {"traceEvents": [],
                                       "displayTimeUnit": "ms"}


def _patched_clock(monkeypatch):
    """time.time / time.time_ns / time.monotonic from one deterministic
    counter."""
    tick = itertools.count()
    monkeypatch.setattr(time, "time", lambda: 1.7e9 + 0.25 * next(tick))
    monkeypatch.setattr(time, "time_ns", lambda: (
        1_700_000_000_000_000_000 + 250_000_000 * next(tick)))
    monkeypatch.setattr(time, "monotonic", lambda: 100.0 + 0.25 * next(tick))


# the stamps each package takes from its own clocks: the port stamps a
# span's start and end with time.time_ns (obs/trace.py::clock_ns), the
# JAX package with time.time and time.monotonic
_CLOCKED = ("ts", "dur", "mono")
_SYNTHETIC = ("admm", "admm.band", "serve.request")


def _unclocked(records, keys=_CLOCKED):
    return [{k: v for k, v in r.items() if k not in keys} for r in records]


def _span_script(tr):
    with tr.span("run", kind="run", tiles=2):
        for t in range(2):
            with tr.span("tile", kind="tile", tile=t):
                with tr.span("solve", kind="phase"):
                    pass
                rid = tr.add_span("admm", 1.5, kind="admm")
                for b, s in enumerate(band_attribution(1.5, [2.0, 1.0, 0.0])):
                    tr.add_span("admm.band", s, parent_id=rid, band=b,
                                lane=f"band{b}", synthetic=True)
        with pytest.raises(ValueError):
            with tr.span("boom", kind="phase"):
                raise ValueError("x")
    root = tr.allocate_span_id()
    tr.add_span("serve.request", 3.0, parent_id="", start_unix=1.7e9,
                trace_id="req1", span_id=root, verdict="ok")


def test_same_span_sequence_same_files_as_jax(tmp_path, monkeypatch):
    from sagecal_tpu.obs import trace as jtrace

    out = {}
    for name, mod in (("jax", jtrace), ("port", tracemod)):
        _patched_clock(monkeypatch)  # each package from the same start
        path = str(tmp_path / f"{name}.jsonl")
        tr = mod.Tracer(path, trace_id="run1")
        _span_script(tr)
        tr.close()
        with open(mod.default_chrome_path(path)) as f:
            out[name] = (read_spans(path), json.load(f))
    (jspans, jchrome), (tspans, tchrome) = out["jax"], out["port"]
    assert len(tspans) == len(jspans) == 15
    # the span ids come from per-tracer counters and the process id, so
    # in one process even they agree; every field but the clocks' stamps
    assert _unclocked(tspans) == _unclocked(jspans)
    assert ([e for e in tchrome["traceEvents"] if e["ph"] != "X"]
            == [e for e in jchrome["traceEvents"] if e["ph"] != "X"])
    assert (_unclocked([e for e in tchrome["traceEvents"] if e["ph"] == "X"],
                       ("ts", "dur"))
            == _unclocked([e for e in jchrome["traceEvents"]
                           if e["ph"] == "X"], ("ts", "dur")))
    assert band_seconds_from_spans(tspans) == {0: 2.0, 1: 1.0, 2: 0.0}
    # given seconds are kept as given; the port's live spans are whole
    # ticks of its one clock, each inside its parent on that clock
    by_id = {s["span_id"]: s for s in tspans}
    for t, j in zip(tspans, jspans):
        if t["name"] in _SYNTHETIC:
            assert t["dur"] == j["dur"]
            continue
        assert t["dur"] / 0.25 == pytest.approx(round(t["dur"] / 0.25))
        assert t["dur"] > 0.0
        parent = by_id.get(t["parent_id"])
        if parent is not None:
            assert parent["ts"] <= t["ts"]
            assert t["ts"] + t["dur"] <= parent["ts"] + parent["dur"] + 1e-6


# ---------------------------------------------------------------------------
# straggler attribution


class TestStragglerAttribution:
    def test_band_attribution_exact_sum(self):
        out = band_attribution(7.3, [3.0, 1.0, 0.0, 2.0])
        assert len(out) == 4
        assert sum(out) == pytest.approx(7.3, rel=1e-12)
        assert out[2] == 0.0
        assert out[0] == pytest.approx(7.3 * 3.0 / 6.0)

    def test_band_attribution_uniform_fallback(self):
        out = band_attribution(2.0, [0.0, 0.0, -1.0, 0.0])
        assert sum(out) == pytest.approx(2.0, rel=1e-12)
        assert out[:3] == [0.5, 0.5, 0.5]
        assert band_attribution(1.0, []) == []

    def test_straggler_stats_detection(self):
        stats = straggler_stats([1.0, 1.0, 1.0, 10.0], ratio_thresh=1.5)
        assert stats["detected"] and stats["argmax"] == 3
        assert stats["ratio"] == pytest.approx(10.0)
        assert stats["median"] == pytest.approx(1.0)
        assert not straggler_stats([1.0, 1.01, 0.99], ratio_thresh=1.5)[
            "detected"]
        assert not straggler_stats([5.0], ratio_thresh=1.5)["detected"]
        assert not straggler_stats([], ratio_thresh=1.5)["detected"]

    def test_threshold_env(self, monkeypatch):
        monkeypatch.setenv("SAGECAL_STRAGGLER_RATIO", "4.0")
        assert tracemod.straggler_ratio_threshold() == 4.0
        assert not straggler_stats([1.0, 1.0, 3.0])["detected"]
        assert straggler_stats([1.0, 1.0, 9.0])["detected"]

    def test_format_straggler_table(self):
        txt = format_straggler_table({0: 1.0, 1: 1.0, 2: 9.0},
                                     ratio_thresh=1.5)
        assert "STRAGGLER DETECTED" in txt and "<-- straggler" in txt
        assert "balanced" in format_straggler_table({0: 1.0, 1: 1.0},
                                                    ratio_thresh=1.5)
        assert "no per-band spans" in format_straggler_table({})

    @pytest.mark.parametrize("secs", [
        [1.0, 2.0, 3.0, 10.0], [4.0, 1.0], [0.5, 0.5, 0.7, 0.2, 3.0],
        [2.0, 2.0, 2.0, 2.0], [0.0, 0.0, 1.0], [3.0]])
    def test_gauges_match_jax(self, secs):
        """Even counts average the two middle values ([1, 2, 3, 10]:
        median 2.5, ratio 4), as the JAX package's jnp.median."""
        from sagecal_tpu.obs import trace as jtrace
        from sagecal_tpu.parallel.consensus import band_imbalance as jbi
        from sagecal_tpu_torch.parallel.consensus import band_imbalance

        want = jtrace.straggler_stats(secs, ratio_thresh=1.5)
        got = straggler_stats(secs, ratio_thresh=1.5)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
        r, s, a = band_imbalance(secs)
        jr, js, ja = jbi(secs)
        assert (r, s, a) == pytest.approx((float(jr), float(js), int(ja)),
                                          rel=1e-12)
        assert (jtrace.format_straggler_table(dict(enumerate(secs)), 1.5)
                == format_straggler_table(dict(enumerate(secs)), 1.5))


# ---------------------------------------------------------------------------
# the disabled path


class TestDisabledPath:
    def test_null_tracer_shared_and_silent(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        tracemod.set_trace(False)
        tr = tracemod.get_tracer()
        assert tr is tracemod._NULL and not tr.enabled
        assert tr.span("a", x=1) is tr.span("b")
        with tr.span("a"):
            pass
        assert tr.add_span("a", 1.0) is None
        assert tracemod.configure_tracer(run_id="r") is None
        assert list(tmp_path.iterdir()) == []

    def test_flight_disabled_no_recorder(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        flightmod.set_flight(False)
        assert flightmod.get_flight_recorder() is None
        flightmod.note_activity("span", name="x")
        assert list(tmp_path.iterdir()) == []

    def test_env_enables(self, monkeypatch, tmp_path):
        monkeypatch.setenv("SAGECAL_TRACE", "1")
        monkeypatch.setenv("SAGECAL_TRACE_LOG", str(tmp_path / "t.jsonl"))
        assert tracemod.trace_enabled()
        tr = tracemod.get_tracer()
        assert isinstance(tr, Tracer)
        with tr.span("x"):
            pass
        tracemod.close_tracer()
        assert len(read_spans(str(tmp_path / "t.jsonl"))) == 1
        assert os.path.exists(str(tmp_path / "t.trace.json"))


# ---------------------------------------------------------------------------
# the flight recorder


class TestFlightRecorder:
    def test_ring_is_bounded(self, tmp_path):
        fr = FlightRecorder(heartbeat_path=str(tmp_path / "hb"),
                            dump_path=str(tmp_path / "d.json"),
                            ring_size=8, stall_seconds=1e6)
        for i in range(50):
            fr._append("tick", name=f"t{i}")
        snap = fr.snapshot()
        assert len(snap) == 8 and snap[-1]["name"] == "t49"

    def test_watchdog_dumps_on_stall_then_resolves(self, tmp_path):
        hb = str(tmp_path / "hb.json")
        dump = str(tmp_path / "flight_dump.json")
        fr = FlightRecorder(heartbeat_path=hb, dump_path=dump,
                            ring_size=32, stall_seconds=0.3, run_id="wd1")
        fr.record("phase", name="warmup")
        fr.start(poll_seconds=0.05)
        try:
            deadline = time.monotonic() + 15.0
            while not os.path.exists(dump) and time.monotonic() < deadline:
                time.sleep(0.05)
            assert os.path.exists(dump), "watchdog never dumped on stall"
            doc = read_dump(dump)
            assert doc["reason"] == "stall" and doc["run_id"] == "wd1"
            assert "MainThread" in [t["name"] for t in doc["threads"]]
            assert all(t["stack"] for t in doc["threads"])
            kinds = [e["kind"] for e in doc["ring"]]
            assert "phase" in kinds and "hang_detected" in kinds
            assert os.path.exists(hb)
            fr.record("phase", name="resumed")
            assert "stall_resolved" in [e["kind"] for e in fr.snapshot()]
        finally:
            fr.stop()
        final = json.load(open(hb))
        assert final["closed"] is True and final["run_id"] == "wd1"

    def test_heartbeat_written_on_record(self, tmp_path):
        hb = str(tmp_path / "hb.json")
        fr = FlightRecorder(heartbeat_path=hb,
                            dump_path=str(tmp_path / "d.json"),
                            stall_seconds=1e6, run_id="hb1")
        fr.record("span", name="s")
        doc = json.load(open(hb))
        assert doc["pid"] == os.getpid() and doc["run_id"] == "hb1"
        assert doc["closed"] is False

    def test_dump_is_readable(self, tmp_path):
        dump = str(tmp_path / "d.json")
        fr = FlightRecorder(heartbeat_path=str(tmp_path / "hb"),
                            dump_path=dump, stall_seconds=1e6, run_id="dd")
        fr.record("phase", name="p0")
        fr.dump("manual")
        doc = read_dump(dump)
        out = format_dump(doc)
        assert "reason=manual" in out and "MainThread" in out
        assert "ring buffer" in out
        assert doc["schema_version"] == 2 and doc["writer"]

    def test_device_state_never_initializes_cuda(self, tmp_path):
        """In a fresh process that imported torch but never touched CUDA,
        the dump's device state says so and leaves CUDA uninitialized."""
        code = ("import json, torch\n"
                "from sagecal_tpu_torch.obs import flight\n"
                "st = flight._device_state()\n"
                "print(json.dumps([st, torch.cuda.is_initialized()]))\n")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=90, cwd=REPO)
        assert r.returncode == 0, r.stderr
        st, initialized = json.loads(r.stdout.strip().splitlines()[-1])
        assert st == {"torch_imported": True, "cuda_initialized": False}
        assert initialized is False
        doc = {"device_state": st, "ts": 0}
        assert "CUDA not initialized" in format_dump(doc)
        assert "torch not imported" in format_dump(
            {"device_state": {"torch_imported": False}})


# ---------------------------------------------------------------------------
# crash handlers


class TestCrashHandlers:
    def test_excepthook_dumps_and_flushes_event_log(self, tmp_path,
                                                    monkeypatch):
        monkeypatch.setenv("SAGECAL_HEARTBEAT_FILE", str(tmp_path / "hb"))
        monkeypatch.setenv("SAGECAL_FLIGHT_DUMP",
                           str(tmp_path / "flight_dump.json"))
        flightmod.set_flight(True)
        flightmod.get_flight_recorder(run_id="crash1")
        seen = []
        monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a))
        flightmod.install_crash_handlers()
        elp = str(tmp_path / "ev.jsonl")
        elog = EventLog(elp, run_id="crash1")
        flightmod.register_event_log(elog)
        try:
            raise ValueError("boom")
        except ValueError:
            sys.excepthook(*sys.exc_info())
        assert seen, "the previous excepthook was not called"
        dump = json.load(open(tmp_path / "flight_dump.json"))
        assert dump["reason"] == "uncaught_exception"
        assert dump["exception"]["type"] == "ValueError"
        assert "boom" in dump["exception"]["value"]
        ab = [e for e in read_events(elp) if e["type"] == "run_aborted"]
        assert ab and ab[0]["reason"].startswith("uncaught_exception")
        assert ab[0]["flight_dump"] == str(tmp_path / "flight_dump.json")
        assert elog.closed

    def test_install_is_idempotent_and_uninstalls(self, monkeypatch):
        monkeypatch.setattr(sys, "excepthook", lambda *a: None)
        prev = sys.excepthook
        flightmod.install_crash_handlers()
        flightmod.install_crash_handlers()
        assert sys.excepthook is flightmod._excepthook
        assert flightmod._PREV_EXCEPTHOOK is prev
        flightmod.uninstall_crash_handlers()
        assert sys.excepthook is prev

    def test_crash_flushers_run_and_reap_prefetchers(self, monkeypatch):
        import sagecal_tpu_torch.io.dataset as ds

        calls = []
        monkeypatch.setattr(ds, "cancel_active_prefetchers",
                            lambda: calls.append("reaped"))

        def flusher():
            calls.append("flushed")

        def broken():
            raise RuntimeError("a flusher never masks the crash")

        flightmod.register_crash_flusher(broken)
        flightmod.register_crash_flusher(flusher)
        try:
            flightmod._run_crash_flushers()
        finally:
            flightmod.unregister_crash_flusher(broken)
            flightmod.unregister_crash_flusher(flusher)
        assert calls == ["flushed", "reaped"]

    def test_sigterm_subprocess_dump_and_abort_event(self, tmp_path):
        """A SIGTERM'd run leaves a flight dump and a run_aborted event,
        and still dies with the SIGTERM exit status."""
        elp = str(tmp_path / "ev.jsonl")
        dump = str(tmp_path / "flight_dump.json")
        script = tmp_path / "victim.py"
        script.write_text(textwrap.dedent("""\
            import os, signal, sys
            import torch
            from sagecal_tpu_torch.obs.events import EventLog
            from sagecal_tpu_torch.obs import flight as fl
            assert "jax" not in sys.modules
            fl.install_crash_handlers()
            fl.get_flight_recorder(run_id="victim")
            elog = EventLog(os.environ["ELOG"], run_id="victim")
            fl.register_event_log(elog)
            elog.emit("started")
            os.kill(os.getpid(), signal.SIGTERM)
            raise SystemExit("unreachable: SIGTERM must kill the process")
        """))
        env = dict(os.environ,
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   SAGECAL_FLIGHT="1", ELOG=elp,
                   SAGECAL_HEARTBEAT_FILE=str(tmp_path / "hb"),
                   SAGECAL_FLIGHT_DUMP=dump)
        r = subprocess.run([sys.executable, str(script)], env=env,
                           capture_output=True, timeout=90)
        assert r.returncode == -signal.SIGTERM, (r.returncode, r.stderr)
        doc = json.load(open(dump))
        assert doc["reason"] == "sigterm"
        assert doc["device_state"]["torch_imported"] is True
        assert doc["threads"] and all(t["stack"] for t in doc["threads"])
        evs = read_events(elp)
        assert [e["type"] for e in evs] == ["started", "run_aborted"]
        assert evs[-1]["reason"] == "sigterm"
        assert evs[-1]["flight_dump"] == dump


# ---------------------------------------------------------------------------
# the apps with SAGECAL_TRACE=1


def _shape(spans):
    """Span names, kinds and parents' names, sorted (ids and times
    differ between runs)."""
    by_id = {s["span_id"]: s for s in spans}
    return sorted((s["name"], (s.get("attrs") or {}).get("kind"),
                   by_id[s["parent_id"]]["name"]
                   if s.get("parent_id") in by_id else None)
                  for s in spans)


# the port's app phases that are the reference's, under the reference's
# names; the port's other spans (the reader's wait, the solutions, the
# solve's inner spans and the host reads) have no counterpart
_JAX_PHASES = {"fullbatch": "fullbatch", "tile": "tile",
               "coherencies": "load+coh", "solve": "solve",
               "app.readback": "solve-wait", "residual": "residual",
               "app.write": "write"}


_SOLVE_SPANS = ("sage.", "lbfgs.", "read:")


def _as_jax(spans):
    return [dict(s, name=_JAX_PHASES[s["name"]]) for s in spans
            if s["name"] in _JAX_PHASES]


def test_fullbatch_spans_match_jax(tmp_path, monkeypatch):
    """The fullbatch app traced: a ``fullbatch`` run span, a ``tile`` span
    per tile and the PhaseTimer's phases under them, in both packages
    (the port's under their own names, beside its own spans);
    tracing leaves the port's results as they were; the flight recorder
    leaves its closing heartbeat."""
    import shutil

    import numpy as np

    from sagecal_tpu.apps.config import RunConfig as JCfg
    from sagecal_tpu.apps.fullbatch import run_fullbatch as jrun
    from sagecal_tpu.io.simulate import random_jones
    from sagecal_tpu_torch.apps.config import RunConfig
    from sagecal_tpu_torch.apps.fullbatch import run_fullbatch
    from test_apps import CLUSTER, SKY, _make_dataset

    (tmp_path / "s.txt").write_text(SKY)
    (tmp_path / "s.txt.cluster").write_text(CLUSTER)
    jones = random_jones(2, 7, seed=3, amp=0.15, dtype=np.complex128)
    _make_dataset(tmp_path / "j.h5", ntime=4, nchan=2, jones=jones)
    shutil.copy(tmp_path / "j.h5", tmp_path / "t.h5")
    common = dict(sky_model=str(tmp_path / "s.txt"),
                  cluster_file=str(tmp_path / "s.txt.cluster"), tilesz=2,
                  max_emiter=1, max_iter=2, max_lbfgs=4, solver_mode=1)
    off = run_fullbatch(RunConfig(dataset=str(tmp_path / "t.h5"),
                                  out_solutions=str(tmp_path / "off.sol"),
                                  **common), log=lambda *a: None, device="cpu")
    monkeypatch.setenv("SAGECAL_TRACE", "1")
    monkeypatch.setenv("SAGECAL_FLIGHT", "1")
    monkeypatch.setenv("SAGECAL_HEARTBEAT_FILE", str(tmp_path / "hb"))
    monkeypatch.setenv("SAGECAL_TRACE_LOG", str(tmp_path / "j.jsonl"))
    jrun(JCfg(dataset=str(tmp_path / "j.h5"),
              out_solutions=str(tmp_path / "j.sol"), **common),
         log=lambda *a: None)
    monkeypatch.setenv("SAGECAL_TRACE_LOG", str(tmp_path / "t.jsonl"))
    on = run_fullbatch(RunConfig(dataset=str(tmp_path / "t.h5"),
                                 out_solutions=str(tmp_path / "on.sol"),
                                 **common), log=lambda *a: None, device="cpu")
    assert on == off
    assert open(tmp_path / "on.sol").read() == open(tmp_path / "off.sol").read()
    tspans = read_spans(str(tmp_path / "t.jsonl"))
    jspans = read_spans(str(tmp_path / "j.jsonl"))
    assert _shape(_as_jax(tspans)) == _shape(jspans)
    names = [s["name"] for s in tspans]
    assert names.count("tile") == 2 and names.count("fullbatch") == 1
    assert {"app.prefetch_wait", "coherencies", "solve", "app.readback",
            "app.solutions", "residual", "app.write", "sage.em",
            "sage.em.cluster", "sage.lbfgs", "lbfgs.iter", "sage.finalize",
            "read:lm.done", "read:fullbatch.readback",
            "read:fullbatch.solutions", "read:fullbatch.residual"
            } <= set(names)
    with open(tmp_path / "t.trace.json") as f:
        assert len([e for e in json.load(f)["traceEvents"]
                    if e["ph"] == "X"]) == len(tspans)
    hb = json.load(open(tmp_path / "hb"))
    assert hb["closed"] is True


def test_service_lifecycle_spans_match_jax(tmp_path, monkeypatch):
    """``SAGECAL_TRACE=1`` on the service: one trace per request, a
    ``serve.request`` root whose id is in the result manifest and its
    phase chain, as the JAX package writes them."""
    from sagecal_tpu.apps.config import ServeConfig as JCfg
    from sagecal_tpu.apps.serve import run_serve as jserve
    from sagecal_tpu.serve.request import load_requests as jload
    from sagecal_tpu.serve.synthetic import make_synthetic_workload
    from sagecal_tpu_torch.apps.config import ServeConfig
    from sagecal_tpu_torch.apps.serve import run_serve
    from sagecal_tpu_torch.serve.request import load_requests

    manifest = make_synthetic_workload(str(tmp_path / "w"), 3, n_tenants=1)
    monkeypatch.setenv("SAGECAL_TRACE", "1")
    runs = {}
    for name, run, cfg, load, kw in (
            ("jax", jserve, JCfg, jload, {}),
            ("port", run_serve, ServeConfig, load_requests,
             {"device": "cpu"})):
        monkeypatch.setenv("SAGECAL_TRACE_LOG", str(tmp_path / f"{name}.jsonl"))
        summary = run(cfg(out_dir=str(tmp_path / name), batch=2,
                          max_emiter=1, max_iter=2, max_lbfgs=4),
                      requests=load(manifest), log=lambda *a: None, **kw)
        runs[name] = (summary, read_spans(str(tmp_path / f"{name}.jsonl")))
    (jsum, jspans), (tsum, tspans) = runs["jax"], runs["port"]
    # the port's solve spans and host reads have no counterpart
    inner = [s for s in tspans if s["name"].startswith(_SOLVE_SPANS)]
    assert {"sage.em", "sage.em.cluster", "sage.lbfgs", "read:lm.done"} <= {
        s["name"] for s in inner}
    tspans = [s for s in tspans if not s["name"].startswith(_SOLVE_SPANS)]
    assert _shape(tspans) == _shape(jspans)
    roots = [s for s in tspans if s["name"] == "serve.request"]
    assert len(roots) == 3
    for r in tsum["results"]:
        root, = [s for s in roots if s["span_id"] == r["span_id"]]
        assert root["trace_id"] == r["trace_id"]
        kids = sorted(s["name"] for s in tspans
                      if s["parent_id"] == root["span_id"])
        assert kids == sorted(["enqueue", "schedule", "pack", "execute",
                               "unpack", "write_manifest",
                               "cache_hit" if "cache_hit" in kids
                               else "compile"])
        assert sum(s["dur"] for s in tspans
                   if s["parent_id"] == root["span_id"]) <= root["dur"] + 1e-6
