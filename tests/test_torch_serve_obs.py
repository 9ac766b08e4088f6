"""Port vs JAX package: the serve path's observability (``obs/slo.py``,
the registry's ``export_state`` and histogram bounds, the snapshot part
of ``obs/aggregate.py``) and ``elastic/checkpoint.py::config_fingerprint``,
mirroring ``tests/test_serve_obs.py``.

Every comparison is exact: both sides are stdlib and numpy.  The SLO
monitor and ``evaluate_results`` are fed the same observations in both
packages and must give the same status dicts, events and gauges; the
fingerprint must be the same string for the same fields, since it keys
the executable cache and the buckets.  A live service run with an SLO
spec in its manifest reports the burn status the reference's
``evaluate_results`` computes from the port's result manifests.
"""

import json

import numpy as np
import pytest


class _FakeLog:
    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append(dict(kind=kind, **fields))


def _fill(reg):
    reg.counter_inc("serve_requests_total", 3, tenant="t0")
    reg.counter_inc("serve_requests_total", 2, tenant="t1", verdict="ok")
    reg.gauge_set("queue_depth", 4.0)
    reg.observe("serve_request_latency_seconds", 0.3, tenant="t0")
    reg.observe("serve_request_latency_seconds", 2.0, tenant="t0")
    reg.observe("drift", 1e-6, buckets=(1e-8, 1e-6, 1e-4))
    return reg


class TestRegistryState:
    def test_export_state_matches_jax(self):
        from sagecal_tpu.obs.registry import MetricsRegistry as JReg
        from sagecal_tpu_torch.obs.registry import MetricsRegistry

        assert _fill(MetricsRegistry()).export_state() == \
            _fill(JReg()).export_state()

    @pytest.mark.parametrize("values", [
        [], [0.5], [1e-3, 2e-3, 0.4, 0.4, 7.0, 400.0],
        list(np.geomspace(1e-4, 500.0, 37))])
    def test_quantile_bounds_match_jax(self, values):
        from sagecal_tpu.obs.registry import _Histogram as JHist
        from sagecal_tpu_torch.obs.registry import _DEFAULT_BUCKETS, _Histogram

        h, j = _Histogram(_DEFAULT_BUCKETS), JHist(_DEFAULT_BUCKETS)
        for v in values:
            h.observe(float(v))
            j.observe(float(v))
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert h.quantile_bounds(q) == j.quantile_bounds(q)
            if values:
                lo, hi = h.quantile_bounds(q)
                exact = float(np.quantile(values, q, method="inverted_cdf"))
                assert lo <= exact <= hi


class TestSnapshotFiles:
    def test_write_read_dedupe(self, tmp_path, monkeypatch):
        """A worker's second snapshot replaces its first (same path);
        a second worker adds one; dedupe keeps the newest per worker;
        the reference reads the port's files the same way."""
        from sagecal_tpu.obs.aggregate import (
            dedupe_snapshots as jdedupe, read_metrics_snapshots as jread,
        )
        from sagecal_tpu_torch.obs.aggregate import (
            dedupe_snapshots, metrics_snapshot_path, read_metrics_snapshots,
            write_metrics_snapshot,
        )
        from sagecal_tpu_torch.obs.registry import MetricsRegistry

        out = str(tmp_path)
        monkeypatch.setenv("SAGECAL_WORKER_ID", "w0")
        r = MetricsRegistry()
        r.counter_inc("serve_requests_total", 2)
        write_metrics_snapshot(metrics_snapshot_path(out), registry=r)
        r.counter_inc("serve_requests_total", 3)
        write_metrics_snapshot(metrics_snapshot_path(out), registry=r)
        monkeypatch.setenv("SAGECAL_WORKER_ID", "w1")
        r2 = MetricsRegistry()
        r2.counter_inc("serve_requests_total", 1)
        write_metrics_snapshot(metrics_snapshot_path(out), registry=r2,
                               note="x")
        docs = dedupe_snapshots(read_metrics_snapshots(out))
        assert {d["worker_id"] for d in docs} == {"w0", "w1"}
        assert docs == jdedupe(jread(out))
        totals = {d["worker_id"]: d["state"]["counters"][0]["value"]
                  for d in docs}
        assert totals == {"w0": 5.0, "w1": 1.0}
        assert [d.get("note") for d in docs] == [None, "x"]
        assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]

    def test_dedupe_keeps_the_newest_per_worker(self):
        from sagecal_tpu.obs.aggregate import dedupe_snapshots as jdedupe
        from sagecal_tpu_torch.obs.aggregate import dedupe_snapshots

        docs = [{"worker_id": "a", "ts": 3.0, "n": 1},
                {"worker_id": "b", "ts": 1.0, "n": 2},
                {"worker_id": "a", "ts": 2.0, "n": 3},
                {"pid": 7, "ts": 0.5, "n": 4}]
        assert dedupe_snapshots(docs) == jdedupe(docs)
        assert [d["n"] for d in dedupe_snapshots(docs)] == [4, 2, 1]

    def test_corrupt_snapshot_skipped(self, tmp_path):
        from sagecal_tpu_torch.obs.aggregate import read_metrics_snapshots

        (tmp_path / "metrics-x.json").write_text("{not json")
        (tmp_path / "metrics-y.json").write_text('{"kind": "no state"}')
        assert read_metrics_snapshots(str(tmp_path)) == []


FINGERPRINTS = [
    dict(use_f64=True, use_fused_predict=False, coh_dtype="f32",
         collect=False, solver_mode=1, max_emiter=1, max_iter=2,
         max_lbfgs=4, lbfgs_m=7, nulow=2.0, nuhigh=30.0, randomize=True),
    dict(app="serve", tenant="t0",
         requests=[("r0", "/d/x.h5", 0, 2, "vis"), ("r1", "/d/x.h5", 2, 2,
                                                   "vis")],
         use_f64=False),
    dict(a=1.5, b=None, c=[1, 2, {"d": "e"}], f=np.float32(0.1)),
]


@pytest.mark.parametrize("i", range(len(FINGERPRINTS)))
def test_config_fingerprint_equals_jax(i):
    from sagecal_tpu.elastic.checkpoint import config_fingerprint as jfp
    from sagecal_tpu_torch.elastic.checkpoint import config_fingerprint

    assert config_fingerprint(**FINGERPRINTS[i]) == jfp(**FINGERPRINTS[i])


def test_merge_sage_config_matches_jax():
    """Request knobs over the service defaults: the same SageConfig
    fields and the same fingerprint string in both packages."""
    import dataclasses

    from sagecal_tpu.apps.config import ServeConfig as JCfg
    from sagecal_tpu.serve.request import SolveRequest as JReq
    from sagecal_tpu.serve.service import _merge_sage_config as jmerge
    from sagecal_tpu_torch.apps.config import ServeConfig
    from sagecal_tpu_torch.serve.request import SolveRequest
    from sagecal_tpu_torch.serve.service import _merge_sage_config

    req = dict(request_id="r0", tenant="t", dataset="d.h5",
               sky_model="s.txt", t0=0, tilesz=2, solver_mode=2,
               max_lbfgs=6, nulow=3.0)
    for cfg in (dict(), dict(use_f64=False, use_fused_predict=True),
                dict(use_f64=False, use_fused_predict=True,
                     coh_dtype="bf16", randomize=False)):
        scfg, fp = _merge_sage_config(ServeConfig(**cfg), SolveRequest(**req))
        jscfg, jfp = jmerge(JCfg(**cfg), JReq(**req))
        assert fp == jfp
        assert dataclasses.asdict(scfg) == dataclasses.asdict(jscfg)


class TestSLO:
    @staticmethod
    def _specs(mod, **kw):
        kw.setdefault("tenant", "t0")
        kw.setdefault("deadline_s", 1.0)
        return mod.SLOSpec(**kw)

    def test_spec_validation_and_loading(self, tmp_path):
        import sagecal_tpu.obs.slo as jslo
        from sagecal_tpu_torch.obs import slo

        for bad in (dict(deadline_s=0.0), dict(availability=1.0)):
            with pytest.raises(ValueError):
                self._specs(slo, **bad)
        s = self._specs(slo, windows_s=(600.0, 300.0))
        assert s.windows_s == (300.0, 600.0)
        assert s.error_budget == pytest.approx(0.01)
        path = tmp_path / "slo.json"
        path.write_text(json.dumps({"slos": [
            {"tenant": "t0", "deadline_s": 2.0, "availability": 0.95},
            {"tenant": "t1", "deadline_s": 5.0, "windows_s": [60, 10]}]}))
        got = slo.load_slo_specs(str(path))
        want = jslo.load_slo_specs(str(path))
        assert {k: vars(v) for k, v in got.items()} == \
            {k: vars(v) for k, v in want.items()}
        man = tmp_path / "plain.json"
        man.write_text(json.dumps({"requests": []}))
        assert slo.load_slo_specs(str(man)) == {}
        dup = tmp_path / "dup.json"
        dup.write_text(json.dumps([{"tenant": "t", "deadline_s": 1},
                                   {"tenant": "t", "deadline_s": 2}]))
        with pytest.raises(ValueError, match="duplicate"):
            slo.load_slo_specs(str(dup))

    @pytest.mark.parametrize("stream", ["burn_and_recover", "blip",
                                        "fast_burn"])
    def test_monitor_matches_jax(self, stream):
        """The same observation stream through both monitors: the same
        status dicts, alert events and gauges at every evaluation."""
        import sagecal_tpu.obs.slo as jslo
        from sagecal_tpu.obs.registry import MetricsRegistry as JReg
        from sagecal_tpu_torch.obs import slo
        from sagecal_tpu_torch.obs.registry import MetricsRegistry

        t0 = 1000.0
        windows = (10.0, 1000.0) if stream == "blip" else (10.0, 60.0)
        if stream == "burn_and_recover":
            obs = [(t0 + i, 5.0, "ok") for i in range(10)] + \
                [(t0 + 100 + i, 0.1, "ok") for i in range(20)]
            evals = [t0 + 10, t0 + 11, t0 + 160]
        elif stream == "blip":
            obs = [(t0 + i, 0.1, "ok") for i in range(200)] + \
                [(t0 + 200 + i, 5.0, "diverged") for i in range(5)]
            evals = [t0 + 205]
        else:
            obs = [(t0 + i, 9.0, "diverged") for i in range(10)]
            evals = [t0 + 10]
        sides = []
        for mod, Reg in ((slo, MetricsRegistry), (jslo, JReg)):
            mon = mod.SLOMonitor({"t0": self._specs(
                mod, availability=0.9, windows_s=windows)})
            elog, reg, out = _FakeLog(), Reg(), []
            i = 0
            for now in evals:
                while i < len(obs) and obs[i][0] <= now:
                    mon.observe("t0", *obs[i])
                    i += 1
                out.append(mon.evaluate(now=now, elog=elog, registry=reg))
            out.append(mon.shed_recommended("t0", now=evals[-1]))
            sides.append((out, elog.events, reg.export_state()))
        assert sides[0] == sides[1]
        if stream == "burn_and_recover":
            assert [e["state"] for e in sides[0][1]] == ["firing", "cleared"]

    def test_evaluate_results_and_report_match_jax(self):
        import sagecal_tpu.obs.slo as jslo
        from sagecal_tpu_torch.obs import slo

        results = []
        for i in range(6):
            for t, lat in (("slow", 1.0), ("fast", 1.0), ("x", 3.0)):
                results.append({"tenant": t, "completed_at": 100.0 + i,
                                "latency_s": lat,
                                "verdict": "ok" if i % 3 else "diverged"})
        outs = []
        for mod in (slo, jslo):
            specs = {"slow": self._specs(mod, tenant="slow", deadline_s=0.01,
                                         availability=0.9),
                     "fast": self._specs(mod, tenant="fast",
                                         deadline_s=60.0, availability=0.5)}
            evals = mod.evaluate_results(specs, results)
            outs.append((evals, mod.format_slo_report(evals),
                         mod.evaluate_results(specs, results, now=103.0)))
        assert outs[0] == outs[1]
        assert slo.format_slo_report([]) == jslo.format_slo_report([])


def test_service_run_reports_slo_status(tmp_path):
    """A manifest carrying ``"slos"``: the service's summary holds the
    status the reference's ``evaluate_results`` gives on the port's own
    result manifests (one deadline impossible, one easy)."""
    from sagecal_tpu.obs.slo import evaluate_results, load_slo_specs
    from sagecal_tpu_torch.apps.config import ServeConfig
    from sagecal_tpu_torch.serve.request import load_requests
    from sagecal_tpu_torch.serve.service import CalibrationService
    from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

    manifest = make_synthetic_workload(str(tmp_path / "w"), 4, n_tenants=2,
                                       device="cpu")
    doc = json.load(open(manifest))
    doc["slos"] = [{"tenant": "tenant0", "deadline_s": 1e-4},
                   {"tenant": "tenant1", "deadline_s": 600.0}]
    with open(manifest, "w") as f:
        json.dump(doc, f)
    cfg = ServeConfig(requests=manifest, out_dir=str(tmp_path / "out"),
                      batch=2)
    summary = CalibrationService(cfg, log=lambda *a: None,
                                 device="cpu").run(load_requests(manifest))
    status = {s["tenant"]: s for s in summary["slo"]}
    assert status["tenant0"]["burning"] and status["tenant0"][
        "shed_recommended"]
    assert not status["tenant1"]["burning"]
    posthoc = {s["tenant"]: s for s in evaluate_results(
        load_slo_specs(manifest), summary["results"])}
    for t in ("tenant0", "tenant1"):
        assert posthoc[t]["burning"] == status[t]["burning"]
        assert posthoc[t]["window_counts"] == status[t]["window_counts"]
