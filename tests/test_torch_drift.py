"""Port vs JAX package: shadow auditing and the drift ledger
(``obs/shadow.py``, ``obs/drift.py``), mirroring ``tests/test_drift.py``.

The sampler picks the same request ids as the reference's (the same
crc32 of the seeded id; the reference's pinned sets); the metrics, the
verdicts, the tolerance table and the ledger validation give the
reference's results on the same inputs (exactly: both are numpy); the
aggregation's quantile bounds contain the exact maxima and equal the
reference's.  Then live runs of the port's service on a synthetic
workload (f64, the "xla" route): at ``shadow_rate`` 1 one valid record
per request, verdict "ok" (the re-solve takes the same route with the
same generator, so its drift is 0); an injected drift is caught; rate 0
builds no auditor, writes no ledger and gives byte-identical solutions.
"""

import json
import os

import numpy as np
import pytest


class _FakeLog:
    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append(dict(kind=kind, **fields))


class TestSampler:
    def test_pinned_sample_sets_match_jax(self):
        from sagecal_tpu.obs.shadow import shadow_sampled as jsampled
        from sagecal_tpu_torch.obs.shadow import shadow_sampled

        ids = [f"req{i:03d}" for i in range(10)]
        assert [r for r in ids if shadow_sampled(r, 0.5, 0)] == \
            ["req002", "req003", "req006", "req007"]
        assert [r for r in ids if shadow_sampled(r, 0.3, 0)] == \
            ["req002", "req006"]
        assert [r for r in ids if shadow_sampled(r, 0.5, 1)] == \
            ["req000", "req001", "req004", "req005", "req008", "req009"]
        more = [f"{p}{i:02d}" for p in "ab" for i in range(40)]
        for rate in (0.0, 0.1, 0.25, 0.9, 1.0, 2.0):
            for seed in (0, 3):
                assert [shadow_sampled(r, rate, seed) for r in more] == \
                    [jsampled(r, rate, seed) for r in more]

    def test_budget_exhaustion_is_counted_not_queued(self, tmp_path):
        from sagecal_tpu_torch.obs.shadow import ShadowAuditor

        with ShadowAuditor(str(tmp_path), rate=1.0, budget_s=0.0,
                           log=lambda *a: None) as aud:
            assert not aud.wants("req000")
            assert aud.sampled == 1 and aud.budget_skipped == 1
        stats = aud.stats()
        assert stats["budget_skipped"] == 1 and stats["audited"] == 0


CASES = [
    dict(shape=(2, 1, 24), shift=None, res=(0.5, 0.5), chi2=(10.0, 10.0)),
    dict(shape=(2, 1, 32), shift=(2, 0.25), res=(1.0, 1.0), chi2=None),
    dict(shape=(3, 2, 40), shift=(4, 1e-4), res=(0.3, 0.30001),
         chi2=(5.0, 5.002)),
]


class TestMetricsAndPolicy:
    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_metrics_and_verdicts_match_jax(self, case):
        from sagecal_tpu.obs.shadow import compute_drift_metrics as jmetrics
        from sagecal_tpu.obs.shadow import drift_verdict as jverdict
        from sagecal_tpu_torch.obs.shadow import (
            compute_drift_metrics, drift_verdict,
        )

        c = CASES[case]
        rng = np.random.default_rng(case)
        p_ref = rng.normal(size=c["shape"])
        p_prod = p_ref.copy()
        if c["shift"] is not None:
            s, d = c["shift"]
            p_prod[..., 8 * s:8 * s + 8] += d
        chi2 = c["chi2"] or (None, None)
        args = (p_prod, p_ref, *c["res"], *chi2)
        got, want = compute_drift_metrics(*args), jmetrics(*args)
        assert got == want
        for pair in ("xla/f32|xla/f32", "fused/f32|xla/f32",
                     "fused_batch/bf16|xla/f32", "gpu/tf32|xla/f32"):
            assert drift_verdict(got, pair) == jverdict(want, pair)

    def test_per_station_attribution(self):
        from sagecal_tpu_torch.obs.shadow import compute_drift_metrics

        rng = np.random.default_rng(7)
        p_ref = rng.normal(size=(2, 1, 4 * 8))  # 4 stations
        p_prod = p_ref.copy()
        p_prod[..., 2 * 8:3 * 8] += 0.25  # station 2 only
        m = compute_drift_metrics(p_prod, p_ref, 1.0, 1.0, None, None)
        sta = m["gain_rel_err_station"]
        assert np.argmax(sta) == 2
        assert sta[0] == sta[1] == sta[3] == 0.0
        expected = 0.25 / np.abs(
            p_ref.reshape(2, 1, 4, 8)[:, :, 2, :]).max()
        assert np.isclose(sta[2], expected)
        assert "chi2_rel_delta" not in m

    def test_tolerance_table_is_the_references(self):
        from sagecal_tpu.obs.shadow import DRIFT_TOLERANCES as JTOL
        from sagecal_tpu_torch.obs.drift import DRIFT_METRICS
        from sagecal_tpu_torch.obs.shadow import (
            DRIFT_TOLERANCES, lookup_tolerances, path_pair,
        )

        assert DRIFT_TOLERANCES == JTOL
        for kp in ("fused", "fused_batch"):
            f32 = DRIFT_TOLERANCES[path_pair(kp, "f32")]
            bf16 = DRIFT_TOLERANCES[path_pair(kp, "bf16")]
            assert all(bf16[m] > f32[m] for m in DRIFT_METRICS)
        assert lookup_tolerances("gpu/tf32|xla/f32") == \
            DRIFT_TOLERANCES["default"]


def _row(i=0, verdict="ok", **kw):
    from sagecal_tpu_torch.obs.shadow import DRIFT_KIND, DRIFT_SCHEMA_VERSION

    row = {
        "schema_version": DRIFT_SCHEMA_VERSION, "kind": DRIFT_KIND,
        "ts": 100.0 + i, "request_id": f"req{i:03d}",
        "path_pair": "xla/f32|xla/f32", "kernel_path": "xla",
        "kernel_path_reason": "fused predict disabled in config",
        "bucket": "N7xB42xT2xC1xM2", "coh_dtype": "f32",
        "solver_dtype": "float64", "cost_rel_delta": 1e-6,
        "gain_rel_err_max": 2e-6, "chi2_rel_delta": 3e-6,
        "verdict": verdict, "reasons": [], "shadow_s": 0.1,
    }
    row.update(kw)
    return row


LEDGERS = {
    "valid": [_row(0), _row(1, bucket="N8xB56xT2xC1xM2")],
    "empty": [],
    "structural": [dict(_row(0), shadow_s=-1.0, schema_version=99)],
    "lying": [_row(0, gain_rel_err_max=0.4)],
    "honest": [_row(1, gain_rel_err_max=0.4, verdict="drift_exceeded")],
    "unknown_verdict": [_row(2, verdict="maybe")],
}


class TestLedger:
    @pytest.mark.parametrize("name", list(LEDGERS))
    def test_validate_matches_jax(self, name):
        from sagecal_tpu.obs.shadow import validate_drift as jvalidate
        from sagecal_tpu_torch.obs.shadow import validate_drift

        assert validate_drift(LEDGERS[name]) == jvalidate(LEDGERS[name])

    def test_read_skips_corrupt_and_foreign_lines(self, tmp_path):
        from sagecal_tpu.obs.shadow import read_drift as jread
        from sagecal_tpu_torch.obs.shadow import read_drift, validate_drift

        path = tmp_path / "drift.jsonl"
        with open(path, "w") as f:
            f.write(json.dumps(_row(1)) + "\n")
            f.write('{"kind": "other_stream", "ts": 1}\n')
            f.write(json.dumps(_row(0)) + "\n")
            f.write('{"request_id": "torn tail')  # killed writer
        got = read_drift(str(path))
        assert [r["request_id"] for r in got] == ["req000", "req001"]
        assert got == jread(str(path))
        assert validate_drift(got) == []


class TestAggregation:
    def test_report_and_bounds_match_jax(self):
        from sagecal_tpu.obs.drift import analyze_drift as janalyze
        from sagecal_tpu.obs.drift import format_drift_report as jformat
        from sagecal_tpu_torch.obs.drift import (
            DRIFT_METRICS, aggregate_drift, analyze_drift, drift_quantiles,
            format_drift_report,
        )

        rng = np.random.default_rng(3)
        rows = [_row(i, cost_rel_delta=float(10 ** rng.uniform(-8, -3)),
                     gain_rel_err_max=float(10 ** rng.uniform(-7, -4)),
                     chi2_rel_delta=float(10 ** rng.uniform(-9, -5)))
                for i in range(40)]
        rows.append(_row(40, path_pair="fused/bf16|xla/f32",
                         coh_dtype="bf16", verdict="drift_exceeded",
                         gain_rel_err_max=0.4, reasons=["too far"]))
        groups = aggregate_drift(rows)
        quant = drift_quantiles(groups)
        for key, g in groups.items():
            for m in DRIFT_METRICS:
                lo, hi = quant[key][m]["p99"]
                assert lo <= g["max"][m] <= hi
        report = analyze_drift(rows, ["a problem"])
        assert report == janalyze(rows, ["a problem"])
        assert format_drift_report(report) == jformat(report)
        assert any("BREACH req040" in ln for ln in format_drift_report(
            report))
        assert format_drift_report(analyze_drift([])) == \
            jformat(janalyze([]))

    def test_check_drift_events(self):
        from sagecal_tpu_torch.obs.drift import check_drift

        log = _FakeLog()
        assert check_drift(log, _row(0)) == ("ok", [])
        bad = _row(1, verdict="drift_exceeded", reasons=["x"])
        assert check_drift(log, bad) == ("drift_exceeded", ["x"])
        kinds = [e["kind"] for e in log.events]
        assert kinds == ["shadow_drift_check", "shadow_drift_check",
                         "drift_exceeded"]


def _serve(tmp_path, tag, n=4, shadow_rate=None, elog=None, **cfg_kw):
    from sagecal_tpu_torch.apps.config import ServeConfig
    from sagecal_tpu_torch.serve.request import load_requests
    from sagecal_tpu_torch.serve.service import CalibrationService
    from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

    manifest = make_synthetic_workload(
        str(tmp_path / f"w-{tag}"), n, n_tenants=1, shapes=((7, 4, 2),),
        device="cpu")
    out = tmp_path / f"out-{tag}"
    kw = dict(out_dir=str(out), batch=2, **cfg_kw)
    if shadow_rate is not None:
        kw["shadow_rate"] = shadow_rate
    summary = CalibrationService(ServeConfig(**kw), log=lambda *a: None,
                                 device="cpu").run(
        load_requests(manifest), elog=elog)
    return out, summary


def _solutions(out_dir):
    """request_id -> (raw solutions-file bytes, res_1) per manifest."""
    sols = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".result.json"):
            with open(os.path.join(out_dir, name)) as f:
                doc = json.load(f)
            with open(doc["solutions"], "rb") as f:
                sols[doc["request_id"]] = (f.read(), doc.get("res_1"))
    return sols


class TestLiveServe:
    def test_shadowed_run_ledger(self, tmp_path):
        """rate 1.0: one valid record per request, verdict ok at zero
        drift (same route, same generator), every manifest naming its
        route, the audit hook feeding the event stream."""
        from sagecal_tpu_torch.obs.drift import analyze_drift
        from sagecal_tpu_torch.obs.shadow import (
            drift_path, read_drift, validate_drift,
        )

        elog = _FakeLog()
        out, summary = _serve(tmp_path, "shadowed", shadow_rate=1.0,
                              elog=elog)
        assert summary["served"] == 4
        assert summary["shadow"]["audited"] == 4
        assert summary["shadow"]["exceeded"] == []
        rows = read_drift(drift_path(str(out)))
        assert len(rows) == 4 and validate_drift(rows) == []
        for r in rows:
            assert r["verdict"] == "ok"
            assert r["path_pair"] == "xla/f32|xla/f32"
            assert r["solver_dtype"] == "float64"
            assert r["cost_rel_delta"] == r["gain_rel_err_max"] == 0.0
        checks = [e for e in elog.events if e["kind"] == "shadow_drift_check"]
        assert len(checks) == 4
        assert analyze_drift(rows)["n_exceeded"] == 0

    def test_fused_batch_audited_against_the_torch_op_path(self, tmp_path):
        """f32 --fused: the records name the production route, and the
        fused-batch lanes agree with their torch-op re-solves within the
        reference's fused_batch/f32 tolerance row."""
        from sagecal_tpu_torch.obs.shadow import (
            drift_path, read_drift, validate_drift,
        )

        out, summary = _serve(tmp_path, "fused", shadow_rate=1.0,
                              use_f64=False, use_fused_predict=True)
        rows = read_drift(drift_path(str(out)))
        assert validate_drift(rows) == []
        assert {r["path_pair"] for r in rows} == {"fused_batch/f32|xla/f32"}
        assert all(r["solver_dtype"] == "float32" for r in rows)
        assert all(r["verdict"] == "ok" for r in rows), rows

    def test_injected_drift_is_caught(self, tmp_path, monkeypatch):
        from sagecal_tpu_torch.obs.drift import analyze_drift
        from sagecal_tpu_torch.obs.shadow import (
            INJECT_DRIFT_ENV, drift_path, read_drift, validate_drift,
        )

        monkeypatch.setenv(INJECT_DRIFT_ENV, "0.05")
        elog = _FakeLog()
        out, summary = _serve(tmp_path, "inject", n=2, shadow_rate=1.0,
                              elog=elog)
        assert summary["shadow"]["audited"] == 2
        assert len(summary["shadow"]["exceeded"]) == 2
        rows = read_drift(drift_path(str(out)))
        assert validate_drift(rows) == []
        assert all(r["verdict"] == "drift_exceeded" for r in rows)
        assert [e for e in elog.events if e["kind"] == "drift_exceeded"]
        assert analyze_drift(rows)["n_exceeded"] == 2

    def test_abort_on_drift_raises_after_the_drain(self, tmp_path,
                                                   monkeypatch):
        from sagecal_tpu_torch.obs.quality import DivergenceAbort
        from sagecal_tpu_torch.obs.shadow import INJECT_DRIFT_ENV

        monkeypatch.setenv(INJECT_DRIFT_ENV, "0.05")
        with pytest.raises(DivergenceAbort, match="abort_on_drift"):
            _serve(tmp_path, "abort", n=2, shadow_rate=1.0,
                   abort_on_drift=True)
        assert len(_solutions(tmp_path / "out-abort")) == 2

    def test_shadow_rate_zero_is_off_path(self, tmp_path):
        """rate 0 (the default) leaves no trace — no auditor, no ledger —
        and its solutions are byte-equal to a fully shadowed run's."""
        from sagecal_tpu_torch.obs.shadow import DRIFT_FILE

        out_off, s_off = _serve(tmp_path, "off", n=3)
        out_zero, s_zero = _serve(tmp_path, "zero", n=3, shadow_rate=0.0)
        out_on, s_on = _serve(tmp_path, "on", n=3, shadow_rate=1.0)
        assert "shadow" not in s_off and "shadow" not in s_zero
        assert not (out_off / DRIFT_FILE).exists()
        assert not (out_zero / DRIFT_FILE).exists()
        assert (out_on / DRIFT_FILE).exists()
        sols_off = _solutions(out_off)
        assert len(sols_off) == 3
        assert sols_off == _solutions(out_zero) == _solutions(out_on)
