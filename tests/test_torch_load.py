"""The port's load generator (``fleet/loadgen.py``, ``apps/load.py``) on
the CPU, held against the JAX package.

- ``schedule_json`` byte-identical to the reference's for each arrival
  kind and two seeds;
- ``build_population`` equal; ``materialize_workload``'s
  ``requests.json`` and ``slo.json`` equal, dataset paths aside; the
  tenants' datasets equal to the predict's rounding (1e-12 of their max
  abs);
- the capacity functions of ``obs/capacity.py`` (curve, knee, arrival
  dispositions, Little's law, the live-vs-posthoc reconciliation) give
  the reference's results on the inputs of tests/test_load.py;
- one short ``load`` run through the CLI with one worker process on the
  CPU: exit 0 (drained), every scheduled arrival exactly one result
  manifest, the live and after-the-fact views reconciled.
"""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.mark.parametrize("arrival", ["poisson", "onoff", "ramp"])
@pytest.mark.parametrize("seed", [7, 23])
def test_schedule_json_byte_identical(arrival, seed):
    from sagecal_tpu.fleet.loadgen import LoadSpec as JSpec
    from sagecal_tpu.fleet.loadgen import schedule_json as jsched
    from sagecal_tpu_torch.fleet.loadgen import LoadSpec, schedule_json

    kw = dict(arrival=arrival, seed=seed, tenants=3, rates=(0.5, 2.0, 4.0),
              step_s=10.0, duration_s=20.0)
    assert schedule_json(LoadSpec(**kw)) == jsched(JSpec(**kw))


@pytest.mark.parametrize("tenants", [1, 2, 5])
def test_population_matches_reference(tenants):
    import dataclasses

    from sagecal_tpu.fleet.loadgen import LoadSpec as JSpec
    from sagecal_tpu.fleet.loadgen import build_population as jpop
    from sagecal_tpu_torch.fleet.loadgen import LoadSpec, build_population

    got = [dataclasses.astuple(t) for t in
           build_population(LoadSpec(tenants=tenants, seed=5))]
    want = [dataclasses.astuple(t) for t in
            jpop(JSpec(tenants=tenants, seed=5))]
    assert got == want


def test_materialized_workload_matches_reference(tmp_path):
    import h5py

    from sagecal_tpu.fleet.loadgen import LoadSpec as JSpec
    from sagecal_tpu.fleet.loadgen import build_schedule as jsched
    from sagecal_tpu.fleet.loadgen import materialize_workload as jmat
    from sagecal_tpu_torch.fleet.loadgen import (
        LoadSpec, build_schedule, materialize_workload,
    )

    kw = dict(arrival="poisson", rate=2.0, duration_s=5.0, tenants=2,
              seed=11)
    arrivals, _ = build_schedule(LoadSpec(**kw))
    assert arrivals == jsched(JSpec(**kw))[0]
    jp = jmat(str(tmp_path / "j"), JSpec(**kw), arrivals)
    tp = materialize_workload(str(tmp_path / "t"), LoadSpec(**kw), arrivals,
                              device="cpu")

    def strip(path, root):
        with open(path) as fh:
            text = fh.read()
        return json.loads(text.replace(str(tmp_path / root), "<dir>"))

    assert strip(tp["slo"], "t") == strip(jp["slo"], "j")
    treq, jreq = strip(tp["requests"], "t"), strip(jp["requests"], "j")
    assert treq == jreq and len(treq["requests"]) == len(arrivals)
    for r in jreq["requests"]:
        name = os.path.basename(r["dataset"])
        with h5py.File(str(tmp_path / "j" / name)) as fj, \
                h5py.File(str(tmp_path / "t" / name)) as ft:
            for k in ("u", "v", "w", "freqs", "flag"):
                np.testing.assert_array_equal(np.asarray(ft[k]),
                                              np.asarray(fj[k]))
            vj, vt = np.asarray(fj["vis"]), np.asarray(ft["vis"])
            assert np.abs(vt - vj).max() <= 1e-12 * np.abs(vj).max()
            assert dict(ft.attrs) == pytest.approx(dict(fj.attrs))


# the inputs of tests/test_load.py's knee, disposition and Little's-law
# fixtures


def _steps(rates, dur=10.0):
    return [{"index": i, "t0": i * dur, "t1": (i + 1) * dur,
             "offered_rate": r, "arrivals": int(r * dur)}
            for i, r in enumerate(rates)]


def _ok_result(rid, t_done, tenant="tenant0", wait=0.0, verdict="ok",
               latency=0.5):
    return {"request_id": rid, "tenant": tenant, "verdict": verdict,
            "enqueued_at": t_done - latency, "started_at":
            t_done - latency + wait, "completed_at": t_done,
            "queue_wait_s": wait, "latency_s": latency}


def _capped(cap=2.0, dur=10.0, rates=(0.5, 1.0, 2.0, 4.0)):
    results, k = [], 0
    for i, r in enumerate(rates):
        served = int(min(r, cap) * dur)
        for j in range(served):
            k += 1
            results.append(_ok_result(
                f"r{k:04d}", i * dur + (j + 0.5) * dur / served))
    return _steps(rates, dur), results


def _kept_up(dur=10.0, rates=(0.5, 1.0)):
    results, k = [], 0
    for i, r in enumerate(rates):
        for j in range(int(r * dur)):
            k += 1
            results.append(_ok_result(f"r{k:04d}", i * dur + j / r + 0.1))
    return _steps(rates, dur), results


def _spill():
    results = [_ok_result(f"r{j:02d}", (j + 0.4) * 2.0) for j in range(9)]
    results.append(_ok_result("r09", 20.0 + 0.3))
    return _steps([0.5], 20.0), results


def _shed_mix():
    dur = 10.0
    results = [_ok_result(f"ok{i}", 2.0 + i) for i in range(4)]
    results += [_ok_result(f"sh{i}", 3.0 + i, verdict="shed")
                for i in range(6)]
    return _steps([1.0], dur), results


CURVES = {"capped": _capped, "kept_up": _kept_up, "spill": _spill,
          "shed_mix": _shed_mix}


@pytest.mark.parametrize("case", sorted(CURVES))
@pytest.mark.parametrize("tol", [0.10, None])
def test_curve_and_knee_match_reference(case, tol):
    from sagecal_tpu.obs import capacity as jcap
    from sagecal_tpu_torch.obs import capacity as cap

    steps, results = CURVES[case]()
    kw = {} if tol is None else {"tol": tol}
    tc = cap.throughput_curve(steps, results)
    jc = jcap.throughput_curve(steps, results)
    assert tc == jc
    assert cap.find_knee(tc, **kw) == jcap.find_knee(jc, **kw)


def test_arrival_dispositions_match_reference():
    from sagecal_tpu.obs import capacity as jcap
    from sagecal_tpu_torch.obs import capacity as cap

    dur = 10.0
    doc = {"t_start": 0.0, "steps": _steps([1.0, 4.0], dur),
           "submitted": (
               [{"t": j + 0.5, "request_id": f"a{j:02d}"}
                for j in range(10)]
               + [{"t": dur + j * 0.25, "request_id": f"b{j:02d}"}
                  for j in range(40)])}
    results = [_ok_result(f"a{j:02d}", j + 1.0) for j in range(10)]
    results += [_ok_result(f"b{j:02d}", 2 * dur + 1.0 + j,
                           verdict="ok" if j < 10 else "shed")
                for j in range(40)]
    got = cap.arrival_dispositions(doc, results)
    assert got == jcap.arrival_dispositions(doc, results)
    assert got[1]["arrival_shed_rate"] == pytest.approx(0.75)


def _dense_timeline(t0, t1, waiting, dt=0.5):
    rows, t = [], t0
    while t <= t1:
        rows.append({"schema_version": 1, "kind": "fleet_timeline",
                     "ts": t, "items": 100, "done": 0,
                     "waiting": waiting, "leased": 0,
                     "expired_leases": 0, "alive_workers": 2})
        t += dt
    return rows


@pytest.mark.parametrize("waiting", [2, 12])
def test_littles_law_and_reconcile_match_reference(waiting):
    from sagecal_tpu.obs import capacity as jcap
    from sagecal_tpu_torch.obs import capacity as cap

    results = [_ok_result(f"r{i:03d}", i + 2.0 + 0.3, wait=2.0, latency=2.3)
               for i in range(40)]
    rows = _dense_timeline(2.0, 41.0, waiting)
    got = cap.littles_law_check(rows, results)
    assert got == jcap.littles_law_check(rows, results)
    assert got["posthoc_ok"] and got["live_ok"] == (waiting == 2)
    rec = cap.reconcile_queue_views(rows, results)
    assert rec == jcap.reconcile_queue_views(rows, results)
    assert rec["ok"] == (waiting == 2)


def test_short_load_run_drains_and_reconciles(tmp_path):
    """One CPU worker process against a short seeded poisson schedule
    through the CLI: every arrival one disposition, drained, the views
    reconciled."""
    from sagecal_tpu_torch.apps.cli import main

    out = str(tmp_path / "run")
    rc = main(["load", "--out-dir", out, "--workers", "1", "--arrival",
               "poisson", "--rate", "1.0", "--duration", "4", "--tenants",
               "2", "--seed", "7", "--lease-ttl", "5", "--max-idle", "10",
               "--drain-timeout", "150", "--poll", "0.1"], device="cpu")
    assert rc == 0
    with open(os.path.join(out, "load_report.json")) as fh:
        report = json.load(fh)
    with open(os.path.join(out, "load_steps.json")) as fh:
        steps = json.load(fh)
    submitted = [a["request_id"] for a in steps["submitted"]]
    assert report["drained"] and submitted
    assert sum(s["arrivals"] for s in steps["steps"]) == len(submitted)
    ids = []
    for name in os.listdir(out):
        if name.endswith(".result.json"):
            with open(os.path.join(out, name)) as fh:
                ids.append(json.load(fh)["request_id"])
    assert sorted(ids) == sorted(submitted)
    assert report["manifests"] == len(submitted)
    assert report["errors"] == 0
    assert report["reconcile"]["ok"], report["reconcile"]
