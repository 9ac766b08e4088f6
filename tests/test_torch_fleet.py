"""The port's fleet (``fleet/``, ``serve/aot_store.py``, ``apps/fleet.py``)
on the CPU, held against the JAX package where both run.

- the lease queue and admission control: the cases of
  tests/test_fleet.py (queue, claim ordering, admission), run on the
  port's copies;
- coordinator plumbing: bucket hints, ``worker_argv`` round-tripping the
  config (and its CPU entry), ``seed_queue``'s scheduling metadata;
- the kernel store's key, sidecar, corrupt, truncated and
  version-mismatched artifacts, and the build module's store route (a fake
  ``nvcc`` step: no compiler here);
- one in-process ``FleetWorker`` loop over a 4-request manifest against
  the JAX package's worker on the same manifest and SLO state, under the
  "degrade" and the "shed" policies: the same disposition per request id
  and, at float64 in mode 1, solutions within 1e-8;
- ``_solve_large`` at 8 row blocks against the JAX package's large path
  on its 8 host devices: cost rtol 1e-9, gains rtol 1e-7 (the bounds of
  tests/test_sharded.py);
- a two-worker fleet in subprocesses with one worker SIGKILLed after its
  first claim: every request ends with exactly one result manifest.
"""

import json
import math
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _item(rid, tenant="t0", deadline=math.inf, hint="", enq=100.0):
    from sagecal_tpu_torch.fleet.queue import WorkItem

    return WorkItem(request_id=rid, tenant=tenant,
                    request={"request_id": rid, "tenant": tenant},
                    deadline=deadline, bucket_hint=hint,
                    enqueued_at=enq)


class TestWorkItem:
    def test_doc_round_trip_preserves_inf_deadline(self):
        from sagecal_tpu_torch.fleet.queue import WorkItem

        it = _item("r1", deadline=math.inf, hint="N7xT2xF1")
        doc = it.to_doc()
        assert doc["deadline"] is None  # JSON has no inf
        back = WorkItem.from_doc(json.loads(json.dumps(doc)))
        assert back == it

    def test_doc_round_trip_finite_deadline(self):
        from sagecal_tpu_torch.fleet.queue import WorkItem

        it = _item("r2", deadline=123.5)
        assert WorkItem.from_doc(it.to_doc()).deadline == 123.5


class TestLeaseQueue:
    def test_claim_is_exclusive(self, tmp_path):
        from sagecal_tpu_torch.fleet.queue import LeaseQueue

        qa = LeaseQueue(str(tmp_path), worker="wa", ttl_s=30.0)
        qb = LeaseQueue(str(tmp_path), worker="wb", ttl_s=30.0)
        qa.put(_item("r1"))
        assert qa.claim("r1", now=1000.0)
        assert not qb.claim("r1", now=1000.0)
        assert qa.read_lease("r1")["worker"] == "wa"

    def test_claim_refuses_done(self, tmp_path):
        from sagecal_tpu_torch.fleet.queue import LeaseQueue

        q = LeaseQueue(str(tmp_path), worker="wa", ttl_s=30.0)
        q.put(_item("r1"))
        assert q.claim("r1", now=1000.0)
        q.complete("r1", verdict="ok")
        assert not q.claim("r1", now=1001.0)
        assert q.all_done()

    def test_expired_lease_is_stolen_and_renewal_raises(self, tmp_path):
        from sagecal_tpu_torch.fleet.queue import LeaseLost, LeaseQueue

        qa = LeaseQueue(str(tmp_path), worker="wa", ttl_s=10.0)
        qb = LeaseQueue(str(tmp_path), worker="wb", ttl_s=10.0)
        qa.put(_item("r1"))
        assert qa.claim("r1", now=1000.0)  # expires at 1010
        assert not qb.claim("r1", now=1005.0)  # still live
        assert qb.claim("r1", now=1011.0)  # expired: stolen
        assert qb.read_lease("r1")["worker"] == "wb"
        with pytest.raises(LeaseLost):
            qa.renew("r1", now=1012.0)

    def test_renew_extends_expiry(self, tmp_path):
        from sagecal_tpu_torch.fleet.queue import LeaseQueue

        q = LeaseQueue(str(tmp_path), worker="wa", ttl_s=10.0)
        q.put(_item("r1"))
        assert q.claim("r1", now=1000.0)
        assert q.renew("r1", now=1008.0) == 1018.0
        assert q.read_lease("r1")["expires_at"] == 1018.0

    def test_stats_and_pending_track_lease_states(self, tmp_path):
        from sagecal_tpu_torch.fleet.queue import LeaseQueue

        q = LeaseQueue(str(tmp_path), worker="wa", ttl_s=10.0)
        for rid in ("r1", "r2", "r3"):
            q.put(_item(rid))
        q.claim("r1", now=1000.0)
        q.claim("r2", now=1000.0)
        q.complete("r2", verdict="ok")
        st = q.stats(now=1005.0)
        assert st == {"items": 3, "done": 1, "leased": 1,
                      "expired_leases": 0, "waiting": 1}
        # r1's lease expires: it becomes pending again
        st = q.stats(now=1011.0)
        assert st["expired_leases"] == 1
        assert {i.request_id for i in q.pending(now=1011.0)} == \
            {"r1", "r3"}

    def test_failure_markers_accumulate(self, tmp_path):
        from sagecal_tpu_torch.fleet.queue import LeaseQueue

        qa = LeaseQueue(str(tmp_path), worker="wa")
        qb = LeaseQueue(str(tmp_path), worker="wb")
        assert qa.record_failure("r1", "boom") == 1
        assert qb.record_failure("r1", "boom again") == 2
        assert qa.failure_count("r1") == 2
        assert qa.failure_count("r2") == 0


class TestSelectOrdering:
    def test_edf_orders_by_deadline(self, tmp_path):
        from sagecal_tpu_torch.fleet.queue import LeaseQueue

        q = LeaseQueue(str(tmp_path), worker="wa")
        q.put(_item("late", deadline=5000.0))
        q.put(_item("soon", deadline=1000.0))
        q.put(_item("never"))  # inf deadline sorts last
        order = [i.request_id for i in q.select(limit=0, now=0.0)]
        assert order == ["soon", "late", "never"]

    def test_affinity_wins_within_deadline_window(self, tmp_path):
        from sagecal_tpu_torch.fleet.queue import LeaseQueue

        q = LeaseQueue(str(tmp_path), worker="wa")
        # same 10 s deadline window: the held bucket goes first
        q.put(_item("other", deadline=1001.0, hint="N8xT2xF1"))
        q.put(_item("mine", deadline=1004.0, hint="N7xT2xF1"))
        order = [i.request_id for i in q.select(
            affinity={"N7xT2xF1"}, limit=0, now=0.0,
            affinity_window_s=10.0)]
        assert order == ["mine", "other"]

    def test_affinity_never_jumps_an_earlier_window(self, tmp_path):
        from sagecal_tpu_torch.fleet.queue import LeaseQueue

        q = LeaseQueue(str(tmp_path), worker="wa")
        q.put(_item("urgent", deadline=1000.0, hint="N8xT2xF1"))
        q.put(_item("mine", deadline=1100.0, hint="N7xT2xF1"))
        order = [i.request_id for i in q.select(
            affinity={"N7xT2xF1"}, limit=0, now=0.0,
            affinity_window_s=10.0)]
        assert order == ["urgent", "mine"]


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def _spec(tenant="t0", deadline_s=1.0, availability=0.9,
          shed_burn=2.0):
    from sagecal_tpu_torch.obs.slo import SLOSpec

    return SLOSpec(tenant=tenant, deadline_s=deadline_s,
                   availability=availability,
                   windows_s=(60.0, 300.0), shed_burn=shed_burn)


def _manifest(rid, tenant="t0", latency=0.1, verdict="ok", ts=None):
    ts = time.time() if ts is None else ts
    return {"request_id": rid, "tenant": tenant, "verdict": verdict,
            "latency_s": latency, "completed_at": ts}


class TestAdmission:
    def test_accept_without_specs_or_when_off(self):
        from sagecal_tpu_torch.fleet.admission import AdmissionController

        ctl = AdmissionController({}, policy="shed")
        assert ctl.decide("t0")[0] == "accept"
        ctl = AdmissionController({"t0": _spec()}, policy="off")
        ctl.ingest_results(
            [_manifest(f"r{i}", latency=9.0) for i in range(10)])
        assert ctl.decide("t0")[0] == "accept"

    def test_overload_sheds_or_degrades_per_policy(self):
        from sagecal_tpu_torch.fleet.admission import AdmissionController

        blown = [_manifest(f"r{i}", latency=9.0) for i in range(10)]
        shed = AdmissionController({"t0": _spec()}, policy="shed")
        shed.ingest_results(blown)
        decision, detail = shed.decide("t0")
        assert decision == "shed"
        assert detail["shed_burn"] == 2.0
        deg = AdmissionController({"t0": _spec()}, policy="degrade")
        deg.ingest_results(blown)
        assert deg.decide("t0")[0] == "degrade"

    def test_unknown_tenant_is_accepted_under_overload(self):
        from sagecal_tpu_torch.fleet.admission import AdmissionController

        ctl = AdmissionController({"t0": _spec()}, policy="shed")
        ctl.ingest_results(
            [_manifest(f"r{i}", latency=9.0) for i in range(10)])
        assert ctl.decide("t1")[0] == "accept"

    def test_degrade_clamps_but_never_raises_budgets(self):
        from sagecal_tpu_torch.fleet.admission import AdmissionController

        ctl = AdmissionController({}, degrade_emiter=1,
                                  degrade_lbfgs=4)
        out = ctl.degrade_request({"max_emiter": 3, "max_lbfgs": 10})
        assert (out["max_emiter"], out["max_lbfgs"]) == (1, 4)
        out = ctl.degrade_request({"max_emiter": 1, "max_lbfgs": 2})
        assert (out["max_emiter"], out["max_lbfgs"]) == (1, 2)
        out = ctl.degrade_request({})
        assert (out["max_emiter"], out["max_lbfgs"]) == (1, 4)

    def test_shed_manifests_do_not_latch_the_trigger(self, tmp_path):
        """Sheds are excluded from burn samples: after the blown
        requests age past recovery (good solves dominate the window),
        admission resumes even though many sheds were written."""
        from sagecal_tpu_torch.fleet.admission import AdmissionController
        from sagecal_tpu_torch.fleet.queue import WorkItem

        ctl = AdmissionController({"t0": _spec()}, policy="shed")
        now = time.time()
        ctl.ingest_results([_manifest("bad", latency=9.0, ts=now)])
        assert ctl.decide("t0", now=now)[0] == "shed"
        # the refusals themselves (verdict=shed) must not count as
        # errors, or the trigger would hold itself high forever
        for i in range(20):
            item = WorkItem(request_id=f"s{i}", tenant="t0",
                            request={}, enqueued_at=now)
            ctl.shed_result(item, str(tmp_path), {"shed_burn": 2.0})
        ctl.ingest_results(
            [_manifest(f"g{i}", latency=0.1, ts=now + 1) for i in
             range(30)])
        assert ctl.decide("t0", now=now + 2)[0] == "accept"

    def test_shed_result_writes_definitive_manifest(self, tmp_path):
        from sagecal_tpu_torch.fleet.admission import (
            SHED_VERDICT, AdmissionController,
        )
        from sagecal_tpu_torch.fleet.queue import WorkItem
        from sagecal_tpu_torch.serve.request import result_manifest_path

        ctl = AdmissionController({"t0": _spec()})
        item = WorkItem(request_id="r9", tenant="t0",
                        request={"dataset": "d.h5", "t0": 4,
                                 "tilesz": 2},
                        enqueued_at=time.time() - 0.5)
        ctl.shed_result(item, str(tmp_path), {"shed_burn": 2.0})
        doc = json.load(open(result_manifest_path(str(tmp_path), "r9")))
        assert doc["verdict"] == SHED_VERDICT
        assert doc["latency_s"] >= 0.4
        assert any("slo_overload" in r for r in doc["reasons"])




# ---------------------------------------------------------------------------
# coordinator plumbing
# ---------------------------------------------------------------------------


def test_bucket_hint_shape_key():
    from types import SimpleNamespace

    from sagecal_tpu.fleet.coordinator import bucket_hint_for as jhint
    from sagecal_tpu_torch.fleet.coordinator import bucket_hint_for

    meta = SimpleNamespace(nstations=7, nchan=4)
    assert bucket_hint_for(meta, 2) == jhint(meta, 2) == "N7xT2xF1"
    assert bucket_hint_for(meta, 2, nchan_avg=False) == "N7xT2xF4"


def test_worker_argv_round_trips_config():
    from sagecal_tpu.apps.fleet import build_parser as jparser
    from sagecal_tpu.apps.fleet import config_from_args as jconfig
    from sagecal_tpu.fleet.coordinator import worker_argv as jargv
    from sagecal_tpu_torch.apps.fleet import (
        build_parser, config_from_args, worker_argv,
    )
    from sagecal_tpu_torch.fleet.coordinator import worker_argv as argv_of

    flags = ["--requests", "reqs.json", "--out-dir", "od", "--workers", "3",
             "--batch", "4", "--f32", "--fused", "--overload-policy", "shed",
             "--shadow-rate", "0.5", "--lease-ttl", "7"]
    cfg = config_from_args(build_parser().parse_args(flags))
    import dataclasses

    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfig(jparser().parse_args(flags)))
    argv = argv_of(cfg, 1)
    assert argv[:3] == [sys.executable, "-m", "sagecal_tpu_torch.apps.fleet"]
    assert argv[3:] == jargv(jconfig(jparser().parse_args(flags)), 1)[3:]
    back = config_from_args(build_parser().parse_args(argv[3:]))
    for f in ("role", "worker_id", "batch", "overload_policy", "use_f64",
              "use_fused_predict", "shadow_rate", "lease_ttl_s"):
        assert getattr(back, f) == dict(role="worker", worker_id="w1").get(
            f, getattr(cfg, f))
    cpu = worker_argv(cfg, 1, device="cpu")
    assert cpu[1] == "-c" and "device='cpu'" in cpu[2]
    assert cpu[3:] == argv[3:]


def _simulated(path, nstations=7, ntime=4, seed=0):
    import h5py

    from sagecal_tpu_torch.io.dataset import simulate_dataset
    from sagecal_tpu_torch.io.skymodel import load_sky
    from sagecal_tpu_torch.serve.synthetic import _CLUSTER, _SKY

    d = os.path.dirname(path)
    sky = os.path.join(d, "sky.txt")
    open(sky, "w").write(_SKY)
    open(sky + ".cluster", "w").write(_CLUSTER)
    dec0 = math.radians(51.0)
    clusters, _, _ = load_sky(sky, sky + ".cluster", 0.0, dec0,
                              dtype=torch.float64, device="cpu")
    simulate_dataset(path, nstations=nstations, ntime=ntime, nchan=2,
                     clusters=clusters, noise_sigma=1e-4, seed=seed,
                     dec0=dec0, device="cpu")
    with h5py.File(path, "r+") as f:
        f.attrs["ra0"] = 0.0
        f.attrs["dec0"] = dec0
    return sky


def test_seed_queue_stamps_scheduling_metadata(tmp_path):
    from sagecal_tpu_torch.fleet.coordinator import seed_queue
    from sagecal_tpu_torch.fleet.queue import LeaseQueue
    from sagecal_tpu_torch.serve.request import SolveRequest

    dpath = str(tmp_path / "d.h5")
    sky = _simulated(dpath)
    reqs = [SolveRequest(request_id=f"r{i}", tenant="t0", dataset=dpath,
                         sky_model=sky, t0=2 * i, tilesz=2)
            for i in range(2)]
    q = LeaseQueue(str(tmp_path / "q"), worker="coord")
    items = seed_queue(q, reqs, {"t0": _spec(deadline_s=5.0)},
                       large_stations=7, log=lambda *a: None)
    assert [i.request_id for i in items] == ["r0", "r1"]
    for it in items:
        assert it.bucket_hint == "N7xT2xF1"
        assert it.deadline == pytest.approx(it.enqueued_at + 5.0, abs=1.0)
        assert it.large
    assert len(q.items()) == 2
    items = seed_queue(q, [SolveRequest(
        request_id="r9", tenant="t-unknown", dataset=dpath,
        sky_model=sky, t0=0, tilesz=2)], {}, log=lambda *a: None)
    assert math.isinf(items[0].deadline) and not items[0].large


# ---------------------------------------------------------------------------
# the kernel store
# ---------------------------------------------------------------------------

VERSIONS = {"schema": 1, "torch": "2.11.0+cu128", "cuda": "12.8",
            "capability": "9.0"}


def _store(root, **over):
    from sagecal_tpu_torch.serve.aot_store import AOTArtifactStore

    return AOTArtifactStore(str(root), versions=dict(VERSIONS, **over))


def _built(tmp_path, payload=b"\x7fELF-fake-library" * 64):
    p = tmp_path / "built.so"
    p.write_bytes(payload)
    return str(p)


def test_store_key_separates_libraries_digests_and_runtimes(tmp_path):
    from sagecal_tpu_torch.serve.aot_store import artifact_key

    keys = {artifact_key(n, dg, dict(VERSIONS, **over))
            for n in ("fused_cost", "kbisect_a")
            for dg in ("0" * 16, "1" * 16)
            for over in ({}, {"torch": "2.12.0"}, {"cuda": "12.9"},
                         {"capability": "8.0"})}
    assert len(keys) == 16
    assert artifact_key("a", "d", VERSIONS) == artifact_key("a", "d",
                                                            VERSIONS)


def test_store_save_then_hit(tmp_path):
    st = _store(tmp_path / "s")
    assert st.lookup("fused_cost", "ab" * 8) is None
    lib = st.save("fused_cost", "ab" * 8, _built(tmp_path))
    side = lib[:-3] + ".json"
    header = json.load(open(side))
    assert header["capability"] == "9.0" and header["digest"] == "ab" * 8
    again = _store(tmp_path / "s")
    assert again.lookup("fused_cost", "ab" * 8) == lib
    assert (again.hits, again.builds, again.errors) == (1, 0, 0)
    assert st.builds == 1 and st.stats()["artifacts"] == 1
    assert sorted(n for n in os.listdir(tmp_path / "s")
                  if not n.endswith(".lock")) == sorted(
        [os.path.basename(lib), os.path.basename(side)])


@pytest.mark.parametrize("damage", ["truncated", "corrupt", "sidecar",
                                    "magic", "digest"])
def test_store_damaged_artifact_is_a_miss(tmp_path, damage):
    st = _store(tmp_path / "s")
    lib = st.save("fused_cost", "cd" * 8, _built(tmp_path))
    side = lib[:-3] + ".json"
    if damage == "truncated":
        with open(lib, "r+b") as f:
            f.truncate(10)
    elif damage == "corrupt":
        data = bytearray(open(lib, "rb").read())
        data[5] ^= 0xFF
        open(lib, "wb").write(bytes(data))
    elif damage == "sidecar":
        open(side, "w").write("{not json")
    else:
        doc = json.load(open(side))
        doc[damage] = "other"
        json.dump(doc, open(side, "w"))
    again = _store(tmp_path / "s")
    assert again.lookup("fused_cost", "cd" * 8) is None
    assert again.errors == 1 and again.last_error
    # a rebuild replaces the damaged artifact
    again.save("fused_cost", "cd" * 8, _built(tmp_path))
    assert _store(tmp_path / "s").lookup("fused_cost", "cd" * 8) == lib


@pytest.mark.parametrize("field,value", [("torch", "2.12.0"),
                                         ("cuda", "13.0"),
                                         ("capability", "8.0")])
def test_store_version_mismatch_is_refused(tmp_path, field, value):
    st = _store(tmp_path / "s")
    lib = st.save("fused_cost", "ef" * 8, _built(tmp_path))
    side = lib[:-3] + ".json"
    doc = json.load(open(side))
    doc[field] = value  # written by another runtime under this key
    json.dump(doc, open(side, "w"))
    again = _store(tmp_path / "s")
    assert again.lookup("fused_cost", "ef" * 8) is None
    assert "version mismatch" in again.last_error


def test_build_module_builds_once_into_the_store(tmp_path, monkeypatch):
    """kernels/build.py with a store attached: the first process builds
    every library into the store, a second builds nothing."""
    from sagecal_tpu_torch.kernels import build

    started = []

    def fake_start(name, out=None):
        started.append(name)
        with open(out, "wb") as f:
            f.write(f"lib {name}".encode() * 32)
        return None

    monkeypatch.setattr(build, "_start", fake_start)
    monkeypatch.setattr(build, "_store", None)
    first = _store(tmp_path / "s")
    build.attach_store(first)
    paths = build.build_all(["fused_cost", "kbisect_a"])
    assert started == ["fused_cost", "kbisect_a"]
    assert (first.builds, first.hits) == (2, 0)
    second = _store(tmp_path / "s")
    build.attach_store(second)
    assert build.build_all(["fused_cost", "kbisect_a"]) == paths
    assert started == ["fused_cost", "kbisect_a"]
    assert (second.builds, second.hits) == (0, 2)
    build.attach_store(None)


# ---------------------------------------------------------------------------
# the worker against the JAX package's
# ---------------------------------------------------------------------------


def _workload(tmp_path):
    """4 requests (2 tenants x 2 tiles of a 7-station dataset each: one
    shape class, so the JAX package compiles one bucket), SLOs in the
    manifest, the JAX package's request schema."""
    from sagecal_tpu_torch.serve.synthetic import (
        SHAPE_CLASSES, make_synthetic_workload,
    )

    path = make_synthetic_workload(str(tmp_path / "w"), 4, n_tenants=2,
                                   shapes=SHAPE_CLASSES[:1], device="cpu")
    doc = json.load(open(path))
    # tenant0's deadline is out of reach of any solve's latency (a JAX
    # compile included), so only tenant1's blown history trips admission
    doc["slos"] = [{"tenant": t, "deadline_s": d, "availability": 0.9,
                    "windows_s": [60.0, 300.0], "shed_burn": 2.0}
                   for t, d in (("tenant0", 3600.0), ("tenant1", 1.0))]
    json.dump(doc, open(path, "w"))
    return path


def _blown(out_dir, tenant="tenant1", n=10):
    """Earlier results of ``tenant`` far past its deadline: its burn
    trips admission (the "degrade"/"shed" dispositions)."""
    os.makedirs(out_dir, exist_ok=True)
    now = time.time()
    for i in range(n):
        json.dump({"request_id": f"old{i}", "tenant": tenant,
                   "verdict": "ok", "latency_s": 9.0, "completed_at": now},
                  open(os.path.join(out_dir, f"old{i}.result.json"), "w"))


def _run_worker(pkg, requests, out_dir, policy, large_stations=0):
    """Seed a queue and drain it with one in-process worker of ``pkg``."""
    import importlib

    cfgm = importlib.import_module(f"{pkg}.apps.config")
    coord = importlib.import_module(f"{pkg}.fleet.coordinator")
    queue = importlib.import_module(f"{pkg}.fleet.queue")
    reqm = importlib.import_module(f"{pkg}.serve.request")
    slo = importlib.import_module(f"{pkg}.obs.slo")
    worker = importlib.import_module(f"{pkg}.fleet.worker")
    cfg = cfgm.FleetConfig(
        requests=requests, out_dir=out_dir, batch=2, max_emiter=1,
        max_iter=2, max_lbfgs=4, solver_mode=1, overload_policy=policy,
        max_idle_s=1.0, poll_s=0.05, large_stations=large_stations,
        timeline=False)
    q = queue.LeaseQueue(os.path.join(out_dir, "queue"), worker="coord")
    coord.seed_queue(q, reqm.load_requests(requests),
                     slo.load_slo_specs(requests),
                     large_stations=large_stations, log=lambda *a: None)
    kw = {"device": "cpu"} if pkg == "sagecal_tpu_torch" else {}
    w = worker.FleetWorker(cfg, log=lambda *a: None, **kw)
    return w, w.run()


def _dispositions(out_dir):
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".result.json") and not name.startswith("old"):
            doc = json.load(open(os.path.join(out_dir, name)))
            out[doc["request_id"]] = (
                "shed" if doc["verdict"] == "shed" else
                "degrade" if doc.get("degraded") else
                "error" if doc["verdict"] == "error" else "accept")
    return out


@pytest.mark.parametrize("policy", ["degrade", "shed"])
def test_worker_matches_jax_worker(tmp_path, policy):
    from sagecal_tpu_torch.io import solutions as solio

    requests = _workload(tmp_path)
    outs = {}
    for pkg in ("sagecal_tpu", "sagecal_tpu_torch"):
        out_dir = str(tmp_path / pkg)
        _blown(out_dir)
        _, summary = _run_worker(pkg, requests, out_dir, policy)
        outs[pkg] = out_dir
    want, got = (_dispositions(outs[p]) for p in outs)
    assert got == want
    assert sorted(got) == [f"req{i:03d}" for i in range(4)]
    assert {got[r] for r in ("req001", "req003")} == {policy}
    assert {got[r] for r in ("req000", "req002")} == {"accept"}
    for rid, how in got.items():
        if how == "shed":
            continue
        docs = [json.load(open(os.path.join(outs[p],
                                            f"{rid}.result.json")))
                for p in outs]
        (_, jw), (_, jg) = (solio.read_solutions(d["solutions"])
                            for d in docs)
        scale = np.abs(jw).max()
        assert np.abs(jg - jw).max() <= 1e-8 * scale, rid


def test_solve_large_matches_jax(tmp_path):
    from sagecal_tpu.fleet.queue import WorkItem as JItem
    from sagecal_tpu.fleet.worker import FleetWorker as JWorker
    from sagecal_tpu.apps.config import FleetConfig as JCfg
    from sagecal_tpu_torch.apps.config import FleetConfig
    from sagecal_tpu_torch.fleet.queue import WorkItem
    from sagecal_tpu_torch.fleet.worker import FleetWorker
    from sagecal_tpu_torch.io import solutions as solio

    dpath = str(tmp_path / "d.h5")
    sky = _simulated(dpath, nstations=8, ntime=4)
    req = dict(request_id="big0", tenant="t0", dataset=dpath,
               sky_model=sky, t0=0, tilesz=2)
    kw = dict(max_lbfgs=6, lbfgs_m=5, large_stations=8, timeline=False)
    docs = []
    for pkg, Cfg, Worker, Item, extra in (
            ("jax", JCfg, JWorker, JItem, {}),
            ("port", FleetConfig, FleetWorker, WorkItem,
             {"nshards": 8})):
        out_dir = str(tmp_path / pkg)
        cfg = Cfg(out_dir=out_dir, **kw)
        wkw = {"device": "cpu"} if pkg == "port" else {}
        w = Worker(cfg, log=lambda *a: None, **wkw)
        w._solve_large(Item(request_id="big0", tenant="t0", request=req,
                            enqueued_at=time.time(), large=True),
                       False, None, **extra)
        docs.append(json.load(open(os.path.join(out_dir,
                                                "big0.result.json"))))
    jdoc, tdoc = docs
    assert tdoc["placed"] == jdoc["placed"] == "sharded_joint_fit"
    assert tdoc["iterations"] == jdoc["iterations"]
    np.testing.assert_allclose(tdoc["res_0"], jdoc["res_0"], rtol=1e-9)
    _, jw = solio.read_solutions(jdoc["solutions"])
    _, tw = solio.read_solutions(tdoc["solutions"])
    np.testing.assert_allclose(tw, jw, rtol=1e-7, atol=1e-12)


# ---------------------------------------------------------------------------
# two worker processes, one SIGKILLed
# ---------------------------------------------------------------------------


def test_sigkilled_worker_leaves_one_manifest_per_request(tmp_path):
    from sagecal_tpu_torch.apps.config import FleetConfig
    from sagecal_tpu_torch.apps.fleet import run_coordinator
    from sagecal_tpu_torch.fleet.queue import LeaseQueue
    from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

    requests = make_synthetic_workload(str(tmp_path / "w"), 6, n_tenants=2,
                                       device="cpu")
    out_dir = str(tmp_path / "out")
    cfg = FleetConfig(requests=requests, out_dir=out_dir, workers=2,
                      batch=1, lease_ttl_s=2.0, poll_s=0.05,
                      max_idle_s=20.0, max_emiter=1, max_iter=2,
                      max_lbfgs=3, solver_mode=1, max_respawns=0)
    killed, pids = {}, []

    def log(msg):  # "fleet: spawned 2 workers (pids [a, b])"
        if "spawned" in msg:
            pids.extend(int(x) for x in
                        msg.split("[")[1].split("]")[0].split(","))

    def watch():  # SIGKILL w1 as soon as it holds its first lease
        q = LeaseQueue(os.path.join(out_dir, "queue"), worker="probe")
        deadline = time.time() + 40
        while time.time() < deadline and not killed:
            if len(pids) == 2 and os.path.isdir(q.root):
                for it in q.items():
                    lease = q.read_lease(it.request_id)
                    if lease and lease.get("worker") == "w1":
                        os.kill(pids[1], signal.SIGKILL)
                        killed[it.request_id] = pids[1]
                        return
            time.sleep(0.01)

    import threading

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    summary = run_coordinator(cfg, log=log, device="cpu")
    t.join(timeout=5)
    assert killed, "w1 never claimed"
    assert summary["drained"] and summary["done"] == 6
    names = sorted(n for n in os.listdir(out_dir)
                   if n.endswith(".result.json"))
    assert names == [f"req{i:03d}.result.json" for i in range(6)]
    for n in names:
        doc = json.load(open(os.path.join(out_dir, n)))
        assert doc["verdict"] == "ok", doc
        assert os.path.exists(doc["solutions"])
