"""Port vs JAX package: the calibration service (``serve/``,
``apps/serve.py``), mirroring ``tests/test_serve.py``.

The JAX package's ``make_synthetic_workload`` writes the datasets and
the request manifest at its two shape classes (7 and 8 stations, two
tenants, 5 requests at batch 2: two buckets, one ragged).  Both packages
serve that manifest at f64, the "xla" route (the torch-op cost in the
port).  Per request id the verdict, bucket, batch, lane, kernel_path,
its reason and the reasons are equal; res_0/res_1 within 1e-8 relative
and each solutions file within 1e-8 of its largest magnitude; the cache
stats are equal.  Then the reference's own cases: the cache reusing a
bucket's entry, result manifests, prefetcher teardown on success and
error, the stream pool's LRU eviction, request manifests, the CLI, the
padded-lane guard; an f32 ``--fused`` run on the kernels' plain
versions (within the 5e-3 bar of the f64 reference); and the route the
port takes where the TPU's VMEM bound sends the reference elsewhere.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

TOL = 1e-8
F32_TOL = 5e-3


def _results(summary) -> dict:
    return {r["request_id"]: r for r in summary["results"]}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One reference workload served by both packages at f64."""
    from sagecal_tpu.apps.config import ServeConfig as JCfg
    from sagecal_tpu.serve.request import load_requests as jload
    from sagecal_tpu.serve.service import CalibrationService as JService
    from sagecal_tpu.serve.synthetic import make_synthetic_workload
    from sagecal_tpu_torch.apps.config import ServeConfig
    from sagecal_tpu_torch.serve.request import load_requests
    from sagecal_tpu_torch.serve.service import CalibrationService

    work = tmp_path_factory.mktemp("serve")
    manifest = make_synthetic_workload(str(work / "w"), 5, n_tenants=2)
    jsvc = JService(JCfg(out_dir=str(work / "jax"), batch=2),
                    log=lambda *a: None)
    want = jsvc.run(jload(manifest))
    svc = CalibrationService(ServeConfig(out_dir=str(work / "port"),
                                         batch=2),
                             log=lambda *a: None, device="cpu")
    got = svc.run(load_requests(manifest))
    return dict(work=work, manifest=manifest, want=want, got=got,
                jcache=jsvc.cache.stats(), cache=svc.cache.stats())


def test_dispositions_match_jax(served):
    got, want = _results(served["got"]), _results(served["want"])
    assert sorted(got) == sorted(want) == [f"req{i:03d}" for i in range(5)]
    for rid, w in want.items():
        g = got[rid]
        for k in ("verdict", "reasons", "bucket", "batch", "lane",
                  "kernel_path", "kernel_path_reason", "tenant", "t0"):
            assert g[k] == w[k], (rid, k, g[k], w[k])
        for k in ("res_0", "res_1"):
            assert abs(g[k] - w[k]) <= TOL * abs(w[k]), (rid, k)
        assert g["res_1"] < g["res_0"]
    assert served["got"]["served"] == served["want"]["served"] == 5


def test_solutions_files_match_jax(served):
    from sagecal_tpu_torch.io.solutions import read_solutions

    got, want = _results(served["got"]), _results(served["want"])
    for rid in want:
        gmeta, g = read_solutions(got[rid]["solutions"])
        wmeta, w = read_solutions(want[rid]["solutions"])
        assert gmeta == wmeta
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL * np.abs(w).max(), rid


def test_cache_stats_match_jax(served):
    assert served["cache"] == served["jcache"] == {
        "hits": 1, "misses": 2, "entries": 2}
    assert served["got"]["buckets"] == served["want"]["buckets"]


def test_entry_name_matches_jax():
    from sagecal_tpu.serve.bucket import BucketSpec as JSpec
    from sagecal_tpu.serve.cache import ExecutableCache as JCache
    from sagecal_tpu_torch.serve.bucket import BucketSpec
    from sagecal_tpu_torch.serve.cache import ExecutableCache

    spec = (7, 84, 4, 1, 2, 2, 56, "float64", 150e6, 1e5, 10.0)
    fp = "0123456789abcdef"
    got = ExecutableCache.entry_name(BucketSpec(*spec), fp)
    assert got == JCache.entry_name(JSpec(*spec), fp)
    assert got == "serve_batch[N7xB84xT4xC1xM2#01234567]"


def test_result_manifests_name_route_and_solutions(served):
    from sagecal_tpu_torch.serve.request import result_manifest_path

    out = str(served["work"] / "port")
    for rid in _results(served["got"]):
        doc = json.load(open(result_manifest_path(out, rid)))
        assert doc["verdict"] in ("ok", "degraded", "diverged")
        assert doc["kernel_path"] == "xla"
        assert os.path.exists(doc["solutions"])
        assert doc["latency_s"] >= doc["queue_wait_s"] >= 0.0
    assert not [n for n in os.listdir(out) if ".tmp." in n]


def test_synthetic_workload_matches_jax(tmp_path):
    """The port's generator writes the reference's manifest (up to the
    directory) and its datasets (to the predict's f64 rounding)."""
    import h5py

    from sagecal_tpu.serve.synthetic import make_synthetic_workload as jmake
    from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

    want = jmake(str(tmp_path / "j"), 3, n_tenants=2)
    got = make_synthetic_workload(str(tmp_path / "t"), 3, n_tenants=2,
                                  device="cpu")
    jdoc = json.load(open(want))["requests"]
    tdoc = json.load(open(got))["requests"]
    for j, t in zip(jdoc, tdoc):
        for k in ("dataset", "sky_model"):
            assert os.path.basename(t.pop(k)) == os.path.basename(j.pop(k))
        assert t == j
    for name in sorted(os.listdir(tmp_path / "j")):
        if not name.endswith(".h5"):
            continue
        with h5py.File(str(tmp_path / "j" / name), "r") as fj, \
                h5py.File(str(tmp_path / "t" / name), "r") as ft:
            assert dict(ft.attrs) == pytest.approx(dict(fj.attrs))
            assert sorted(ft.keys()) == sorted(fj.keys())
            for k in fj.keys():
                a, b = np.asarray(ft[k]), np.asarray(fj[k])
                assert a.dtype == b.dtype and a.shape == b.shape, k
                if a.dtype == bool:
                    assert np.array_equal(a, b), k
                else:
                    scale = max(np.abs(b).max(), 1.0)
                    assert np.abs(a - b).max() <= 1e-12 * scale, k


def test_second_submission_hits_the_cache(tmp_path):
    """Two same-bucket batches: the first misses, the second hits, and
    the registry counts both (telemetry on)."""
    from sagecal_tpu_torch.apps.config import ServeConfig
    from sagecal_tpu_torch.obs import registry
    from sagecal_tpu_torch.serve.request import load_requests
    from sagecal_tpu_torch.serve.service import CalibrationService
    from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

    manifest = make_synthetic_workload(str(tmp_path / "w"), 4, n_tenants=1,
                                       shapes=((7, 4, 2),), device="cpu")
    svc = CalibrationService(ServeConfig(out_dir=str(tmp_path / "out"),
                                         batch=2),
                             log=lambda *a: None, device="cpu")
    registry.set_telemetry(True)
    try:
        reg = registry.get_registry()
        before = [reg.get_counter(f"serve_executable_cache_{k}_total",
                                  bucket="N7xB42xT2xC1xM2")
                  for k in ("hits", "misses")]
        summary = svc.run(load_requests(manifest))
        after = [reg.get_counter(f"serve_executable_cache_{k}_total",
                                 bucket="N7xB42xT2xC1xM2")
                 for k in ("hits", "misses")]
    finally:
        registry.set_telemetry(None)
    assert summary["served"] == 4
    assert svc.cache.stats() == {"hits": 1, "misses": 1, "entries": 1}
    assert [a - b for a, b in zip(after, before)] == [1.0, 1.0]
    # telemetry on: one metrics snapshot of the run
    from sagecal_tpu_torch.obs.aggregate import read_metrics_snapshots

    docs = read_metrics_snapshots(str(tmp_path / "out"))
    assert len(docs) == 1 and docs[0]["state"]["counters"]


def test_per_lane_routes_return_each_lanes_quality(tmp_path):
    """On the lane-by-lane routes ``sagefit_packed_batch`` returns the
    quality bundle of every lane stacked (the reference's vmap does),
    each equal to that lane's own ``sagefit``."""
    import torch

    from sagecal_tpu_torch.apps.config import ServeConfig
    from sagecal_tpu_torch.solvers.batched import (
        derive_lane_generators, sagefit_packed_batch, stack_lanes,
    )
    from sagecal_tpu_torch.solvers.sage import sagefit

    entries = _entries(tmp_path, ServeConfig(), 2)
    data, cdata, p0 = stack_lanes([(e.data, e.cdata, e.p0) for e in entries])
    scfg = entries[0].scfg
    out = sagefit_packed_batch(data, cdata, data.vis.real, data.vis.imag,
                               cdata.coh.real, cdata.coh.imag, p0, scfg,
                               derive_lane_generators(0, [1, 2]),
                               device="cpu")
    gens = derive_lane_generators(0, [1, 2])
    for b, e in enumerate(entries):
        one = sagefit(e.data, e.cdata, e.p0, scfg, gens[b], device="cpu")
        for k in ("em", "final"):
            for f, x in zip(one.quality[k], out.quality[k]):
                assert (f is None) == (x is None)
                if f is not None:
                    assert torch.equal(x[b], f)


def _entries(tmp_path, cfg, n):
    """``n`` solve-ready entries of one synthetic bucket, as the service
    loads them."""
    from sagecal_tpu_torch.io.dataset import VisDataset
    from sagecal_tpu_torch.serve.request import load_requests
    from sagecal_tpu_torch.serve.service import CalibrationService
    from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

    manifest = make_synthetic_workload(str(tmp_path / "e"), n, n_tenants=1,
                                       shapes=((7, 4, 2),), device="cpu")
    svc = CalibrationService(cfg, log=lambda *a: None, device="cpu")
    out = []
    for req in load_requests(manifest):
        with VisDataset(req.dataset, "r") as ds:
            data = ds.load_tile(req.t0, req.tilesz, average_channels=True,
                                dtype=np.float32 if not cfg.use_f64
                                else np.float64, device="cpu")
            out.append(svc._load_entry(req, data, ds.meta)[0])
    return out


def test_f32_fused_run_on_the_plain_versions(served, tmp_path):
    """``--f32 --fused`` on the CPU: every bucket (ragged included) on
    "fused_batch" as the reference routes it under its VMEM bound, the
    kernels' plain versions, every residual within the 5e-3 bar of the
    reference's f64 run."""
    from sagecal_tpu_torch.apps.config import ServeConfig
    from sagecal_tpu_torch.serve.request import load_requests
    from sagecal_tpu_torch.serve.service import CalibrationService

    cfg = ServeConfig(out_dir=str(tmp_path / "f32"), batch=2, use_f64=False,
                      use_fused_predict=True)
    summary = CalibrationService(cfg, log=lambda *a: None,
                                 device="cpu").run(
        load_requests(served["manifest"]))
    want = _results(served["want"])
    for rid, g in _results(summary).items():
        assert g["kernel_path"] == "fused_batch"
        assert g["kernel_path_reason"] == \
            "all batched-kernel capability checks passed"
        assert g["verdict"] == want[rid]["verdict"]
        assert abs(g["res_1"] - want[rid]["res_1"]) <= \
            F32_TOL * want[rid]["res_1"]


def test_vmem_bound_route_differs_from_the_reference(tmp_path, monkeypatch):
    """A bucket of 14 lanes of 2 clusters: B * pad8(M) = 112 is above the
    TPU's VMEM bound of 104, so the reference routes it to "fused"; the
    CUDA kernels have no such bound and the port's service solves it on
    "fused_batch" (``solvers/batched.py::choose_batched_path``)."""
    from types import SimpleNamespace

    from sagecal_tpu.solvers.batched import choose_batched_path as jroute
    from sagecal_tpu.solvers.sage import SageConfig as JSage
    from sagecal_tpu_torch.apps.config import ServeConfig
    from sagecal_tpu_torch.serve.request import load_requests
    from sagecal_tpu_torch.serve.service import CalibrationService
    from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload
    from sagecal_tpu_torch.solvers import batched

    seen = []
    route = batched.choose_batched_path

    def spy(data, cdata, p0, config):
        seen.append((data.ant_p.numpy(), data.ant_q.numpy(), p0.numpy(),
                     config))
        return route(data, cdata, p0, config)

    monkeypatch.setattr(batched, "choose_batched_path", spy)
    manifest = make_synthetic_workload(str(tmp_path / "w"), 1, n_tenants=1,
                                       shapes=((7, 4, 2),), device="cpu")
    cfg = ServeConfig(out_dir=str(tmp_path / "out"), batch=14,
                      use_f64=False, use_fused_predict=True, max_emiter=1,
                      max_iter=1, max_lbfgs=2)
    summary = CalibrationService(cfg, log=lambda *a: None,
                                 device="cpu").run(load_requests(manifest))
    (res,) = summary["results"]
    assert (res["kernel_path"], res["batch"]) == ("fused_batch", 14)
    ant_p, ant_q, p0, scfg = seen[0]
    jcfg = JSage(**{f.name: getattr(scfg, f.name)
                    for f in dataclasses.fields(scfg)})
    path, reason = jroute(SimpleNamespace(ant_p=ant_p, ant_q=ant_q), None,
                          p0, jcfg)
    assert path == "fused" and "VMEM" in reason


class TestPrefetcherTeardown:
    def test_service_drain_reaps_all_workers(self, tmp_path):
        from sagecal_tpu_torch.apps.config import ServeConfig
        from sagecal_tpu_torch.io import dataset as dsmod
        from sagecal_tpu_torch.serve.request import load_requests
        from sagecal_tpu_torch.serve.service import CalibrationService
        from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

        before = list(dsmod._ACTIVE_PREFETCHERS)
        manifest = make_synthetic_workload(str(tmp_path / "w"), 3,
                                           n_tenants=2, device="cpu")
        CalibrationService(ServeConfig(out_dir=str(tmp_path / "out"),
                                       batch=2),
                           log=lambda *a: None, device="cpu").run(
            load_requests(manifest))
        assert dsmod._ACTIVE_PREFETCHERS == before

    def test_error_path_still_reaps_workers(self, tmp_path):
        from sagecal_tpu_torch.apps.config import ServeConfig
        from sagecal_tpu_torch.io import dataset as dsmod
        from sagecal_tpu_torch.serve.request import SolveRequest
        from sagecal_tpu_torch.serve.service import CalibrationService
        from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

        manifest = make_synthetic_workload(str(tmp_path / "w"), 1,
                                           n_tenants=1, device="cpu")
        dataset = json.load(open(manifest))["requests"][0]["dataset"]
        req = SolveRequest(
            request_id="r0", tenant="t0", dataset=dataset,
            sky_model=str(tmp_path / "missing-sky.txt"), t0=0, tilesz=2)
        svc = CalibrationService(
            ServeConfig(out_dir=str(tmp_path / "out"), batch=2),
            log=lambda *a: None, device="cpu")
        before = list(dsmod._ACTIVE_PREFETCHERS)
        with pytest.raises(FileNotFoundError):
            svc.run([req])
        assert dsmod._ACTIVE_PREFETCHERS == before


class TestStreamPoolCap:
    @staticmethod
    def _keys(tmp_path):
        from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

        manifest = make_synthetic_workload(str(tmp_path / "w"), 2,
                                           n_tenants=2,
                                           shapes=((7, 4, 2), (7, 4, 2)),
                                           device="cpu")
        paths = [r["dataset"] for r in json.load(open(manifest))["requests"]]
        return [(f"t{i}", os.path.abspath(p), 2, "vis")
                for i, p in enumerate(paths)]

    def test_lru_eviction_is_counted_and_transparent(self, tmp_path):
        """Two streams under a cap of one open prefetcher: touching them
        alternately closes the LRU stream (counted in
        ``serve_prefetch_evictions_total``), and every reopened stream
        resumes from its remaining tiles."""
        from sagecal_tpu_torch.io import dataset as dsmod
        from sagecal_tpu_torch.obs import registry
        from sagecal_tpu_torch.serve.service import _StreamPool

        keys = self._keys(tmp_path)
        before = list(dsmod._ACTIVE_PREFETCHERS)
        pool = _StreamPool(cap=1)
        for k in keys:
            pool.register(k, [0, 2], np.float64)
        registry.set_telemetry(True)
        try:
            reg = registry.get_registry()
            c0 = reg.get_counter("serve_prefetch_evictions_total")
            seen = []
            for k in (keys[0], keys[1], keys[0], keys[1]):
                t0, (tile,) = pool.next_tile(k)
                seen.append((k[0], t0))
                assert len(pool._open_streams) <= 1
            c1 = reg.get_counter("serve_prefetch_evictions_total")
        finally:
            registry.set_telemetry(None)
        # touches 2 and 3 each evict the other stream; touch 4 does not:
        # touch 3 drained t0, which self-closes (not an eviction)
        assert seen == [("t0", 0), ("t1", 0), ("t0", 2), ("t1", 2)]
        assert pool.evictions == 2 and c1 - c0 == 2
        pool.close()
        assert dsmod._ACTIVE_PREFETCHERS == before

    def test_unbounded_pool_never_evicts(self, tmp_path):
        from sagecal_tpu_torch.serve.service import _StreamPool

        keys = self._keys(tmp_path)
        pool = _StreamPool(cap=0)
        for k in keys:
            pool.register(k, [0, 2], np.float64)
        for k in (keys[0], keys[1], keys[0], keys[1]):
            pool.next_tile(k)
        assert pool.evictions == 0
        pool.close()


class TestRequestManifest:
    def _write(self, tmp_path, doc):
        p = tmp_path / "r.json"
        p.write_text(json.dumps(doc))
        return str(p)

    def _req(self, i=0, **kw):
        base = dict(request_id=f"r{i}", tenant="t", dataset="d.h5",
                    sky_model="s.txt", t0=0, tilesz=2)
        base.update(kw)
        return base

    def test_round_trip_matches_jax(self, tmp_path):
        from sagecal_tpu.serve.request import load_requests as jload
        from sagecal_tpu_torch.serve.request import load_requests

        path = self._write(tmp_path, {"requests": [
            self._req(), self._req(1, solver_mode=2, trace_id="x",
                                   cluster_file="c.txt")]})
        got = [dataclasses.asdict(r) for r in load_requests(path)]
        assert got == [dataclasses.asdict(r) for r in jload(path)]
        assert got[0]["cluster_file"] == "s.txt.cluster"
        assert got[0]["solver_mode"] is None  # inherits the default
        assert load_requests(self._write(tmp_path, [self._req()]))[0] \
            .request_id == "r0"

    def test_rejects_duplicates_missing_unknown(self, tmp_path):
        from sagecal_tpu_torch.serve.request import load_requests

        with pytest.raises(ValueError, match="duplicate"):
            load_requests(self._write(tmp_path,
                                      [self._req(), self._req()]))
        with pytest.raises(ValueError, match="missing required"):
            load_requests(self._write(tmp_path, [{"request_id": "x"}]))
        with pytest.raises(ValueError, match="unknown fields"):
            load_requests(self._write(tmp_path, [self._req(bogus=1)]))
        with pytest.raises(ValueError, match="request_id"):
            load_requests(self._write(
                tmp_path, [self._req(request_id="../evil")]))

    def test_result_manifest_atomic_write(self, tmp_path):
        from sagecal_tpu_torch.serve.request import (
            result_manifest_path, write_result_manifest,
        )

        path = write_result_manifest(
            str(tmp_path), {"request_id": "r0", "verdict": "ok"})
        assert path == result_manifest_path(str(tmp_path), "r0")
        assert json.load(open(path))["verdict"] == "ok"
        assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


SERVE_ARGVS = [
    [],
    ["--requests", "r.json", "--out-dir", "o", "--batch", "16", "--resume",
     "--f32"],
    ["--synthetic", "3", "--tenants", "3", "-e", "1", "-g", "4", "-l", "6",
     "-m", "5", "-j", "1", "-L", "3", "-H", "20", "-R", "--fused",
     "--coh-dtype", "bf16", "--abort-on-divergence"],
    ["--shadow-rate", "0.5", "--shadow-budget-s", "9", "--shadow-seed", "2",
     "--abort-on-drift", "--slo", "slo.json", "--checkpoint-every", "2",
     "--checkpoint-dir", "ck", "--aot-store", "st", "--max-streams", "3",
     "-V"],
]


class TestServeCli:
    @pytest.mark.parametrize("i", range(len(SERVE_ARGVS)))
    def test_flags_parse_into_the_jax_config(self, i):
        from sagecal_tpu.apps.serve import build_parser as jparser
        from sagecal_tpu.apps.serve import config_from_args as jconfig
        from sagecal_tpu_torch.apps.serve import (
            build_parser, config_from_args,
        )

        want = dataclasses.asdict(jconfig(jparser().parse_args(
            SERVE_ARGVS[i])))
        got = dataclasses.asdict(config_from_args(build_parser().parse_args(
            SERVE_ARGVS[i])))
        assert got == want

    def test_parser_has_the_reference_flags(self):
        from sagecal_tpu.apps.serve import build_parser as jparser
        from sagecal_tpu_torch.apps.serve import build_parser

        def flags(p):
            return {(a.dest, tuple(a.option_strings), a.default)
                    for a in p._actions}

        assert flags(build_parser()) == flags(jparser())

    def test_cli_dispatches_serve(self, tmp_path):
        from sagecal_tpu_torch.apps.cli import main

        rc = main(["serve", "--synthetic", "2", "--tenants", "1", "--batch",
                   "2", "--out-dir", str(tmp_path / "out")], device="cpu")
        assert rc == 0
        for i in range(2):
            doc = json.load(open(tmp_path / "out" / f"req00{i}.result.json"))
            assert doc["verdict"] == "ok" and doc["batch"] == 2

    def test_cli_returns_3_on_abort(self, tmp_path, monkeypatch, capsys):
        """Every request diverges (the test lowers the residual-ratio
        guard, as no flag sets it) under --abort-on-divergence."""
        import sagecal_tpu_torch.apps.serve as app
        from sagecal_tpu_torch.apps.cli import main

        run = app.run_serve

        def low_ratio(cfg, **kw):
            cfg.res_ratio = 1e-9
            return run(cfg, **kw)

        monkeypatch.setattr(app, "run_serve", low_ratio)
        rc = main(["serve", "--synthetic", "1", "--tenants", "1", "--batch",
                   "2", "--abort-on-divergence", "--out-dir",
                   str(tmp_path / "out")], device="cpu")
        assert rc == 3
        assert "diverged" in capsys.readouterr().err

    @pytest.mark.parametrize("argv,item", [
        (["--resume"], "A9"), (["--checkpoint-every", "1"], "A9"),
        (["--checkpoint-dir", "ck"], "A9"), (["--aot-store", "store"], "A9")])
    def test_unported_options_exit_2_naming_their_item(
            self, tmp_path, monkeypatch, capsys, argv, item):
        """The options that waited for ``item`` (A9) now run: a one-
        request service exits 0 with each (``--resume`` finds no
        checkpoint and serves; the kernel store holds nothing on the
        CPU, where no kernel is built)."""
        from sagecal_tpu_torch.apps.cli import main

        assert item == "A9"
        out = tmp_path / "out"
        argv = [a if a != "ck" else str(tmp_path / "ck") for a in argv]
        rc = main(["serve", "--synthetic", "1", "--tenants", "1",
                   "--batch", "1", "-e", "1", "-g", "2", "-l", "3",
                   "--out-dir", str(out), *argv], device="cpu")
        assert rc == 0
        assert os.path.exists(out / "req000.result.json")
        if "--checkpoint-every" in argv:
            assert os.listdir(out / "serve.ckpt" / "tenants" / "tenant0") \
                == ["ckpt_t000000.npz"]


class TestPaddedLaneGuard:
    def test_padding_lane_never_reaches_finish_request(self, tmp_path):
        """A replication-padded lane carries a COPY of a real request's
        solve outputs: its quality must never reach ``_finish_request``,
        or it would fire a second verdict for a request that has its
        own."""
        from types import SimpleNamespace

        import torch

        from sagecal_tpu_torch.apps.config import ServeConfig
        from sagecal_tpu_torch.serve.bucket import bucket_of
        from sagecal_tpu_torch.serve.service import CalibrationService

        (entry,) = _entries(tmp_path, ServeConfig(), 1)
        svc = CalibrationService(
            ServeConfig(out_dir=str(tmp_path / "out"), batch=2),
            log=lambda *a: None, device="cpu")
        batch = 2

        def fake_solve(*args, **kw):
            return SimpleNamespace(
                p=torch.zeros((batch,) + tuple(entry.p0.shape),
                              dtype=entry.p0.dtype),
                res_0=torch.ones(batch), res_1=torch.full((batch,), 0.5),
                diverged=torch.zeros(batch, dtype=torch.bool),
                mean_nu=torch.zeros(batch), quality=None)

        svc.cache.get_with_status = lambda *a, **k: (fake_solve, True)
        finished = []
        svc._finish_request = lambda entry, bucket, lane, *a: \
            finished.append(lane)
        svc._dispatch(bucket_of(entry.data, entry.cdata, entry.p0), "fp",
                      [entry], batch, None, padded_flush=True)
        # ONE real request in a 2-lane batch: lane 1 is padding
        assert finished == [0]
