"""Port vs JAX package: the checkpoint format and manager
(``elastic/checkpoint.py``) and the registry's ``restore_state``.

- schema v1 round trip (meta and named arrays), no temp file left
  behind, a wrong schema refused, a torn newest file skipped for the
  older intact one;
- ``config_fingerprint`` equal to the JAX package's for each app's field
  set (the fields each app passes, with representative values);
- a port-written checkpoint read by the JAX package's
  ``read_checkpoint`` and a JAX-written one read by the port: the same
  meta keys, array names and values;
- ``flatten_state`` names and shapes equal the JAX package's on the
  minibatch app's LBFGS memory and the federated app's state (its band
  memories stacked as the JAX package holds them);
- the manager's cadence, retention, refusal and crash flusher;
- ``MetricsRegistry.restore_state`` folds a state as the JAX package's
  does.
All comparisons are exact.
"""

import os

import numpy as np
import pytest
import torch

# each app's config_fingerprint fields (sagecal_tpu/apps/*.py and
# serve/service.py), with values of the right types
FIELDS = {
    "fullbatch": dict(
        app="fullbatch", dataset="/d/a.h5", sky_model="/d/s.txt",
        cluster_file="/d/s.txt.cluster", nstations=7, ntime=4, nchan=2,
        freq0=150e6, n_clusters=2, nchunk_max=1, tilesz=2, solver_mode=3,
        max_emiter=3, max_iter=2, max_lbfgs=10, lbfgs_m=7, nulow=2.0,
        nuhigh=30.0, randomize=True, use_f64=True, whiten=False,
        in_column="vis", skip_tiles=0, max_tiles=0, init_solutions=None),
    "serve": dict(
        app="serve", tenant="t0",
        requests=[("r0", "/d/a.h5", 0, 2, "vis"),
                  ("r1", "/d/a.h5", 2, 2, "vis")], use_f64=False),
    "distributed": dict(
        app="distributed", datasets=["/d/b0.h5", "/d/b1.h5"],
        sky_model="/d/s.txt", cluster_file="/d/s.txt.cluster",
        nstations=7, ntime=4, nbands=2, freqs=[140e6, 150e6], nadmm=3,
        tilesz=2, solver_mode=3, max_emiter=1, max_iter=2, npoly=2,
        poly_type=2, admm_rho=5.0, use_f64=True, in_column="vis",
        skip_tiles=0, max_tiles=0, spatial_n0=0, adaptive_rho=False,
        consensus_zstep="grouped", consensus_cluster_groups=1,
        consensus_staleness=0, consensus_staleness_discount=1.0),
    "minibatch": dict(
        app="minibatch", dataset="/d/a.h5", sky_model="/d/s.txt",
        cluster_file="/d/s.txt.cluster", nstations=7, ntime=4, nchan=4,
        bands=2, epochs=1, minibatches=2, admm_iters=2, npoly=2,
        poly_type=2, admm_rho=5.0, consensus_staleness=1,
        consensus_staleness_discount=0.5, solver_mode=3, max_lbfgs=10,
        lbfgs_m=7, nulow=2.0, nuhigh=30.0, use_f64=True, in_column="vis"),
    "federated": dict(
        app="federated", datasets=["/d/b0.h5"], sky_model="/d/s.txt",
        cluster_file="/d/s.txt.cluster", nstations=7, ntime=4, nbands=1,
        freqs=[150e6], nadmm=2, epochs=1, minibatches=2, tilesz=2,
        npoly=2, poly_type=2, admm_rho=5.0, alpha=5.0, robust_nu=None,
        reset_ratio=5.0, max_lbfgs=10, lbfgs_m=7, use_f64=True,
        in_column="vis"),
    "spatial": dict(
        app="spatial", band_pattern="", sky="", clusters="", synthetic=3,
        nstations=5, seed=5, tilesz=2, bands=3, solver_mode=3,
        max_emiter=1, max_iter=2, use_f64=True),
    "widefield": dict(
        app="widefield", nstations=6, ntiles=3, tilesz=2, nchan=1,
        nsources=120, nblobs=6, nclusters=3, fov=0.1, freq0=30e6,
        extent_m=80.0, seed=0, order=8, theta=1.5, exact=False,
        solver_mode=3, max_emiter=1, max_iter=2, max_lbfgs=3,
        use_f64=True),
    "refine": dict(
        app="refine", dataset="", sky="", clusters="", synthetic=5,
        seed=3, perturb=1.15, tilesz=2, spec="SkySpec(flux=((0, 0),))",
        gradient="implicit", inner_iters=12, cg_iters=32, ridge=1e-2,
        use_f64=True),
}


@pytest.mark.parametrize("app", list(FIELDS))
def test_config_fingerprint_matches_jax(app):
    from sagecal_tpu.elastic.checkpoint import config_fingerprint as jfp
    from sagecal_tpu_torch.elastic.checkpoint import config_fingerprint

    assert config_fingerprint(**FIELDS[app]) == jfp(**FIELDS[app])


def _arrays():
    rng = np.random.default_rng(0)
    return {"p": rng.standard_normal((2, 1, 56)),
            "results": rng.standard_normal((3, 2)),
            "done": np.array([1, 0, 1], np.uint8)}


def test_round_trip_leaves_no_temp_file(tmp_path):
    from sagecal_tpu_torch.elastic.checkpoint import (
        checkpoint_path, read_checkpoint, write_checkpoint,
    )

    path = checkpoint_path(str(tmp_path), 3)
    want = _arrays()
    write_checkpoint(path, {**want, "t": torch.arange(3.0).numpy()},
                     {"app": "x", "tile_index": 3, "tiles_done": 4})
    assert os.listdir(tmp_path) == ["ckpt_t000003.npz"]
    meta, got = read_checkpoint(path)
    assert meta["schema_version"] == 1 and meta["tiles_done"] == 4
    assert set(got) == set(want) | {"t"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="reserved"):
        write_checkpoint(path, {"__meta__": np.zeros(1)}, {})


def test_wrong_schema_is_refused(tmp_path):
    from sagecal_tpu_torch.elastic.checkpoint import (
        read_checkpoint, write_checkpoint,
    )

    path = str(tmp_path / "ckpt_t000000.npz")
    write_checkpoint(path, _arrays(), {"schema_version": 2})
    with pytest.raises(ValueError, match="schema v2"):
        read_checkpoint(path)
    np.savez(path, p=np.zeros(2))
    with pytest.raises(ValueError, match="no __meta__"):
        read_checkpoint(path)


def test_torn_newest_checkpoint_falls_back_to_the_older(tmp_path):
    from sagecal_tpu_torch.elastic.checkpoint import (
        checkpoint_path, find_latest_checkpoint, list_checkpoints,
        write_checkpoint,
    )

    d = str(tmp_path)
    for t in (0, 1, 2):
        write_checkpoint(checkpoint_path(d, t), _arrays(),
                         {"tile_index": t})
    with open(checkpoint_path(d, 2), "r+b") as f:
        f.truncate(100)
    assert [os.path.basename(p) for p in list_checkpoints(d)] == [
        "ckpt_t000002.npz", "ckpt_t000001.npz", "ckpt_t000000.npz"]
    seen = []
    meta, _, path = find_latest_checkpoint(d, log=seen.append)
    assert meta["tile_index"] == 1 and path.endswith("ckpt_t000001.npz")
    assert len(seen) == 1 and "unreadable" in seen[0]
    assert find_latest_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_read(tmp_path, writer):
    from sagecal_tpu.elastic import checkpoint as jck
    from sagecal_tpu_torch.elastic import checkpoint as tck

    w, r = (tck, jck) if writer == "port" else (jck, tck)
    path = w.checkpoint_path(str(tmp_path), 1)
    meta = {"app": "fullbatch", "fingerprint": "f" * 64, "tile_index": 1,
            "tiles_done": 2, "run_id": "abc"}
    w.write_checkpoint(path, _arrays(), meta)
    wm, wa = w.read_checkpoint(path)
    rm, ra = r.read_checkpoint(path)
    assert rm == wm and set(rm) >= set(meta)
    assert sorted(ra) == sorted(wa) == sorted(_arrays())
    for k in ra:
        assert np.array_equal(ra[k], wa[k])


def test_flatten_state_names_match_jax_on_lbfgs_memory():
    from sagecal_tpu.elastic.checkpoint import flatten_state as jflat
    from sagecal_tpu.solvers.lbfgs import LBFGSMemory as JMem
    from sagecal_tpu_torch.elastic.checkpoint import (
        flatten_state, unflatten_state,
    )
    from sagecal_tpu_torch.solvers.lbfgs import LBFGSMemory

    want = jflat("mem0", JMem.init(12, 5, np.float64))
    mem = LBFGSMemory.init(12, 5, torch.float64, device="cpu")
    mem.s[1, 2] = 3.0
    mem.vacant, mem.niter = 2, 7
    got = flatten_state("mem0", mem)
    assert list(got) == list(want)
    assert [v.shape for v in got.values()] == [
        v.shape for v in want.values()]
    back = unflatten_state("mem0", got, LBFGSMemory.init(
        12, 5, torch.float64, device="cpu"))
    assert back.vacant == 2 and back.niter == 7
    assert isinstance(back.vacant, int)
    assert torch.equal(back.s, mem.s)


def test_flatten_state_names_match_jax_on_federated_state():
    import jax.numpy as jnp

    from sagecal_tpu.elastic.checkpoint import flatten_state as jflat
    from sagecal_tpu.parallel.federated import (
        init_federated_state as jinit,
    )
    from sagecal_tpu_torch.apps.federated import _stacked, _unstacked
    from sagecal_tpu_torch.elastic.checkpoint import (
        flatten_state, unflatten_state,
    )
    from sagecal_tpu_torch.parallel.federated import init_federated_state

    want = jflat("state", jinit(3, 2, 1, 40, 2, 5, jnp.float64))
    state = init_federated_state(3, 2, 1, 40, 2, 5, torch.float64,
                                 device="cpu")
    state.mem[1].s[0, 0] = 4.0
    state.mem[2].nfilled = 3
    got = flatten_state("state", _stacked(state))
    assert list(got) == list(want)
    assert [v.shape for v in got.values()] == [
        v.shape for v in want.values()]
    fresh = init_federated_state(3, 2, 1, 40, 2, 5, torch.float64,
                                 device="cpu")
    back = _unstacked(unflatten_state("state", got, _stacked(fresh)), fresh)
    assert back.mem[2].nfilled == 3 and back.mem[1].s[0, 0] == 4.0
    assert torch.equal(back.p, state.p)


def _manager(tmp_path, **kw):
    from sagecal_tpu_torch.elastic.checkpoint import CheckpointManager

    return CheckpointManager(str(tmp_path / "ck"), "fp", "fullbatch", **kw)


def test_manager_cadence_and_retention(tmp_path):
    mgr = _manager(tmp_path, every=2, keep=2)
    written = [mgr.update(t, {"p": torch.full((2,), float(t))},
                          tiles_done=t + 1) for t in range(5)]
    assert [w is not None for w in written] == [False, True, False, True,
                                                False]
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_t000001.npz",
                                                    "ckpt_t000003.npz"]
    assert mgr.flush().endswith("ckpt_t000004.npz")
    assert mgr.flush() is None  # nothing newer than the last file
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_t000003.npz",
                                                    "ckpt_t000004.npz"]
    meta, arrays, _ = _manager(tmp_path).resume()
    assert meta["tiles_done"] == 5 and arrays["p"][0] == 4.0
    mgr.close()


def test_manager_refuses_another_configuration(tmp_path):
    from sagecal_tpu_torch.elastic.checkpoint import (
        CheckpointManager, ResumeRefused,
    )

    mgr = _manager(tmp_path)
    mgr.update(0, {"p": np.zeros(2)}, tiles_done=1)
    mgr.close()
    for fp, app in (("other", "fullbatch"), ("fp", "distributed")):
        with pytest.raises(ResumeRefused, match="refusing to resume"):
            CheckpointManager(str(tmp_path / "ck"), fp, app).resume()
    assert _manager(tmp_path / "empty").resume() is None


def test_manager_crash_flusher_writes_the_pending_state(tmp_path):
    from sagecal_tpu_torch.obs import flight

    mgr = _manager(tmp_path, every=10)
    assert mgr.update(0, {"p": np.ones(2)}, tiles_done=1) is None
    flight._run_crash_flushers()  # what SIGTERM and the excepthook run
    assert os.listdir(tmp_path / "ck") == ["ckpt_t000000.npz"]
    assert flight.last_checkpoint_path().endswith("ckpt_t000000.npz")
    mgr.close()
    mgr.update(1, {"p": np.ones(2)}, tiles_done=2)  # registers again
    mgr.close()
    flight._run_crash_flushers()  # unregistered: nothing written
    assert os.listdir(tmp_path / "ck") == ["ckpt_t000000.npz"]


def test_registry_restore_state_matches_jax():
    from sagecal_tpu.obs.registry import MetricsRegistry as JReg
    from sagecal_tpu_torch.obs.registry import MetricsRegistry

    def fill(reg):
        reg.counter_inc("served_total", 3, tenant="t0")
        reg.gauge_set("depth", 4.0, tenant="t0")
        reg.observe("latency", 0.3, tenant="t0")
        reg.observe("latency", 7.0, tenant="t0")

    src, jsrc = MetricsRegistry(), JReg()
    fill(src)
    fill(jsrc)
    got, want = MetricsRegistry(), JReg()
    got.gauge_set("depth", 1.0, tenant="t0")
    want.gauge_set("depth", 1.0, tenant="t0")
    for _ in range(2):
        got.restore_state(src.export_state())
        want.restore_state(jsrc.export_state())
    assert got.export_state() == want.export_state()
    assert got.get_counter("served_total", tenant="t0") == 6.0
    assert got.get_gauge("depth", tenant="t0") == 1.0
