"""The port's protocol model checker (``analysis/fsmodel.py``,
``analysis/protocol_check.py``) on the CPU, held against the JAX
package's.

- ``SimFS`` against a real tmpdir: the same crash-free two-worker lease
  script on the port's ``LeaseQueue`` leaves the same file names and
  contents in both (tests/test_protocol.py's differential);
- ``explore`` of each default queue scenario and ``explore_stream`` at
  the JAX CLI test's bounds (``--crashes 0 --ticks 1``) and at the
  default bounds (1 crash, 2 ticks): the same state, replay and
  adoption counts as the reference's, complete, no violation;
- each seeded mutant caught by both checkers with the same violation
  kinds.
"""

import json
import os

import pytest

from test_protocol import EXPECTED_VIOLATIONS


def _drive_lease_script(queue_a, queue_b):
    """tests/test_protocol.py's crash-free two-worker schedule (claim,
    contend, renew, release, steal, complete) on the port's queue."""
    from sagecal_tpu_torch.fleet.queue import LeaseQueue, WorkItem

    for q in (queue_a, queue_b):
        assert q.claim.__func__ is LeaseQueue.claim  # real code, no mock
    queue_a.put(WorkItem(request_id="r1", tenant="t", request={"k": 1}),
                now=1000.0)
    queue_a.put(WorkItem(request_id="r2", tenant="t", request={"k": 2}),
                now=1000.0)
    assert queue_a.claim("r1", now=1000.0) is True
    assert queue_b.claim("r1", now=1001.0) is False  # live contention
    assert queue_b.claim("r2", now=1001.0) is True
    assert queue_a.renew("r1", now=1005.0) == 1015.0
    queue_b.release("r2", now=1006.0)
    assert queue_a.claim("r2", now=1007.0) is True
    assert queue_b.claim("r1", now=1015.0) is True  # steal after the TTL
    queue_b.complete("r1", now=1016.0)
    queue_a.complete("r2", now=1017.0)
    assert queue_a.done_ids() == {"r1", "r2"}


def test_simfs_matches_real_tmpdir(tmp_path):
    from sagecal_tpu_torch.analysis.fsmodel import SimClock, SimFS
    from sagecal_tpu_torch.fleet.queue import LeaseQueue

    real_root = str(tmp_path / "q")
    _drive_lease_script(LeaseQueue(real_root, worker="wA", ttl_s=10.0),
                        LeaseQueue(real_root, worker="wB", ttl_s=10.0))
    sim, clock = SimFS(), SimClock(1000.0)
    _drive_lease_script(
        LeaseQueue("/q", worker="wA", ttl_s=10.0, fs=sim, clock=clock.now),
        LeaseQueue("/q", worker="wB", ttl_s=10.0, fs=sim, clock=clock.now))
    real = {n: open(os.path.join(real_root, n)).read()
            for n in os.listdir(real_root) if not n.startswith(".")}
    simd = {n.rsplit("/", 1)[-1]: t for n, t in sim.files.items()}
    assert sorted(real) == sorted(simd)
    assert {n: json.loads(t) for n, t in real.items()} == \
        {n: json.loads(t) for n, t in simd.items()}


def _counts(rep):
    d = rep.to_dict()
    d.pop("elapsed_s", None)
    return d


@pytest.mark.parametrize("crashes,ticks", [(0, 1), (1, 2)])
@pytest.mark.parametrize("scenario", [0, 1, 2])
def test_queue_scenario_matches_reference(crashes, ticks, scenario):
    from sagecal_tpu.analysis import protocol_check as jpc
    from sagecal_tpu_torch.analysis import protocol_check as pc

    reps = []
    for mod in (pc, jpc):
        name, cfg = mod.default_scenarios(2, crashes, ticks)[scenario]
        rep = mod.explore(cfg, scenario=name)
        assert rep.ok and rep.complete and rep.violations == []
        reps.append(_counts(rep))
    assert reps[0] == reps[1]
    assert reps[0]["states"] > 300


@pytest.mark.parametrize("ticks,crashes", [(1, 0), (2, 1), (3, 1)])
def test_stream_model_matches_reference(ticks, crashes, monkeypatch):
    """Equal state counts, and equal owner-lease gate calls and passes
    (the adoption attempts that the gate let through; the report itself
    holds no adoption count, but a model with none is a violation)."""
    import importlib

    reps = []
    for pkg in ("sagecal_tpu_torch", "sagecal_tpu"):
        ck = importlib.import_module(f"{pkg}.elastic.checkpoint")
        mod = importlib.import_module(f"{pkg}.analysis.protocol_check")
        gate, seen = ck.check_owner_lease, {"calls": 0, "passes": 0}

        def counted(*a, _gate=gate, _seen=seen, **k):
            _seen["calls"] += 1
            _gate(*a, **k)
            _seen["passes"] += 1

        monkeypatch.setattr(ck, "check_owner_lease", counted)
        rep = _counts(mod.explore_stream(mod.StreamConfig(
            tick_budget=ticks, crash_budget=crashes)))
        reps.append((rep, seen))
    assert reps[0] == reps[1]
    (rep, seen), _ = reps
    assert rep["ok"] and rep["violations"] == [] and rep["complete"]
    assert seen["passes"] > 0 and seen["calls"] > seen["passes"]


def test_every_mutation_has_an_expectation():
    from sagecal_tpu_torch.analysis.protocol_check import MUTATIONS

    assert set(MUTATIONS) == set(EXPECTED_VIOLATIONS)


@pytest.mark.parametrize("name", sorted(EXPECTED_VIOLATIONS))
def test_mutant_caught_alike(name):
    from sagecal_tpu.analysis.protocol_check import run_mutation as jrun
    from sagecal_tpu_torch.analysis.protocol_check import run_mutation

    got, want = run_mutation(name), jrun(name)
    kinds = sorted({v.kind for v in got.violations})
    assert kinds == sorted({v.kind for v in want.violations})
    assert set(kinds) & EXPECTED_VIOLATIONS[name], (name, kinds)
    assert all(len(v.trace) > 0 for v in got.violations)
