"""The port's record registry, replay and audit (``obs/ledger.py``,
``obs/replay.py``, ``obs/audit.py``) on the CPU, held against the JAX
package.

- ``registry_table`` equal;
- every registered family's valid record, and its torn, foreign and
  out-of-schema gauntlet (tests/test_audit.py's samples), classified as
  the reference classifies them;
- ``run_audit`` and ``replay`` of both packages on the directories of
  tests/test_audit.py's ``synth_run`` (clean, a skewed worker clock, a
  deadline, and each injection mode): the same report document and the
  same rendered text;
- a port fleet run on the CPU (a coordinator and two worker processes):
  the JAX package's ``ledger.scan_out_dir`` finds every record ``ok``
  (the port writes the reference's schemas), and both packages' audits
  report it clean with the same document.
"""

import json
import os

import pytest
import torch

from test_audit import FAMILY_SAMPLES, synth_run

torch.set_num_threads(1)


def _nz(counts):
    return {k: v for k, v in counts.items() if v}


def test_registry_table_matches_reference():
    from sagecal_tpu.obs import ledger as jledger
    from sagecal_tpu_torch.obs import ledger

    assert ledger.registry_table() == jledger.registry_table()
    assert set(FAMILY_SAMPLES) == {f.name for f in ledger.REGISTRY}


def _gauntlet(ledger, name, path):
    """Each of one family's records classified: valid, torn, foreign and
    out-of-schema (a JSONL file holds all four; a JSON document is
    rewritten for each)."""
    rel, rec = FAMILY_SAMPLES[name]
    fam = ledger.family(name)
    bad = dict(rec)
    bad.pop(next(k for k in fam.required
                 if k not in (fam.kind_field, fam.version_field)))
    assert ledger.match_family(rel).name == name
    texts = [json.dumps(rec), json.dumps(rec)[: len(json.dumps(rec)) // 2],
             json.dumps(["foreign", "payload"]), json.dumps(bad)]
    if fam.container == "jsonl":
        texts = ["\n".join(texts[:1] + texts[2:] + texts[1:2]) + "\n"]
    out = []
    for text in texts:
        with open(path, "w") as fh:
            fh.write(text)
        vf = ledger.read_validated(path, fam)
        out.append([(c.status, c.line_no, c.reason) for c in vf.records])
    return out


@pytest.mark.parametrize("name", sorted(FAMILY_SAMPLES))
def test_family_gauntlet_classified_alike(name, tmp_path):
    from sagecal_tpu.obs import ledger as jledger
    from sagecal_tpu_torch.obs import ledger

    path = str(tmp_path / os.path.basename(FAMILY_SAMPLES[name][0]))
    got = _gauntlet(ledger, name, path)
    assert got == _gauntlet(jledger, name, path)
    statuses = sorted(s for rows in got for s, _, _ in rows)
    assert statuses == sorted(["ok", "torn", "foreign", "out_of_schema"])


def _both(out_dir, **kw):
    from sagecal_tpu.obs import audit as jaudit
    from sagecal_tpu.obs import replay as jreplay
    from sagecal_tpu_torch.obs import audit, replay

    docs = []
    for a, r in ((audit, replay), (jaudit, jreplay)):
        rep = a.run_audit(out_dir, **kw)
        st = r.replay(r.load_run(out_dir)) if not rep.insufficient else None
        docs.append((json.dumps(rep.to_doc(), sort_keys=True),
                     a.format_audit(rep, verbose=True),
                     None if st is None else
                     json.dumps(st.to_doc(), sort_keys=True),
                     None if st is None else r.format_replay(st, True),
                     rep.exit_code(), rep.kinds()))
    return docs


RUNS = {"clean": {}, "skewed": {"skew_s": 45.0},
        "deadline": {"skew_s": 45.0, "deadline": 150.0}}


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("inject", ["", "drop_event", "tear_record",
                                    "forge_manifest", "skew_clock"])
def test_audit_and_replay_match_reference(run, inject, tmp_path,
                                          monkeypatch):
    monkeypatch.delenv("SAGECAL_AUDIT_INJECT", raising=False)
    out = synth_run(str(tmp_path / "run"), **RUNS[run])
    got, want = _both(out, inject=inject)
    assert got == want
    exit_code, kinds = got[4], got[5]
    if inject:
        assert exit_code == 1 and kinds
    elif run == "clean":
        assert exit_code == 0 and kinds == []


def test_insufficient_run_matches_reference(tmp_path):
    (tmp_path / "empty").mkdir()
    got, want = _both(str(tmp_path / "empty"), inject="")
    assert got == want and got[4] == 2


def test_port_fleet_run_records_are_reference_schemas(tmp_path,
                                                      monkeypatch):
    """A port fleet run (coordinator and two CPU worker processes, event
    log on): every record file the JAX registry knows is all ``ok``, no
    record file is unregistered, and both audits pass it alike."""
    from sagecal_tpu.obs import ledger as jledger
    from sagecal_tpu_torch.apps.config import FleetConfig
    from sagecal_tpu_torch.apps.fleet import run_coordinator
    from sagecal_tpu_torch.serve.synthetic import make_synthetic_workload

    monkeypatch.setenv("SAGECAL_TELEMETRY", "1")
    monkeypatch.delenv("SAGECAL_EVENT_LOG", raising=False)
    monkeypatch.delenv("SAGECAL_AUDIT_INJECT", raising=False)
    requests = make_synthetic_workload(str(tmp_path / "w"), 4, n_tenants=2,
                                       device="cpu")
    out = str(tmp_path / "out")
    cfg = FleetConfig(requests=requests, out_dir=out, workers=2, batch=2,
                      lease_ttl_s=10.0, poll_s=0.05, max_idle_s=5.0,
                      max_emiter=1, max_iter=2, max_lbfgs=3, solver_mode=1,
                      max_respawns=0)
    summary = run_coordinator(cfg, log=lambda *a: None, device="cpu")
    assert summary["drained"] and summary["done"] == 4
    scan = jledger.scan_out_dir(out)
    families = {vf.family for vf in scan.files}
    assert {"event", "queue_item", "queue_done", "result_manifest",
            "timeline", "metrics_snapshot"} <= families
    assert scan.unregistered == []
    bad = [(os.path.basename(vf.path), c.line_no, c.status, c.reason)
           for vf in scan.files for c in vf.records if c.status != "ok"]
    assert bad == []
    got, want = _both(out, inject="")
    assert got == want
    assert got[4] == 0 and got[5] == [], got[1]
