"""The per-layer metrics of source ``program_span`` on the CPU: the five
readers on a made-up record of the program's spans and host reads, under
their names split by configuration, and a program without the record
(each reads None)."""

from __future__ import annotations

import os

import pytest

from benchmark.harness.cell import LayerContext, load_module, read_metric
from benchmark.tests.tiny import BENCH

QUANTITIES = ("em_host_reads_per_tile", "em_read_wait_s_per_tile",
              "em_wall_s_per_tile", "lbfgs_wall_s_per_tile",
              "app_self_s_per_tile")
CONFIGS = ("lofar_hba_62st", "ska_low_512st")
LOFAR = dict(M=100, N=62, rows=226920, F=2, nc=1)
SKA = dict(M=25, N=512, rows=1308160, F=2, nc=1)


def _span(spans, name, ts, dur, parent=None):
    sid = f"s{len(spans)}"
    spans.append({"name": name, "span_id": sid, "ts": ts, "dur": dur,
                  "parent_id": parent})
    return sid


def _record():
    """Two tiles: each a 10 s tile span; coherencies 1 s, solve 6 s (EM
    4 s with two cluster solves of two reads each and a nerr read, LBFGS
    1.5 s with one read), residual 1 s; a read-back outside the solve."""
    from sagecal_tpu_torch.obs.trace import TraceRecord

    spans = []
    run = _span(spans, "fullbatch", 0.0, 21.0)
    for k, t0 in enumerate((0.5, 10.5)):
        tile = _span(spans, "tile", t0, 10.0, run)
        _span(spans, "coherencies", t0 + 0.5, 1.0, tile)
        solve = _span(spans, "solve", t0 + 2.0, 6.0, tile)
        em = _span(spans, "sage.em", t0 + 2.0, 4.0, solve)
        _span(spans, "read:sage.nerr", t0 + 2.0, 0.01, em)
        for c in range(2):
            cl = _span(spans, "sage.em.cluster", t0 + 2.1 + c, 1.0, em)
            _span(spans, "read:lm.done", t0 + 2.2 + c, 0.1, cl)
            _span(spans, "read:lm.solve_check", t0 + 2.5 + c, 0.2, cl)
        lb = _span(spans, "sage.lbfgs", t0 + 6.0, 1.5, solve)
        it = _span(spans, "lbfgs.iter", t0 + 6.0, 1.0, lb)
        _span(spans, "read:lbfgs.fold", t0 + 6.5, 0.05, it)
        _span(spans, "app.readback", t0 + 8.0, 0.2, tile)
        _span(spans, "read:fullbatch.readback", t0 + 8.1, 0.1, tile)
        _span(spans, "residual", t0 + 8.5, 1.0, tile)
    return TraceRecord(spans, {"lm.done": 4, "lm.solve_check": 4,
                               "sage.nerr": 2, "lbfgs.fold": 2,
                               "fullbatch.readback": 2})


def _read(name, ctx):
    return load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                       "m_" + name.replace(".", "_")).read(ctx)


def _ctx(shapes):
    return LayerContext(reduction=None, spans={}, tiles=2, shapes=shapes)


@pytest.fixture
def recorded(monkeypatch):
    from sagecal_tpu_torch.obs import trace

    monkeypatch.setattr(trace, "_LAST", _record())


def test_readers_on_a_made_up_record(recorded):
    ctx = _ctx(LOFAR)
    want = {"em_host_reads_per_tile": 5.0,
            "em_read_wait_s_per_tile": 0.01 + 2 * (0.1 + 0.2),
            "em_wall_s_per_tile": 4.0, "lbfgs_wall_s_per_tile": 1.5,
            # 10 s less coherencies, solve and residual
            "app_self_s_per_tile": 10.0 - 1.0 - 6.0 - 1.0}
    for q, v in want.items():
        assert _read(q, ctx) == pytest.approx(v), q


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("quantity", QUANTITIES)
def test_a_name_split_by_configuration_reads_the_quantity(recorded,
                                                          quantity, config):
    """``<quantity>.<config>``, the name an entry of ``BENCHMARK.json``
    gives it, reads ``metrics/<quantity>.py`` through the harness."""
    ctx = _ctx(LOFAR if config == "lofar_hba_62st" else SKA)
    assert read_metric(BENCH, f"{quantity}.{config}", ctx) == \
        pytest.approx(_read(quantity, ctx))


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_no_record_reads_nothing(quantity, monkeypatch):
    from sagecal_tpu_torch.obs import trace

    monkeypatch.setattr(trace, "_LAST", None)
    assert _read(quantity, _ctx(LOFAR)) is None
    # a record without a tile span (a run outside the app) neither
    monkeypatch.setattr(trace, "_LAST", trace.TraceRecord(
        [{"name": "sage.em", "span_id": "a", "parent_id": None, "ts": 0.0,
          "dur": 1.0}], {}))
    assert _read(quantity, _ctx(LOFAR)) is None
    # a program without the accessor (one older than the record)
    monkeypatch.delattr(trace, "last_record")
    assert _read(quantity, _ctx(LOFAR)) is None

