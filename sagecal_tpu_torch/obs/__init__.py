"""Observability of the port (counterpart of ``sagecal_tpu/obs``).

Ported so far: the solver trace records (``records.py``), the metrics
registry (``registry.py``), run manifests and the JSONL event log
(``events.py``), the host side of the quality watchdog (``quality.py``),
the serve path's SLOs (``slo.py``), shadow audits and drift ledger
(``shadow.py``, ``drift.py``), metrics snapshots and the fleet view
(``aggregate.py``), the span tracer (``trace.py``), the flight recorder
(``flight.py``), the fleet's live timeline and capacity analysis
(``timeline.py``, ``capacity.py``), and the record registry, replay and
conservation audit of a run directory (``ledger.py``, ``replay.py``,
``audit.py``).  Compile and transfer accounting, contracts, device
profiles and the diagnostics CLI wait for ROADMAP.md's A11.
"""
