"""Observability of the port (counterpart of ``sagecal_tpu/obs``).

Ported so far: the solver trace records (``records.py``), the metrics
registry (``registry.py``), run manifests and the JSONL event log
(``events.py``), the host side of the quality watchdog (``quality.py``),
the serve path's SLOs (``slo.py``), shadow audits and drift ledger
(``shadow.py``, ``drift.py``) and metrics snapshots (``aggregate.py``),
the span tracer (``trace.py``) and the flight recorder (``flight.py``).
Compile and transfer accounting, contracts, device profiles and the
diagnostics CLI wait for ROADMAP.md's A11; the fleet view for A9.
"""
