"""Observability of the port (counterpart of ``sagecal_tpu/obs``).

Ported so far: the solver trace records (``records.py``), the metrics
registry (``registry.py``), run manifests and the JSONL event log
(``events.py``), the host side of the quality watchdog (``quality.py``),
and the serve path's SLOs (``slo.py``), shadow audits and drift ledger
(``shadow.py``, ``drift.py``) and metrics snapshots (``aggregate.py``).
Tracing, the flight recorder, compile and transfer accounting and the
diagnostics CLI wait for ROADMAP.md's A11; the fleet view for A9.
"""
