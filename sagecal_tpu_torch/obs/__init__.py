"""Observability of the port (counterpart of ``sagecal_tpu/obs``).

Ported so far: the solver trace records (``records.py``), the metrics
registry (``registry.py``), run manifests and the JSONL event log
(``events.py``) and the host side of the quality watchdog
(``quality.py``).  Tracing, the flight recorder, compile and transfer
accounting and the diagnostics CLI wait for ROADMAP.md's A11.
"""
