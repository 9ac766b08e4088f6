"""Elastic execution of the port (counterpart of ``sagecal_tpu/elastic``).

Ported so far: the run-identity fingerprint that keys the serve path's
executable cache and ``ResumeRefused``.  The checkpoint manager, the
atomic checkpoint format and ``--resume`` wait for ROADMAP.md's A9.
"""

from sagecal_tpu_torch.elastic.checkpoint import (  # noqa: F401
    ResumeRefused,
    config_fingerprint,
)
