"""Run-identity fingerprints (the first part of
``sagecal_tpu/elastic/checkpoint.py``, copied: that module is stdlib and
numpy only but cannot be imported without JAX).

:func:`config_fingerprint` gives the same hex string as the reference
for the same fields, because the serve path keys its executable-cache
entries and buckets with it.  ``CheckpointManager``, the ``.npz``
checkpoint format and resume wait for ROADMAP.md's A9.
"""

from __future__ import annotations

import hashlib
import json


class ResumeRefused(RuntimeError):
    """--resume found a checkpoint that does not belong to this run
    configuration (fingerprint mismatch) or is from an incompatible
    schema.  The CLI maps this to its own exit code so supervisors can
    tell 'stale checkpoint dir' from a solver failure."""


def config_fingerprint(**fields) -> str:
    """Stable hex digest of a run's identity.

    Callers pass everything that must match for two runs to count as
    the same: dataset path(s) and shape metadata, sky/cluster file
    paths, and the solver options that change the numerics.  Values
    must be JSON-able scalars / lists."""
    doc = json.dumps(fields, sort_keys=True, separators=(",", ":"),
                     default=str)
    return hashlib.sha256(doc.encode("utf-8")).hexdigest()
