"""Elastic execution of the port (counterpart of ``sagecal_tpu/elastic``):
crash-consistent checkpoints at tile boundaries, fingerprint-checked
``--resume`` in every app, and the fault-injection harness that proves it
by killing real runs.
"""

from sagecal_tpu_torch.elastic.checkpoint import (  # noqa: F401
    CHECKPOINT_SCHEMA_VERSION,
    CheckpointManager,
    ResumeRefused,
    config_fingerprint,
    find_latest_checkpoint,
    flatten_state,
    read_checkpoint,
    unflatten_state,
    write_checkpoint,
)
