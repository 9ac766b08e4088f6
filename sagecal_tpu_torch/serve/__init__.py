"""Multi-tenant calibration service of the port (counterpart of
``sagecal_tpu/serve``).

Turns a request manifest (many independent tenant/dataset/tile solves)
into batched device work: same-shape requests batch through the
batched solver entries (``solvers/batched.py``), each bucket's route is
decided once behind an executable cache, and per-tenant tile prefetch
double-buffers the dataset reads under the solves.  ``python -m
sagecal_tpu_torch.apps.cli serve`` is the command line
(``apps/serve.py``).  The cross-worker executable store
(``aot_store.py``) comes with the fleet (ROADMAP.md, A9).
"""

from sagecal_tpu_torch.serve.bucket import BucketSpec, bucket_of, pad_indices
from sagecal_tpu_torch.serve.cache import ExecutableCache
from sagecal_tpu_torch.serve.request import (
    SolveRequest,
    load_requests,
    result_manifest_path,
    write_result_manifest,
)
from sagecal_tpu_torch.serve.service import CalibrationService

__all__ = [
    "BucketSpec", "bucket_of", "pad_indices", "ExecutableCache",
    "SolveRequest", "load_requests", "result_manifest_path",
    "write_result_manifest", "CalibrationService",
]
