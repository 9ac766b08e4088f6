"""Serve path of the port (counterpart of ``sagecal_tpu/serve``).

Only the bucketing is ported so far; the request, cache and service
modules wait for later slices (ROADMAP.md, Queue A)."""

from sagecal_tpu_torch.serve.bucket import BucketSpec, bucket_of, pad_indices

__all__ = ["BucketSpec", "bucket_of", "pad_indices"]
