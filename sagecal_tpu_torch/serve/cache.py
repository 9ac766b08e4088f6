"""Bucketed executable cache of the serve path (the in-process tier of
``sagecal_tpu/serve/cache.py``).

One entry per ``(BucketSpec, solver fingerprint)``: the batched-solve
callable (:func:`sagecal_tpu_torch.solvers.batched.sagefit_packed_batch`)
with its kernel route baked in (:func:`_solve_fn`).  The reference
compiles one XLA executable per entry; the port compiles nothing per
bucket (its CUDA kernels are built once per source digest,
``kernels/build.py``), so an entry is the callable itself and a hit
means the bucket's route was decided before.  Hits, misses and entries
behave exactly as the reference's, so both packages report the same
stats for the same manifest.

Counters live in two places on purpose, as in the reference:

- plain ints on the cache object (``hits``/``misses``/``stats()``), so
  tests can assert reuse with telemetry off;
- registry counters ``serve_executable_cache_{hits,misses}_total``
  labelled by bucket.

The cross-worker store tier (``serve/aot_store.py``) goes with the
fleet's workers (ROADMAP.md, A9).
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Tuple

from sagecal_tpu_torch.serve.bucket import BucketSpec


def _solve_fn(batched_fused: bool) -> Callable:
    """The batched-solve entry with the kernel route BAKED IN:
    ``batched_fused`` selects the batched fused kernels or the lane by
    lane solve, so each cache entry closes over its routing decision."""
    from sagecal_tpu_torch.solvers.batched import sagefit_packed_batch

    if not batched_fused:
        return sagefit_packed_batch
    return functools.partial(sagefit_packed_batch, batched_fused=True)


class ExecutableCache:
    """Maps ``(bucket, fingerprint)`` -> the batched-solve callable,
    building (and counting) on miss."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[BucketSpec, str], Callable] = {}
        self.hits = 0
        self.misses = 0

    def get_with_status(self, bucket: BucketSpec, fingerprint: str,
                        batched_fused: bool = False) -> Tuple[Callable, bool]:
        """The entry for this bucket+numerics (the
        ``sagefit_packed_batch`` signature), created on first touch, and
        whether the lookup was a hit (``(fn, True)``) or built it
        (``(fn, False)``).  ``batched_fused`` selects the route baked
        into a NEW entry; it must be deterministic per (bucket,
        fingerprint), which
        :func:`sagecal_tpu_torch.solvers.batched.choose_batched_path`
        is."""
        key = (bucket, fingerprint)
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self.hits += 1
                self._count("hits", bucket)
                return fn, True
            self.misses += 1
            self._count("misses", bucket)
            fn = self._entries[key] = _solve_fn(batched_fused)
            return fn, False

    @staticmethod
    def entry_name(bucket: BucketSpec, fingerprint: str) -> str:
        """The entry's name in logs, per bucket and numerics."""
        return f"serve_batch[{bucket.short()}#{fingerprint[:8]}]"

    def _count(self, kind: str, bucket: BucketSpec) -> None:
        from sagecal_tpu_torch.obs.registry import get_registry

        get_registry().counter_inc(
            f"serve_executable_cache_{kind}_total",
            help=f"serve bucketed-executable cache lookups ({kind})",
            bucket=bucket.short())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries)}
