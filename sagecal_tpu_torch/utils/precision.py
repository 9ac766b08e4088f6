"""True-f32 matmul policy for the solver entry points.

The counterpart of ``sagecal_tpu/utils/precision.py::true_f32``.  On the
TPU, default-precision f32 matmuls round to ~3 significant digits, and
that was measured to diverge warm-started calibration tiles at the noise
floor (PERF.md, "The precision chapter").  On an NVIDIA card the same
hazard is TF32: cuBLAS and cuDNN may multiply f32 in TF32 (10-bit
mantissa).  Every public solver entry runs under :func:`true_f32`, which
switches TF32 off for matmuls and convolutions for the duration of the
call and restores the caller's settings afterwards.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def full_f32():
    """Context: TF32 off for cuBLAS matmuls and cuDNN convolutions."""
    old_mm = torch.backends.cuda.matmul.allow_tf32
    old_cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_mm
        torch.backends.cudnn.allow_tf32 = old_cudnn


def true_f32(fn):
    """Run ``fn`` under :func:`full_f32` (see module doc)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_f32():
            return fn(*args, **kwargs)

    return wrapped
