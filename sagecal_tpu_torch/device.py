"""Device selection for the port's entry points.

Every entry point (``make_visdata``, ``load_sky``, ``sagefit``,
``solve_tile``, ...) takes ``device=None`` and resolves it here: ``None``
means the CUDA device, and without one this raises — the port never
quietly runs a GPU workload on the CPU.  Callers that want the CPU (the
tests, small tools) say so with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; any explicit device is taken as given.

    Raises RuntimeError when CUDA is wanted (explicitly or by default)
    and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sagecal_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU explicitly"
        )
    return dev
