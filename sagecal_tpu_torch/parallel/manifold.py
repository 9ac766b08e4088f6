"""Jones-manifold helpers (counterpart of ``sagecal_tpu/parallel/manifold.py``).

Only :func:`extract_phases` is ported so far: the residual correction's
phase-only mode needs it (``ops/residual.py``).  The manifold averaging
of the consensus solvers comes with their slice.
"""

from __future__ import annotations

import torch


def extract_phases(J: torch.Tensor) -> torch.Tensor:
    """Phase-only reduction of a Jones stack (..., 2, 2): the diagonal
    phase-only Jones diag(exp(i arg J00), exp(i arg J11)) (the role of
    ``extract_phases``, manifold_average.c:400)."""
    p00 = torch.exp(1j * torch.angle(J[..., 0, 0]))
    p11 = torch.exp(1j * torch.angle(J[..., 1, 1]))
    z = torch.zeros_like(p00)
    row0 = torch.stack([p00, z], dim=-1)
    row1 = torch.stack([z, p11], dim=-1)
    return torch.stack([row0, row1], dim=-2)
