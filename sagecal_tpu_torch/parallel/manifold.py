"""Manifold (quotient) averaging over the unitary ambiguity of Jones
blocks (counterpart of ``sagecal_tpu/parallel/manifold.py``).

A Jones solution J is determined only up to a right-multiplied unitary
U; before the consensus of the per-frequency solutions, the blocks are
aligned on the quotient manifold (``manifold_average.c:60-200``, per
cluster): a chain projection of every frequency block onto a reference
block, ``niter`` rounds of "mean block J3, project each J_f onto J3 by
the Procrustes rotation polar(J_f^H J3)", then one unitary applied to
each original block.  Frequency blocks are one (Nf, 2N, 2) tensor and
every cluster runs at once.

:func:`polar_unitary_2x2` is the unitary polar factor in closed form,
where the JAX package takes ``U V^H`` of an SVD: for a 2x2 A with
``det A = s e^{i phi}``, ``Q = (A + e^{i phi} adj(A)^H) / t`` with ``t =
sqrt(||A||_F^2 + 2 s)`` (``A = Q P`` and, by Cayley-Hamilton, ``s
P^{-1} = tr(P) I - P`` with ``tr P = t``).  It is elementwise, so a
batch of thousands of 2x2 blocks is a few fused operations on the card
instead of a batched SVD.  Where A has full rank Q is unique and both
forms agree to rounding.  Where A is singular Q is not unique: this
form takes ``e^{i phi} = 1`` (rank 1: the unitary that maps A's row
space to its column space and the adjugate's pair of null vectors onto
each other with no phase; A = 0: the identity), where the SVD takes
LAPACK's null vectors.  ``J @ Q`` is still unique, and agrees, whenever
the singularity comes from J itself (A = J^H J_ref with J of rank 1).
"""

from __future__ import annotations

import torch


def polar_unitary_2x2(A: torch.Tensor) -> torch.Tensor:
    """Unitary polar factor of trailing 2x2 complex matrices in closed
    form (module doc)."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    s = det.abs()
    phase = torch.where(s > 0, det / torch.where(s > 0, s, torch.ones_like(s)),
                        torch.ones_like(det))
    # adj(A)^H = [[conj d, -conj c], [-conj b, conj a]]
    q00 = a + phase * d.conj()
    q01 = b - phase * c.conj()
    q10 = c - phase * b.conj()
    q11 = d + phase * a.conj()
    t = torch.sqrt((A.abs() ** 2).sum(dim=(-2, -1)) + 2.0 * s)
    ok = t > 0
    tinv = torch.where(ok, 1.0 / torch.where(ok, t, torch.ones_like(t)),
                       torch.zeros_like(t))
    Q = torch.stack([torch.stack([q00, q01], dim=-1),
                     torch.stack([q10, q11], dim=-1)], dim=-2)
    Q = Q * tinv[..., None, None]
    eye = torch.eye(2, dtype=A.dtype, device=A.device)
    return torch.where(ok[..., None, None], Q, eye)


def procrustes_project(J: torch.Tensor, J_ref: torch.Tensor) -> torch.Tensor:
    """min_U ||J_ref - J U|| over unitary U; returns J @ U
    (``project_procrustes_block``, manifold_average.c:266,346).
    J, J_ref: (..., 2N, 2)."""
    A = J.conj().transpose(-1, -2) @ J_ref  # (..., 2, 2)
    return J @ polar_unitary_2x2(A)


def _jones_stack_to_blocks(Y: torch.Tensor) -> torch.Tensor:
    """(..., Nf, N, 2, 2) Jones -> (..., Nf, 2N, 2) tall blocks (column
    j of the block = column j of every station's Jones, stations
    stacked)."""
    return Y.transpose(-3, -2).reshape(Y.shape[:-3] + (2 * Y.shape[-3], 2))


def _blocks_to_jones_stack(B: torch.Tensor, N: int) -> torch.Tensor:
    return B.reshape(B.shape[:-2] + (2, N, 2)).transpose(-3, -2)


def _average_blocks(J: torch.Tensor, niter: int, ref_idx: int):
    """The three steps of the module doc on blocks (..., Nf, 2N, 2), the
    frequency axis third from last.  Returns (aligned originals, mean
    (..., 2N, 2))."""
    J_orig = J
    J = procrustes_project(J, J[..., ref_idx:ref_idx + 1, :, :])
    for _ in range(niter):
        J = procrustes_project(J, J.mean(dim=-3, keepdim=True))
    J3 = J.mean(dim=-3, keepdim=True)
    return procrustes_project(J_orig, J3), J3[..., 0, :, :]


def manifold_average_cluster(Y: torch.Tensor, niter: int = 20,
                             ref_idx: int = 0):
    """Align one cluster's per-frequency Jones sets: Y (Nf, N, 2, 2)
    complex -> (Y_aligned (Nf, N, 2, 2), quotient mean (N, 2, 2))."""
    N = Y.shape[-3]
    out, mean = _average_blocks(_jones_stack_to_blocks(Y), niter, ref_idx)
    return _blocks_to_jones_stack(out, N), _blocks_to_jones_stack(mean, N)


def manifold_average(Y: torch.Tensor, niter: int = 20,
                     ref_idx: int = 0) -> torch.Tensor:
    """``calculate_manifold_average`` (manifold_average.c:204): align
    per-frequency Jones over the unitary quotient, every cluster at once.
    Y: (Nf, M, N, 2, 2) complex -> aligned, same shape."""
    N = Y.shape[2]
    blocks = _jones_stack_to_blocks(Y.transpose(0, 1))  # (M, Nf, 2N, 2)
    out, _ = _average_blocks(blocks, niter, ref_idx)
    return _blocks_to_jones_stack(out, N).transpose(0, 1)


def manifold_average_projectback(Y: torch.Tensor,
                                 niter: int = 10) -> torch.Tensor:
    """Federated-averaging variant (``calculate_manifold_average_
    projectback``, manifold_average.c:809): every frequency slot gets the
    quotient mean expressed in its own frame, mean @ polar(mean^H J_f).
    Y: (Nf, M, N, 2, 2) -> same shape."""
    N = Y.shape[2]
    J_orig = _jones_stack_to_blocks(Y.transpose(0, 1))  # (M, Nf, 2N, 2)
    _, mean = _average_blocks(J_orig, niter, 0)  # (M, 2N, 2)
    A = mean.conj().transpose(-1, -2)[:, None] @ J_orig  # (M, Nf, 2, 2)
    out = mean[:, None] @ polar_unitary_2x2(A)
    return _blocks_to_jones_stack(out, N).transpose(0, 1)


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
