"""Near-field (non-admissible) exact prediction on gathered subsets
(counterpart of ``sagecal_tpu/sky/nearfield.py``).

The routing (:func:`sagecal_tpu_torch.sky.tree.route_tiles`) leaves
every (node, baseline-tile) pair that fails the well-separation
criterion as a per-tile list of source indices.  This module gathers
those subsets into one (tiles x max_near) :class:`~sagecal_tpu_torch.
ops.rime.SourceBatch`, zero-flux padded, and runs the exact predict
(``ops/rime.py``) on each tile's rows: the same phase, smearing and
spectral math and the same gradients.  The JAX package maps the
predict over the tiles; here the tiles go one after another.

Padding: a padded slot gathers source 0 and multiplies every Stokes
flux by the 0/1 validity mask, so it contributes exactly zero; its
``f0`` stays source 0's (positive) value, so the spectral log never
sees 0.
"""

from __future__ import annotations

import torch

from sagecal_tpu_torch.ops.rime import SourceBatch, _predict_coherencies


def gather_near_batch(src: SourceBatch, near_src: torch.Tensor,
                      near_valid: torch.Tensor) -> SourceBatch:
    """Per-tile near-field batch: every field (T, Nmax).  Plain gathers
    (differentiable in the source parameters); the validity mask zeroes
    the padded slots' fluxes and makes them plain points."""
    g = src.map(lambda x: x[near_src])
    val = near_valid.to(src.sI0.dtype)
    ival = near_valid.to(torch.int32)
    return g.replace(
        sI0=g.sI0 * val, sQ0=g.sQ0 * val, sU0=g.sU0 * val, sV0=g.sV0 * val,
        stype=g.stype * ival,
        shapelet_idx=torch.where(near_valid > 0, g.shapelet_idx,
                                 torch.full_like(g.shapelet_idx, -1)))


def near_field_tiles(u_t, v_t, w_t, freqs, src: SourceBatch, near_src,
                     near_valid, fdelta: float = 0.0,
                     source_chunk: int = 32) -> torch.Tensor:
    """Near-field coherencies per tile: (T, F, 4, R) complex, the exact
    point-source predict of each tile's gathered subset."""
    batch = gather_near_batch(src, near_src, near_valid)
    return torch.stack([
        _predict_coherencies(u_t[t], v_t[t], w_t[t], freqs,
                             batch.map(lambda x: x[t]), float(fdelta),
                             int(source_chunk))
        for t in range(u_t.shape[0])])
