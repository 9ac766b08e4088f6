"""Baseline enumeration and tiling (copy of ``sagecal_tpu/core/baselines.py``).

Flat index arrays (numpy) that the RIME and the solvers use as gather
indices.  Kept as a copy because importing ``sagecal_tpu`` pulls in JAX.
"""

from __future__ import annotations

import numpy as np


def generate_baselines(nstations: int) -> tuple[np.ndarray, np.ndarray]:
    """All cross-correlation pairs p < q; (ant_p, ant_q) int32 arrays of
    length N(N-1)/2, in the reference's nested station-loop order."""
    p, q = np.triu_indices(nstations, k=1)
    return p.astype(np.int32), q.astype(np.int32)


def tile_baselines(
    nstations: int, tilesz: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Baseline index arrays for a tile of ``tilesz`` timeslots:
    (ant_p, ant_q, time_idx), each nbase*tilesz long, baseline fastest."""
    p, q = generate_baselines(nstations)
    nbase = p.shape[0]
    ant_p = np.tile(p, tilesz)
    ant_q = np.tile(q, tilesz)
    time_idx = np.repeat(np.arange(tilesz, dtype=np.int32), nbase)
    return ant_p, ant_q, time_idx


def count_baselines(nstations: int) -> int:
    return nstations * (nstations - 1) // 2
