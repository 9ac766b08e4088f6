"""Shape bucketing for the serve path (copy of ``sagecal_tpu/serve/bucket.py``).

A bucket is the shape identity of a batched solve: requests with equal
:class:`BucketSpec` can be stacked into one batch and solved in
lock-step (``solvers/batched.py``).  The spec holds every array shape
(stations, baseline rows, tile size, channels, clusters, chunk padding,
the 8N gain dof), the dtype and the tile's static fields (``freq0``,
``deltaf``, ``deltat``).  Solver options are not part of it.

A ragged last batch of ``k < B`` requests is padded to ``B`` lanes by
replicating real entries round-robin (:func:`pad_indices`); the padded
lanes carry real, finite data, and the validity mask tells the caller
which results to discard.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch


class BucketSpec(NamedTuple):
    """Shape identity of one batched solve (the batch axis excluded)."""

    nstations: int
    nbase: int          # baseline rows per tile (tilesz * nbase_per_t)
    tilesz: int
    nchan: int          # channels
    nclus: int          # M, sky clusters
    nchunk_max: int     # chunk padding of the gains carry
    dof: int            # 8 * nstations, per chunk
    dtype: str          # "float32" / "float64"
    freq0: float
    deltaf: float
    deltat: float

    def short(self) -> str:
        """Compact tag for logs, e.g. ``N7xB84xT2xC1xM2``."""
        return (f"N{self.nstations}xB{self.nbase}xT{self.tilesz}"
                f"xC{self.nchan}xM{self.nclus}")


def _dtype_name(p0) -> str:
    if isinstance(p0, torch.Tensor):
        return str(p0.dtype).replace("torch.", "")
    return str(np.asarray(p0).dtype)


def bucket_of(data, cdata, p0) -> BucketSpec:
    """The bucket of one request, from the port's :class:`VisData`,
    :class:`ClusterData` and initial gains ``p0`` (M, nchunk_max, 8N),
    a tensor or a numpy array."""
    return BucketSpec(
        nstations=int(data.nstations),
        nbase=int(data.vis.shape[-1]),
        tilesz=int(data.tilesz),
        nchan=int(data.vis.shape[0]),
        nclus=int(cdata.coh.shape[0]),
        nchunk_max=int(p0.shape[1]),
        dof=int(p0.shape[2]),
        dtype=_dtype_name(p0),
        freq0=float(data.freq0),
        deltaf=float(data.deltaf),
        deltat=float(data.deltat),
    )


def pad_indices(k: int, batch: int) -> Tuple[List[int], np.ndarray]:
    """Source indices filling a ragged group of ``k`` real entries up to
    ``batch`` lanes, plus the per-lane validity mask.

    ``k >= batch`` is the full-batch case (identity, all valid);
    ``k < batch`` replicates real entries round-robin into the padding
    lanes.  ``k == 0`` is a caller bug."""
    if k <= 0:
        raise ValueError("pad_indices: empty bucket group")
    if k >= batch:
        idx = list(range(k))
        return idx, np.ones(k, dtype=bool)
    idx = list(range(k)) + [i % k for i in range(batch - k)]
    valid = np.zeros(batch, dtype=bool)
    valid[:k] = True
    return idx, valid
