"""Carry tiles and results between the JAX package and the port as numpy.

:func:`tile_from_numpy` turns a tile given as numpy arrays (what
``np.asarray`` of the JAX package's ``VisData``, ``ClusterData`` and
``p0`` yields) into the port's :class:`VisData`, :class:`ClusterData`
and ``p0`` on a chosen device; :func:`batch_from_numpy` does the same
for a serve bucket (a list of tiles, or one dict of stacked arrays);
:func:`result_to_numpy` turns a port :class:`SageResult`, solo or
batched, back into numpy.  Numpy only in, numpy only out:
this module does not import ``sagecal_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from sagecal_tpu_torch.core.types import VisData
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.solvers.sage import ClusterData, SageResult

VIS_ARRAYS = ("u", "v", "w", "ant_p", "ant_q", "vis", "mask", "freqs",
              "time_idx")
INDEX_ARRAYS = ("ant_p", "ant_q", "time_idx", "chunk_map", "nchunk")


def _tensor(name, x, dev):
    t = torch.from_numpy(np.array(x))  # a writable, contiguous copy
    if name in INDEX_ARRAYS:
        t = t.to(torch.int64)
    return t.to(dev)


def tile_from_numpy(arrays: dict, device=None):
    """numpy tile -> (VisData, ClusterData, p0) on ``device``.

    ``arrays`` holds ``u, v, w, ant_p, ant_q, vis, mask, freqs, time_idx``
    and the static fields ``freq0, deltaf, deltat, tilesz, nbase,
    nstations`` of the visibilities; ``coh, chunk_map, nchunk`` of the
    cluster data; and ``p0`` of shape (M, nchunk_max, 8N).  Dtypes are
    kept (index arrays become int64)."""
    dev = resolve_device(device)
    data = VisData(
        **{k: _tensor(k, arrays[k], dev) for k in VIS_ARRAYS},
        freq0=float(arrays["freq0"]), deltaf=float(arrays["deltaf"]),
        deltat=float(arrays["deltat"]), tilesz=int(arrays["tilesz"]),
        nbase=int(arrays["nbase"]), nstations=int(arrays["nstations"]),
    )
    cdata = ClusterData(**{k: _tensor(k, arrays[k], dev)
                           for k in ("coh", "chunk_map", "nchunk")})
    return data, cdata, _tensor("p0", arrays["p0"], dev)


def batch_from_numpy(arrays, device=None):
    """numpy batch -> the port's stacked (VisData, ClusterData, p0) on
    ``device``, as ``solvers/batched.py`` takes them.

    ``arrays`` is a list of per-lane tile dicts (:func:`tile_from_numpy`'s
    contract; their static fields must agree) or one such dict whose
    arrays already carry a leading lane axis (``p0`` (B, M, nchunk_max,
    8N))."""
    if isinstance(arrays, dict):
        return tile_from_numpy(arrays, device)
    from sagecal_tpu_torch.solvers.batched import stack_lanes

    return stack_lanes([tile_from_numpy(a, device) for a in arrays])


def result_to_numpy(res: SageResult) -> dict:
    """Port SageResult -> {"p", "res_0", "res_1", "mean_nu", "diverged"}
    as numpy arrays."""
    return {k: getattr(res, k).detach().cpu().numpy()
            for k in ("p", "res_0", "res_1", "mean_nu", "diverged")}
