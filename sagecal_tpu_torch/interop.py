"""Carry tiles and results between the JAX package and the port as numpy.

:func:`tile_from_numpy` turns a tile given as numpy arrays (what
``np.asarray`` of the JAX package's ``VisData``, ``ClusterData`` and
``p0`` yields) into the port's :class:`VisData`, :class:`ClusterData`
and ``p0`` on a chosen device; :func:`batch_from_numpy` does the same
for a serve bucket (a list of tiles, or one dict of stacked arrays);
:func:`result_to_numpy` turns a port :class:`SageResult`, solo or
batched, back into numpy.  :func:`sources_from_numpy` and
:func:`shapelets_from_numpy` carry a sky (a ``SourceBatch`` and a
``ShapeletTable``) across, and :func:`sources_to_numpy` /
:func:`shapelets_to_numpy` bring it back.  :func:`geometry_from_numpy`,
:func:`pointing_from_numpy` and :func:`coeffs_from_numpy` carry a beam
(``StationGeometry``, ``BeamPointing``, ``ElementCoeffs``).  The
consensus ADMM's state crosses with :func:`admm_result_to_numpy` (every
``AdmmResult`` field), :func:`admm_state_from_numpy` (``p_bands``, Y, Z,
rho and the like as tensors), :func:`consensus_config_to_numpy` /
:func:`consensus_config_from_numpy` (a ``ConsensusConfig``) and
:func:`ledger_to_numpy` / :func:`ledger_from_numpy` (a
``StalenessLedger``).  Numpy only in, numpy only out: this module does
not import ``sagecal_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sagecal_tpu_torch.core.types import VisData
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.ops.beam import (
    BeamPointing, ElementCoeffs, StationGeometry,
)
from sagecal_tpu_torch.ops.rime import ShapeletTable, SourceBatch
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


SOURCE_FIELDS = tuple(f.name for f in dataclasses.fields(SourceBatch))
TABLE_ARRAYS = ("modes", "beta", "eX", "eY", "eP")


def _field(obj, k):
    return obj[k] if isinstance(obj, dict) else getattr(obj, k)


def sources_from_numpy(src, device=None) -> SourceBatch:
    """A source batch given as a dict of numpy arrays (or any object with
    the fields as attributes that ``np.asarray`` reads, e.g. the JAX
    package's ``SourceBatch``) -> the port's :class:`SourceBatch` on
    ``device``; dtypes kept (``stype``/``shapelet_idx`` int32)."""
    dev = resolve_device(device)
    return SourceBatch(**{
        k: torch.from_numpy(np.array(_field(src, k))).to(dev)
        for k in SOURCE_FIELDS})


def sources_to_numpy(src: SourceBatch) -> dict:
    return {k: getattr(src, k).detach().cpu().numpy() for k in SOURCE_FIELDS}


def shapelets_from_numpy(tab, device=None) -> ShapeletTable:
    """A shapelet table (dict of numpy arrays plus ``n0max``, or an
    object with those attributes) -> the port's :class:`ShapeletTable`."""
    dev = resolve_device(device)
    return ShapeletTable(
        **{k: torch.from_numpy(np.array(_field(tab, k))).to(dev)
           for k in TABLE_ARRAYS},
        n0max=int(_field(tab, "n0max")))


def shapelets_to_numpy(tab: ShapeletTable) -> dict:
    out = {k: getattr(tab, k).detach().cpu().numpy() for k in TABLE_ARRAYS}
    out["n0max"] = tab.n0max
    return out


GEOMETRY_ARRAYS = ("longitude", "latitude", "x", "y", "z", "elem_mask")


def geometry_from_numpy(geom, device=None) -> StationGeometry:
    """A station geometry (a dict of numpy arrays plus ``bf_type``, or an
    object with those attributes, e.g. the JAX package's
    ``StationGeometry``) -> the port's, float64, on ``device``."""
    dev = resolve_device(device)
    return StationGeometry(
        **{k: torch.from_numpy(np.array(_field(geom, k), np.float64)).to(dev)
           for k in GEOMETRY_ARRAYS},
        bf_type=int(_field(geom, "bf_type")))


def pointing_from_numpy(pointing) -> BeamPointing:
    """A pointing (a 5-sequence or dict of ra0, dec0, b_ra0, b_dec0, f0)
    -> the port's :class:`BeamPointing`."""
    if isinstance(pointing, dict):
        return BeamPointing(**{k: float(v) for k, v in pointing.items()})
    return BeamPointing(*(float(v) for v in pointing))


def coeffs_from_numpy(coeff, device=None) -> ElementCoeffs:
    """Element coefficients (a dict or an object with pattern_theta,
    pattern_phi, preamble, beta, M) -> the port's, on ``device``."""
    dev = resolve_device(device)
    return ElementCoeffs(
        **{k: torch.from_numpy(np.array(_field(coeff, k))).to(dev)
           for k in ("pattern_theta", "pattern_phi", "preamble")},
        beta=float(_field(coeff, "beta")), M=int(_field(coeff, "M")))


ADMM_RESULT_FIELDS = ("p", "Y", "Z", "rho", "dual_res", "primal_res",
                      "Zspat", "spat_res", "Zspat_diff", "primal_res_band",
                      "dual_res_band", "rho_trace")


def admm_result_to_numpy(res) -> dict:
    """An ``AdmmResult`` of either package (tensors or arrays) -> numpy
    arrays by field name; absent (None) fields are left out."""
    out = {}
    for k in ADMM_RESULT_FIELDS:
        v = getattr(res, k, None)
        if v is None:
            continue
        out[k] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v))
    return out


def admm_state_from_numpy(arrays: dict, device=None) -> dict:
    """ADMM state arrays (``p_bands``, ``Y``, ``Z``, ``rho``, ``B``, ...;
    any dict of numpy arrays) -> tensors on ``device``, dtypes kept."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev)
            for k, v in arrays.items()}


CONSENSUS_FIELDS = ("zstep", "cluster_groups", "staleness",
                    "staleness_discount", "slot_schedule", "group_schedule")


def consensus_config_to_numpy(ccfg) -> dict:
    """A ``ConsensusConfig`` of either package, or a dict of its fields
    -> a dict (schedules as int32 arrays, None kept)."""
    out = {k: _field(ccfg, k) for k in CONSENSUS_FIELDS}
    for k in ("slot_schedule", "group_schedule"):
        if out[k] is not None:
            out[k] = np.asarray(out[k], np.int32)
    return out


def consensus_config_from_numpy(obj):
    """A dict of :data:`CONSENSUS_FIELDS` (or an object with them, e.g.
    the JAX package's ``ConsensusConfig``) -> the port's
    ``ConsensusConfig``."""
    from sagecal_tpu_torch.parallel.consensus import ConsensusConfig

    return ConsensusConfig(**consensus_config_to_numpy(obj))


def ledger_to_numpy(ledger) -> dict:
    """A ``StalenessLedger`` of either package -> ``{"ages", "zterms",
    "round_index"}``."""
    return {"ages": np.asarray(ledger.ages, np.int64).copy(),
            "zterms": np.array(ledger.zterms),
            "round_index": int(ledger.round_index)}


def ledger_from_numpy(obj):
    """:func:`ledger_to_numpy`'s dict (or a ledger of either package) ->
    the port's ``StalenessLedger``."""
    from sagecal_tpu_torch.parallel.async_consensus import StalenessLedger

    d = obj if isinstance(obj, dict) else ledger_to_numpy(obj)
    z = np.array(d["zterms"])
    led = StalenessLedger(z.shape[0], z.shape[1:], z.dtype,
                          round_index=int(d["round_index"]))
    led.zterms = z
    led.ages = np.asarray(d["ages"], np.int64).copy()
    return led
