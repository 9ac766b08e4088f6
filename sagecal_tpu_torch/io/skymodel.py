"""Sky-model (LSM) and cluster text-file parsing, reference-compatible.

Counterpart of ``sagecal_tpu/io/skymodel.py`` for point-source skies:

- sky line: ``name h m s d m s I Q U V si [si1 si2] RM eX eY eP f0``
  (RA hours -> rad via pi/12, dec degrees -> rad, negative-zero aware);
- cluster line: ``cluster_id chunk_size source1 source2 ...``; a
  negative cluster_id means "do not subtract from data";
- the source type comes from the first character of the name (G/g
  Gaussian, D/d disk, R/r ring, S/s shapelet, anything else point).

- shapelet mode files ``<name>.fits.modes`` beside the sky file,
  gathered into one sky-global :class:`ShapeletTable`;
- the per-cluster ADMM regularization file (``-G``).

Parsing is numpy on the host; :func:`build_source_batch` puts the
batches on the requested device.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.ops.rime import (
    ST_DISK, ST_GAUSSIAN, ST_POINT, ST_RING, ST_SHAPELET, ShapeletTable,
    SourceBatch,
)

_FWHM_TO_SIGMA = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))


@dataclasses.dataclass
class SkySource:
    name: str
    ra: float
    dec: float
    sI: float
    sQ: float
    sU: float
    sV: float
    spec_idx: float
    spec_idx1: float
    spec_idx2: float
    eX: float
    eY: float
    eP: float
    f0: float


@dataclasses.dataclass
class ClusterDef:
    cluster_id: int
    nchunk: int
    source_names: list
    subtract: bool  # False when cluster_id < 0


def _hms_to_rad(h: float, m: float, s: float) -> float:
    neg = h < 0.0 or (h == 0.0 and math.copysign(1.0, h) < 0)
    mag = (abs(h) + m / 60.0 + s / 3600.0) * math.pi / 12.0
    return -mag if neg else mag


def _dms_to_rad(d: float, m: float, s: float) -> float:
    neg = d < 0.0 or (d == 0.0 and math.copysign(1.0, d) < 0)
    mag = (abs(d) + m / 60.0 + s / 3600.0) * math.pi / 180.0
    return -mag if neg else mag


def parse_skymodel(path: str, three_term_spectra: Optional[bool] = None) -> dict:
    """Parse an LSM sky-model file -> {name: SkySource}.  The 3-term
    spectra format (``-F 1``) is auto-detected from the token count
    (17 vs 19) when ``three_term_spectra`` is None."""
    sources: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("//"):
                continue
            tok = line.split()
            if len(tok) < 17:
                continue
            fmt3 = (three_term_spectra if three_term_spectra is not None
                    else len(tok) >= 19)
            name = tok[0]
            vals = [float(x) for x in tok[1: 19 if fmt3 else 17]]
            (rahr, ramin, rasec, decd, decmin, decsec, sI, sQ, sU, sV) = vals[:10]
            if fmt3:
                si, si1, si2, _rm, eX, eY, eP, f0 = vals[10:18]
            else:
                si, _rm, eX, eY, eP, f0 = vals[10:16]
                si1 = si2 = 0.0
            if f0 <= 0.0:
                f0 = 1.0
            sources[name] = SkySource(
                name=name, ra=_hms_to_rad(rahr, ramin, rasec),
                dec=_dms_to_rad(decd, decmin, decsec),
                sI=sI, sQ=sQ, sU=sU, sV=sV,
                spec_idx=si, spec_idx1=si1, spec_idx2=si2,
                eX=eX, eY=eY, eP=eP, f0=f0,
            )
    return sources


def parse_clusters(path: str) -> list:
    """Parse a cluster file -> [ClusterDef] (raw signed cluster ids)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("//"):
                continue
            tok = line.split()
            if len(tok) < 3:
                continue
            cid = int(tok[0])
            out.append(ClusterDef(cluster_id=cid, nchunk=max(1, int(tok[1])),
                                  source_names=tok[2:], subtract=cid >= 0))
    return out


def _source_type(s: SkySource) -> int:
    c = s.name[0].upper()
    return {"G": ST_GAUSSIAN, "D": ST_DISK, "R": ST_RING,
            "S": ST_SHAPELET}.get(c, ST_POINT)


def build_source_batch(srcs: list, ra0: float, dec0: float,
                       dtype=torch.float32, device=None) -> SourceBatch:
    """SourceBatch for a list of SkySource at phase centre (ra0, dec0);
    lmn as the reference computes them (nn stored as n-1), projection
    angles and Gaussian fwhm -> sigma for extended types; shapelet
    sources numbered 0, 1, ... in batch order (``shapelet_idx``)."""
    S = len(srcs)
    g = lambda: np.zeros(S, np.float64)
    ll, mm, nn = g(), g(), g()
    sI0, sQ0, sU0, sV0 = g(), g(), g(), g()
    f0, si, si1, si2 = np.ones(S), g(), g(), g()
    stype = np.zeros(S, np.int32)
    ex_a, ex_b, ex_cp, ex_sp = g(), g(), np.ones(S), g()
    cxi, sxi, cphi, sphi = np.ones(S), g(), np.ones(S), g()
    shapelet_idx = np.full(S, -1, np.int32)
    n_shap = 0
    for i, s in enumerate(srcs):
        dra = s.ra - ra0
        ll[i] = math.cos(s.dec) * math.sin(dra)
        mm[i] = (math.sin(s.dec) * math.cos(dec0)
                 - math.cos(s.dec) * math.sin(dec0) * math.cos(dra))
        n_raw = (math.sin(s.dec) * math.sin(dec0)
                 + math.cos(s.dec) * math.cos(dec0) * math.cos(dra))
        nn[i] = n_raw - 1.0
        sI0[i], sQ0[i], sU0[i], sV0[i] = s.sI, s.sQ, s.sU, s.sV
        f0[i], si[i], si1[i], si2[i] = s.f0, s.spec_idx, s.spec_idx1, s.spec_idx2
        st = _source_type(s)
        stype[i] = st
        if st != ST_POINT:
            n_abs = abs(n_raw)
            phi = math.acos(min(1.0, n_abs))
            xi = math.atan2(-ll[i], mm[i])
            if st == ST_GAUSSIAN and not n_abs < 0.998:
                cxi[i], sxi[i], cphi[i], sphi[i] = 1.0, 0.0, 1.0, 0.0
            else:
                cxi[i], sxi[i] = math.cos(xi), math.sin(-xi)
                cphi[i], sphi[i] = math.cos(phi), math.sin(-phi)
            if st == ST_GAUSSIAN:
                ex_a[i] = s.eX * _FWHM_TO_SIGMA
                ex_b[i] = s.eY * _FWHM_TO_SIGMA
                ex_cp[i], ex_sp[i] = math.cos(s.eP), math.sin(s.eP)
            elif st in (ST_DISK, ST_RING):
                ex_a[i] = s.eX
            else:
                ex_a[i] = s.eX if s.eX else 1.0
                ex_b[i] = s.eY if s.eY else 1.0
                ex_cp[i], ex_sp[i] = math.cos(s.eP), math.sin(s.eP)
                shapelet_idx[i] = n_shap
                n_shap += 1
    dev = resolve_device(device)
    cast = lambda x: torch.as_tensor(x, dtype=dtype).to(dev)
    return SourceBatch(
        ll=cast(ll), mm=cast(mm), nn=cast(nn),
        sI0=cast(sI0), sQ0=cast(sQ0), sU0=cast(sU0), sV0=cast(sV0),
        f0=cast(f0), spec_idx=cast(si), spec_idx1=cast(si1),
        spec_idx2=cast(si2), stype=torch.as_tensor(stype).to(dev),
        ex_a=cast(ex_a), ex_b=cast(ex_b), ex_cp=cast(ex_cp), ex_sp=cast(ex_sp),
        cxi=cast(cxi), sxi=cast(sxi), cphi=cast(cphi), sphi=cast(sphi),
        shapelet_idx=torch.as_tensor(shapelet_idx).to(dev),
    )


def load_sky(sky_path: str, cluster_path: str, ra0: float, dec0: float,
             dtype=torch.float32, three_term_spectra=None, device=None):
    """Files -> ([SourceBatch per cluster], [ClusterDef],
    ShapeletTable | None).

    Shapelet (S-type) sources also load ``<name>.fits.modes`` from the
    sky file's directory into ONE sky-global :class:`ShapeletTable`, and
    each batch's ``shapelet_idx`` is remapped from cluster-local to
    global rows; the table is None when the sky has no shapelet source.
    Batches land on ``device`` (CUDA unless ``device="cpu"``)."""
    sky = parse_skymodel(sky_path, three_term_spectra)
    cdefs = parse_clusters(cluster_path)
    directory = os.path.dirname(os.path.abspath(sky_path))
    batches = []
    entries = []  # (n0, beta, modes, eX, eY, eP) in global order
    for cd in cdefs:
        missing = [n for n in cd.source_names if n not in sky]
        if missing:
            raise ValueError(f"cluster {cd.cluster_id}: unknown sources {missing}")
        srcs = [sky[n] for n in cd.source_names]
        batch = build_source_batch(srcs, ra0, dec0, dtype, device)
        shap = [s for s in srcs if _source_type(s) == ST_SHAPELET]
        if shap:
            offset = len(entries)
            for s in shap:
                n0, beta, modes = read_shapelet_modes(s.name, directory)
                entries.append((n0, beta, modes, s.eX or 1.0, s.eY or 1.0,
                                s.eP))
            idx = batch.shapelet_idx
            batch.shapelet_idx = torch.where(
                idx >= 0, idx + offset, torch.full_like(idx, -1))
        batches.append(batch)
    tab = (build_shapelet_table(entries, dtype, device) if entries
           else None)
    return batches, cdefs, tab


def build_shapelet_table(entries, dtype=torch.float32,
                         device=None) -> ShapeletTable:
    """A sky-global :class:`ShapeletTable` from ``(n0, beta, modes, eX,
    eY, eP)`` tuples; models with n0 < n0max zero-pad their (n2, n1)
    mode grid (exact: unused coefficients contribute nothing)."""
    n0max = max(e[0] for e in entries)
    K = len(entries)
    modes = np.zeros((K, n0max * n0max))
    beta, eX, eY, eP = (np.empty(K) for _ in range(4))
    for k, (n0, b, m, ex, ey, ep) in enumerate(entries):
        grid = np.zeros((n0max, n0max))
        grid[:n0, :n0] = np.asarray(m).reshape(n0, n0)  # (n2, n1)
        modes[k] = grid.reshape(-1)
        beta[k], eX[k], eY[k], eP[k] = b, ex, ey, ep
    dev = resolve_device(device)
    cast = lambda x: torch.as_tensor(x, dtype=dtype).to(dev)
    return ShapeletTable(modes=cast(modes), beta=cast(beta), eX=cast(eX),
                         eY=cast(eY), eP=cast(eP), n0max=int(n0max))


def read_cluster_rho(path: str, cdefs: list, spatialreg: bool = False):
    """Per-cluster ADMM regularization file (``-G``): one line per
    cluster, ``cluster_id hybrid admm_rho [spatial_alpha]``.  Values
    follow ``cdefs`` by cluster id when every id is present, else file
    order.  Returns (rho (M,), alpha (M,) or None), numpy."""
    entries = []
    with open(path) as fh:
        for line in fh:
            s = line.strip()
            if not s or s.startswith("#") or s.startswith("//"):
                continue
            tok = s.split()
            if len(tok) < 3:
                continue
            cid, hyb, rho = int(tok[0]), int(tok[1]), float(tok[2])
            alpha = float(tok[3]) if (spatialreg and len(tok) > 3) else 0.0
            entries.append((cid, hyb, rho, alpha))
    M = len(cdefs)
    if len(entries) < M:
        raise ValueError(f"{path}: {len(entries)} entries for {M} clusters")
    by_id = {e[0]: e for e in entries}
    ordered = ([by_id[cd.cluster_id] for cd in cdefs]
               if all(cd.cluster_id in by_id for cd in cdefs)
               else entries[:M])
    rho = np.asarray([e[2] for e in ordered])
    alpha = np.asarray([e[3] for e in ordered]) if spatialreg else None
    return rho, alpha


def read_shapelet_modes(name: str, directory: str = "."):
    """``<name>.fits.modes`` -> (n0, beta, modes (n0*n0,)): after six
    ignored numbers (RA, Dec), n0 and beta, then (index, value) pairs
    whose values are taken in file order."""
    path = os.path.join(directory, name + ".fits.modes")
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals.extend(float(t) for t in line.split())
    n0 = int(vals[6])
    beta = vals[7]
    rest = vals[8:]
    modes = np.array([rest[2 * k + 1] for k in range(n0 * n0)])
    return n0, beta, modes
