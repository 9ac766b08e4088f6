"""Simulated skies with known ground truth (counterpart of
``sagecal_tpu/data/simsky.py``).

A synthetic observation whose generating parameters (fluxes, spectral
indices, shapelet modes, true Jones gains) are known exactly, built on
``io/simulate.py``.  Every draw comes from numpy's seeded
``Generator`` in the JAX package's order, so one seed gives both
packages the same sky, the same gains and the same visibilities.

Cluster 0 holds several point sources (a per-cluster flux scale of a
one-source cluster is absorbed by its gains; with several sources
sharing a gain the fluxes are identifiable); :func:`perturb_flux` scales
one source's flux, the start of a refinement.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from sagecal_tpu_torch.core.types import VisData
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.io.simulate import (
    corrupt_and_observe, make_visdata, random_jones,
)
from sagecal_tpu_torch.ops.rime import (
    ST_SHAPELET, ShapeletTable, SourceBatch, point_source_batch,
)


def shapelet_source_batch(ll, mm, flux, modes, beta: float = 0.01,
                          f0: float = 150e6, dtype=torch.float32,
                          device=None) -> tuple:
    """One ST_SHAPELET source at (ll, mm) with mode coefficients
    ``modes`` ((n0, n0) or flat n0*n0).  Returns (batch, table)."""
    dev = resolve_device(device)
    modes = np.asarray(modes, dtype=np.float64)
    n0 = int(round(np.sqrt(modes.size)))
    if n0 * n0 != modes.size:
        raise ValueError(f"modes must be square, got {modes.size} coeffs")
    src = point_source_batch([ll], [mm], [flux], f0=f0, dtype=dtype,
                             device=dev)
    src = src.replace(
        stype=torch.full((1,), ST_SHAPELET, dtype=torch.int32, device=dev),
        shapelet_idx=torch.zeros((1,), dtype=torch.int32, device=dev))
    full = lambda x: torch.full((1,), x, dtype=dtype, device=dev)
    tab = ShapeletTable(
        modes=torch.as_tensor(modes.reshape(1, n0 * n0), dtype=dtype).to(dev),
        beta=full(beta), eX=full(1.0), eY=full(1.0), eP=full(0.0), n0max=n0)
    return src, tab


@dataclasses.dataclass
class SimulatedSky:
    """A synthetic observation plus the exact parameters that made it."""

    data: VisData
    clusters: List[SourceBatch]
    shapelet_tables: List[Optional[ShapeletTable]]
    jones: torch.Tensor  # true gains (M, N, 2, 2)
    true_flux: List[np.ndarray]  # per-cluster ground-truth sI0
    true_spec_idx: List[np.ndarray]
    true_modes: Optional[np.ndarray]  # (n0, n0) shapelet truth, or None
    freq0: float
    dec0: float
    noise_sigma: float

    @property
    def nclusters(self) -> int:
        return len(self.clusters)


def make_sky(nstations: int = 8, tilesz: int = 2, nchan: int = 2,
             nclusters: int = 2, sources_per_cluster: int = 3,
             freq0: float = 150e6, chan_bw: float = 180e3, dec0: float = 0.9,
             gain_amp: float = 0.1, noise_sigma: float = 0.0,
             spectral: bool = False, shapelet_n0: int = 0, seed: int = 7,
             dtype=np.float64, wide_field: bool = False,
             nsources: int = 10000, fov: float = 1.1,
             cluster_scale: float = 0.004, flux_alpha: float = 2.0,
             flux_min: float = 0.05, extent_m: float = 3000.0,
             device=None) -> SimulatedSky:
    """A point (+ shapelet) sky with known ground truth, observed through
    random Jones gains, on ``device`` (CUDA unless ``device="cpu"``).

    - cluster 0: ``sources_per_cluster`` point sources; clusters 1..:
      one point source each;
    - ``shapelet_n0 > 0`` appends one all-shapelet cluster with an
      ``n0 x n0`` mode table (truth in ``true_modes``);
    - ``spectral=True`` gives every source a known nonzero spectral index;
    - ``gain_amp=0`` observes through identity gains.

    ``wide_field=True``: ``nsources`` point sources in ``nclusters``
    compact Gaussian blobs (sigma ``cluster_scale``) whose centres fill
    a disc of diameter ``fov``, Pareto fluxes (index ``flux_alpha``)
    above ``flux_min``, stations within ``extent_m``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = make_visdata(nstations=nstations, tilesz=tilesz, nchan=nchan,
                        freq0=freq0, chan_bw=chan_bw, dec0=dec0, seed=seed,
                        dtype=dtype, extent_m=extent_m, device=dev)
    rdt = data.u.dtype
    jdtype = np.complex64 if rdt == torch.float32 else np.complex128
    clusters, tables, true_flux, true_si = [], [], [], []

    def add(ll, mm, flux, si):
        src = point_source_batch(ll, mm, flux, f0=freq0, dtype=rdt,
                                 device=dev)
        if spectral:
            src = src.replace(spec_idx=torch.as_tensor(si, dtype=rdt).to(dev))
        clusters.append(src)
        tables.append(None)
        true_flux.append(flux)
        true_si.append(si)

    if wide_field:
        if shapelet_n0 > 0:
            raise ValueError(
                "wide_field skies are point-only (the hierarchical "
                "predict contract); shapelet_n0 must be 0")
        ncl = max(int(nclusters), 1)
        rr = 0.5 * fov * np.sqrt(rng.uniform(0.05, 1.0, ncl))
        ang = rng.uniform(0.0, 2.0 * np.pi, ncl)
        cx, cy = rr * np.cos(ang), rr * np.sin(ang)
        counts = np.full(ncl, int(nsources) // ncl, np.int64)
        counts[: int(nsources) % ncl] += 1
        for k in range(ncl):
            ns = int(counts[k])
            ll = cx[k] + cluster_scale * rng.standard_normal(ns)
            mm = cy[k] + cluster_scale * rng.standard_normal(ns)
            r = np.sqrt(ll * ll + mm * mm)
            shrink = np.where(r > 0.97, 0.97 / np.maximum(r, 1e-12), 1.0)
            ll, mm = ll * shrink, mm * shrink
            flux = flux_min * (1.0 + rng.pareto(flux_alpha, ns))
            si = rng.uniform(-0.9, -0.3, ns) if spectral else np.zeros(ns)
            add(ll, mm, flux, si)
        jones = random_jones(len(clusters), nstations, seed=seed + 1,
                             amp=gain_amp, dtype=jdtype, device=dev)
        data = corrupt_and_observe(data, clusters, jones=jones,
                                   noise_sigma=noise_sigma, seed=seed + 2)
        return SimulatedSky(
            data=data, clusters=clusters, shapelet_tables=tables,
            jones=jones, true_flux=true_flux, true_spec_idx=true_si,
            true_modes=None, freq0=freq0, dec0=dec0, noise_sigma=noise_sigma)

    for k in range(nclusters):
        ns = sources_per_cluster if k == 0 else 1
        ll = rng.uniform(-0.04, 0.04, ns)
        mm = rng.uniform(-0.04, 0.04, ns)
        flux = rng.uniform(1.0, 4.0, ns)
        si = rng.uniform(-0.9, -0.3, ns) if spectral else np.zeros(ns)
        add(ll, mm, flux, si)

    true_modes = None
    if shapelet_n0 > 0:
        modes = rng.normal(0.0, 1.0, (shapelet_n0, shapelet_n0))
        modes[0, 0] = 3.0  # a dominant zeroth mode keeps the source bright
        src, tab = shapelet_source_batch(
            rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02), 1.0, modes,
            beta=0.01, f0=freq0, dtype=rdt, device=dev)
        clusters.append(src)
        tables.append(tab)
        true_flux.append(np.array([1.0]))
        true_si.append(np.zeros(1))
        true_modes = modes

    jones = random_jones(len(clusters), nstations, seed=seed + 1,
                         amp=gain_amp, dtype=jdtype, device=dev)
    data = corrupt_and_observe(
        data, clusters, jones=jones, noise_sigma=noise_sigma, seed=seed + 2,
        shapelet_tables=tables if shapelet_n0 > 0 else None)
    return SimulatedSky(
        data=data, clusters=clusters, shapelet_tables=tables, jones=jones,
        true_flux=true_flux, true_spec_idx=true_si, true_modes=true_modes,
        freq0=freq0, dec0=dec0, noise_sigma=noise_sigma)


def make_multiband_skies(nbands: int = 4, freq0: float = 130e6,
                         band_bw: float = 10e6, **kwargs) -> List[SimulatedSky]:
    """The same sky (same seed, sources and gains) observed in ``nbands``
    bands, band b centred at ``freq0 + b * band_bw``."""
    return [make_sky(freq0=freq0 + b * band_bw, **kwargs)
            for b in range(nbands)]


def perturb_flux(sky: SimulatedSky, factor: float = 1.15, cluster: int = 0,
                 source: int = 0) -> List[SourceBatch]:
    """The cluster list with one source's flux scaled by ``factor``."""
    out = list(sky.clusters)
    src = out[cluster]
    sI0 = src.sI0.clone()
    sI0[source] = sI0[source] * factor
    out[cluster] = src.replace(sI0=sI0)
    return out
