"""Synthetic interferometer data (counterpart of ``sagecal_tpu/io/simulate.py``).

Every random draw comes from numpy's ``default_rng(seed)`` in the same
order as the JAX package, so both packages build the same tile from the
same seed: an earth-rotation uvw track for a random station layout,
model visibilities from the RIME predict, corruption by known Jones
gains and Gaussian noise.
"""

from __future__ import annotations

import numpy as np
import torch

from sagecal_tpu_torch.core.baselines import tile_baselines
from sagecal_tpu_torch.core.types import C0, VisData, complex_dtype_of
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.ops.rime import predict_model

_TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPE[np.dtype(dtype).type]


def station_layout(nstations: int, extent_m: float = 3000.0, seed: int = 0) -> np.ndarray:
    """Random station positions (N, 3) in a local equatorial frame, metres."""
    rng = np.random.default_rng(seed)
    r = extent_m * np.sqrt(rng.uniform(0.1, 1.0, nstations))
    th = rng.uniform(0, 2 * np.pi, nstations)
    z = rng.uniform(-20.0, 20.0, nstations)
    return np.stack([r * np.cos(th), r * np.sin(th), z], axis=1)


def uvw_track(xyz, ant_p, ant_q, time_idx, dec0: float = 0.9,
              ha_start: float = -0.1, dt_s: float = 10.0):
    """Earth-rotation uvw (seconds) for each flattened row (numpy)."""
    omega = 7.2921150e-5  # rad/s
    h = ha_start + omega * dt_s * time_idx.astype(np.float64)
    L = xyz[ant_p] - xyz[ant_q]
    lx, ly, lz = L[:, 0], L[:, 1], L[:, 2]
    sh, ch = np.sin(h), np.cos(h)
    sd, cd = np.sin(dec0), np.cos(dec0)
    u = sh * lx + ch * ly
    v = -sd * ch * lx + sd * sh * ly + cd * lz
    w = cd * ch * lx - cd * sh * ly + sd * lz
    return u / C0, v / C0, w / C0


def make_visdata(nstations: int = 8, tilesz: int = 2, nchan: int = 1,
                 freq0: float = 150e6, chan_bw: float = 180e3,
                 dec0: float = 0.9, seed: int = 0, dtype=np.float32,
                 extent_m: float = 3000.0, device=None) -> VisData:
    """An empty (zero-visibility) tile with a consistent uvw track, on
    ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    rdt = _torch_dtype(dtype)
    ant_p, ant_q, time_idx = tile_baselines(nstations, tilesz)
    xyz = station_layout(nstations, extent_m=extent_m, seed=seed)
    u, v, w = uvw_track(xyz, ant_p, ant_q, time_idx, dec0=dec0)
    rows = ant_p.shape[0]
    freqs = freq0 + chan_bw * (np.arange(nchan) - (nchan - 1) / 2.0)
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt).to(dev)
    return VisData(
        u=as_t(u, rdt), v=as_t(v, rdt), w=as_t(w, rdt),
        ant_p=as_t(ant_p, torch.int64), ant_q=as_t(ant_q, torch.int64),
        vis=torch.zeros((nchan, 4, rows), dtype=complex_dtype_of(rdt),
                        device=dev),
        mask=torch.ones((nchan, rows), dtype=rdt, device=dev),
        freqs=as_t(freqs, rdt),
        time_idx=as_t(time_idx, torch.int64),
        freq0=float(freq0),
        deltaf=float(chan_bw * nchan),
        deltat=10.0,
        tilesz=tilesz,
        nbase=nstations * (nstations - 1) // 2,
        nstations=nstations,
    )


def random_jones(nclus: int, nstations: int, seed: int = 0, amp: float = 0.3,
                 dtype=np.complex64, device=None) -> torch.Tensor:
    """(nclus, N, 2, 2) gains: identity + complex perturbation of scale amp."""
    rng = np.random.default_rng(seed)
    pert = amp * (
        rng.standard_normal((nclus, nstations, 2, 2))
        + 1j * rng.standard_normal((nclus, nstations, 2, 2))
    )
    cdt = torch.complex64 if np.dtype(dtype) == np.complex64 else torch.complex128
    return torch.as_tensor((np.eye(2)[None, None] + pert).astype(dtype),
                           dtype=cdt).to(resolve_device(device))


def corrupt_and_observe(data: VisData, clusters, jones=None,
                        noise_sigma: float = 0.0, seed: int = 1,
                        fdelta: float = 0.0) -> VisData:
    """Fill ``data.vis`` with sum_k J_p^k C_pq^k J_q^kH + noise (on the
    tile's device)."""
    rng = np.random.default_rng(seed)
    total = predict_model(
        data.u, data.v, data.w, data.freqs, clusters, fdelta,
        jones=jones, ant_p=data.ant_p, ant_q=data.ant_q,
    )
    if noise_sigma > 0.0:
        nre = rng.standard_normal(tuple(total.shape))
        nim = rng.standard_normal(tuple(total.shape))
        noise = torch.as_tensor((nre + 1j * nim).astype(
            np.complex64 if total.dtype == torch.complex64 else np.complex128))
        total = total + noise_sigma * noise.to(total.device)
    return data.replace(vis=total)
