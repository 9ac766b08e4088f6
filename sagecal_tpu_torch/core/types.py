"""Core data model: visibilities, Jones parameter layout, flags.

Counterpart of ``sagecal_tpu/core/types.py``, with the same layouts so
the two packages' arrays compare directly:

- visibilities, coherencies, models and residuals are complex tensors of
  shape ``(..., F, 4, rows)``: channel, the four coherency components
  ``[XX, XY, YX, YY]`` (the 2x2 matrix row-major), rows minor-most;
- a station's Jones solution is 8 reals ``S0..S7`` with
  ``J = [S0+jS1, S4+jS5; S2+jS3, S6+jS7]``; solver parameter vectors are
  real, shape ``(..., 8N)`` (:func:`params_to_jones` /
  :func:`jones_to_params`).

The JAX package gathered per-row gains with a one-hot matmul because
gathers were slow on the TPU; here :func:`gather_jones_rows` indexes the
table directly, which is exact and cheap on a GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Speed of light (m/s); u, v, w are stored in seconds (metres / c).
C0 = 299792458.0


@dataclasses.dataclass
class VisData:
    """One tile (solution interval) of visibilities, flattened over time.

    ``rows = nbase * tilesz``, baseline fastest inside each timeslot.

    u, v, w: (rows,) baseline coordinates in seconds.
    ant_p, ant_q: (rows,) int64 station indices.
    vis: (nchan, 4, rows) complex observed coherencies.
    mask: (nchan, rows) 1.0 good, 0.0 flagged (multiplicative).
    freqs: (nchan,) channel frequencies in Hz.
    time_idx: (rows,) timeslot index within the tile.
    freq0, deltaf, deltat, tilesz, nbase, nstations: static metadata.
    """

    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    ant_p: torch.Tensor
    ant_q: torch.Tensor
    vis: torch.Tensor
    mask: torch.Tensor
    freqs: torch.Tensor
    time_idx: torch.Tensor
    freq0: float = 150e6
    deltaf: float = 180e3
    deltat: float = 1.0
    tilesz: int = 1
    nbase: int = 0
    nstations: int = 0

    @property
    def rows(self) -> int:
        return self.nbase * self.tilesz

    @property
    def nchan(self) -> int:
        return self.vis.shape[-3]

    @property
    def device(self) -> torch.device:
        return self.vis.device

    def replace(self, **changes) -> "VisData":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "VisData":
        """Copy of this tile with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def complex_dtype_of(real_dtype: torch.dtype) -> torch.dtype:
    return torch.complex64 if real_dtype == torch.float32 else torch.complex128


def params_to_jones(p: torch.Tensor) -> torch.Tensor:
    """Real parameter vector (..., 8N) -> complex Jones (..., N, 2, 2).

    Per-station ordering ``[Re J00, Im J00, Re J10, Im J10, Re J01,
    Im J01, Re J11, Im J11]`` (the reference solution-file contract)."""
    s = p.reshape(p.shape[:-1] + (-1, 4, 2))
    z = torch.complex(s[..., 0], s[..., 1])  # (..., N, 4): J00, J10, J01, J11
    j00, j10, j01, j11 = z[..., 0], z[..., 1], z[..., 2], z[..., 3]
    row0 = torch.stack([j00, j01], dim=-1)
    row1 = torch.stack([j10, j11], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def jones_to_params(jones: torch.Tensor) -> torch.Tensor:
    """Complex Jones (..., N, 2, 2) -> real parameter vector (..., 8N)."""
    z = torch.stack(
        [jones[..., 0, 0], jones[..., 1, 0], jones[..., 0, 1], jones[..., 1, 1]],
        dim=-1,
    )  # (..., N, 4)
    s = torch.stack([z.real, z.imag], dim=-1)  # (..., N, 4, 2)
    return s.reshape(s.shape[:-3] + (-1,))


def identity_jones(nstations: int, dtype=torch.complex64, device=None) -> torch.Tensor:
    """(N, 2, 2) stack of identity Jones matrices."""
    eye = torch.eye(2, dtype=dtype, device=device)
    return eye.expand(nstations, 2, 2).clone()


def reals_of_flat(x: torch.Tensor) -> torch.Tensor:
    """Complex (..., 4, rows) -> real (..., 8, rows) ordered
    [Re XX, Im XX, Re XY, Im XY, Re YX, Im YX, Re YY, Im YY]."""
    r = torch.stack([x.real, x.imag], dim=-2)  # (..., 4, 2, rows)
    return r.reshape(x.shape[:-2] + (8, x.shape[-1]))


def gather_jones_rows(jones: torch.Tensor, ant: torch.Tensor,
                      chunk_map: Optional[torch.Tensor] = None):
    """Per-row Jones components by index.

    jones: (N, 2, 2) or (nchunk, N, 2, 2) complex; ant: (rows,) station
    index; chunk_map: (rows,) chunk index (used iff jones has a chunk
    axis).  Returns (j00, j01, j10, j11), each (rows,) complex."""
    if jones.ndim == 3:
        tab = jones.reshape(-1, 4)
        idx = ant
    else:
        N = jones.shape[1]
        tab = jones.reshape(-1, 4)
        idx = chunk_map * N + ant if chunk_map is not None else ant
    v = tab.index_select(0, idx)  # (rows, 4) row-major [00, 01, 10, 11]
    return v[:, 0], v[:, 1], v[:, 2], v[:, 3]


def corrupt_flat(jones, coh, ant_p, ant_q, chunk_map=None):
    """The RIME corruption V = J_p C J_q^H in the flat layout.

    jones: (N, 2, 2) or (nchunk, N, 2, 2) complex; coh: (..., F, 4, rows);
    ant_p/ant_q/chunk_map: (rows,).  Returns (..., F, 4, rows)."""
    pa, pb, pc, pd = gather_jones_rows(jones, ant_p, chunk_map)
    qa, qb, qc, qd = gather_jones_rows(jones, ant_q, chunk_map)
    qa, qb, qc, qd = qa.conj(), qb.conj(), qc.conj(), qd.conj()
    c00 = coh[..., 0, :]
    c01 = coh[..., 1, :]
    c10 = coh[..., 2, :]
    c11 = coh[..., 3, :]
    t00 = pa * c00 + pb * c10
    t01 = pa * c01 + pb * c11
    t10 = pc * c00 + pd * c10
    t11 = pc * c01 + pd * c11
    v00 = t00 * qa + t01 * qb
    v01 = t00 * qc + t01 * qd
    v10 = t10 * qa + t11 * qb
    v11 = t10 * qc + t11 * qd
    return torch.stack([v00, v01, v10, v11], dim=-2)
