"""RIME sky-model prediction: per-baseline coherencies of source clusters.

Counterpart of ``sagecal_tpu/ops/rime.py`` for POINT sources.  The
per-source phase and smearing factors form a complex (F, rows, S)
tensor that is contracted against the per-source Stokes coherencies
(S, F, 4) by one ``einsum``; sources go in chunks to bound the
intermediate, as in the JAX package.

Conventions (same as the reference and the JAX package):
- phase ``G = 2*pi*(u*l + v*m + w*(n-1))``, u, v, w in seconds; the
  applied phase is ``exp(+i*G*freq)``;
- bandwidth smearing ``|sinc(G*fdelta/2)|``;
- ``C = [[I+Q, U+iV], [U-iV, I-Q]]``;
- spectra ``exp(ln I0 + p1 ln(f/f0) + p2 ln^2 + p3 ln^3)``, sign kept.

Extended sources (Gaussian, disk, ring, shapelet) and time smearing are
not ported yet: they raise NotImplementedError (ROADMAP.md, Queue A,
"extended sources with ops/special.py") instead of predicting a point.
"""

from __future__ import annotations

import dataclasses

import torch

from sagecal_tpu_torch.core.types import complex_dtype_of
from sagecal_tpu_torch.device import resolve_device

ST_POINT = 0
ST_GAUSSIAN = 1
ST_DISK = 2
ST_RING = 3
ST_SHAPELET = 4

_NOT_PORTED = (
    "extended sources (Gaussian, disk, ring, shapelet) and time smearing "
    "are not ported to sagecal_tpu_torch yet (ROADMAP.md Queue A: "
    "'extended sources with ops/special.py'); use sagecal_tpu"
)


@dataclasses.dataclass
class SourceBatch:
    """A padded struct-of-arrays batch of sources; every field (S,).

    Padding sources have zero flux, so they are exact no-ops."""

    ll: torch.Tensor
    mm: torch.Tensor
    nn: torch.Tensor  # n - 1
    sI0: torch.Tensor
    sQ0: torch.Tensor
    sU0: torch.Tensor
    sV0: torch.Tensor
    f0: torch.Tensor
    spec_idx: torch.Tensor
    spec_idx1: torch.Tensor
    spec_idx2: torch.Tensor
    stype: torch.Tensor  # int32
    ex_a: torch.Tensor
    ex_b: torch.Tensor
    ex_cp: torch.Tensor
    ex_sp: torch.Tensor
    cxi: torch.Tensor
    sxi: torch.Tensor
    cphi: torch.Tensor
    sphi: torch.Tensor
    shapelet_idx: torch.Tensor  # int32, -1 if not a shapelet

    @property
    def nsources(self) -> int:
        return self.ll.shape[0]

    def map(self, fn) -> "SourceBatch":
        """Apply ``fn`` to every field."""
        return SourceBatch(**{f.name: fn(getattr(self, f.name))
                              for f in dataclasses.fields(self)})


def point_source_batch(ll, mm, flux, f0=150e6, dtype=torch.float32,
                       device=None) -> SourceBatch:
    """Unpolarized point sources (testing / simulation), on ``device``
    (CUDA unless ``device="cpu"``)."""
    device = resolve_device(device)
    ll = torch.as_tensor(ll, dtype=dtype, device=device)
    mm = torch.as_tensor(mm, dtype=dtype, device=device)
    S = ll.shape[0]
    z = torch.zeros((S,), dtype=dtype, device=device)
    one = torch.ones((S,), dtype=dtype, device=device)
    nn = torch.sqrt(torch.clamp(1.0 - ll ** 2 - mm ** 2, min=0.0)) - 1.0
    return SourceBatch(
        ll=ll, mm=mm, nn=nn,
        sI0=torch.as_tensor(flux, dtype=dtype, device=device),
        sQ0=z, sU0=z, sV0=z,
        f0=torch.full((S,), f0, dtype=dtype, device=device),
        spec_idx=z, spec_idx1=z, spec_idx2=z,
        stype=torch.zeros((S,), dtype=torch.int32, device=device),
        ex_a=z, ex_b=z, ex_cp=one, ex_sp=z,
        cxi=one, sxi=z, cphi=one, sphi=z,
        shapelet_idx=torch.full((S,), -1, dtype=torch.int32, device=device),
    )


def pad_source_batch(src: SourceBatch, target: int) -> SourceBatch:
    """Pad with zero-flux point sources up to ``target`` sources; padding
    keeps f0 > 0 (no log(0)) and shapelet_idx = -1."""
    S = src.nsources
    if S == target:
        return src
    assert S < target
    pad = target - S
    out = src.map(lambda x: torch.nn.functional.pad(x, (0, pad)))
    pad_mask = torch.arange(target, device=src.ll.device) >= S
    out.f0 = torch.where(out.f0 <= 0, torch.ones_like(out.f0), out.f0)
    out.shapelet_idx = torch.where(
        pad_mask, torch.full_like(out.shapelet_idx, -1), out.shapelet_idx)
    return out


def _spectral_flux(s0, f0, si, si1, si2, freqs):
    """Per-channel flux (S, F) with sign preservation; a source with
    si == 0 keeps its raw catalog flux even if si1/si2 are nonzero."""
    lf = torch.log(freqs[None, :] / f0[:, None])  # (S, F)
    zero = s0 == 0.0
    safe_abs = torch.where(zero, torch.ones_like(s0), s0.abs())
    mag = torch.exp(
        torch.log(safe_abs)[:, None]
        + si[:, None] * lf
        + si1[:, None] * lf ** 2
        + si2[:, None] * lf ** 3
    )
    scaled = torch.where(zero[:, None], torch.zeros_like(mag),
                         torch.sign(s0)[:, None] * mag)
    return torch.where(si[:, None] == 0.0, s0[:, None].expand_as(scaled), scaled)


def sinc_abs(x):
    """|sin(x)/x| with the x == 0 limit (bandwidth smearing)."""
    zero = x == 0.0
    safe = torch.where(zero, torch.ones_like(x), x)
    return torch.where(zero, torch.ones_like(x), torch.sin(safe) / safe).abs()


def _check_point_only(src: SourceBatch):
    if bool((src.stype != ST_POINT).any()):
        raise NotImplementedError(_NOT_PORTED)


def predict_coherencies(u, v, w, freqs, src: SourceBatch, fdelta: float = 0.0,
                        source_chunk: int = 32, shapelets=None,
                        tdelta: float = 0.0) -> torch.Tensor:
    """Sum of the sources' coherencies on every row: (F, 4, rows) complex.

    ``fdelta`` is the per-channel bandwidth for smearing.  Point sources
    only (module doc)."""
    if shapelets is not None or tdelta > 0.0:
        raise NotImplementedError(_NOT_PORTED)
    _check_point_only(src)
    return _predict_coherencies(u, v, w, freqs, src, float(fdelta),
                                int(source_chunk))


def _predict_coherencies(u, v, w, freqs, src: SourceBatch, fdelta: float,
                         source_chunk: int) -> torch.Tensor:
    """Point-source predict of :func:`predict_coherencies`; leading batch
    dims of ``src`` fields (B, S) give a (B, F, 4, rows) result."""
    rows = u.shape[0]
    F = freqs.shape[0]
    S = src.ll.shape[-1]
    cdtype = complex_dtype_of(u.dtype)
    lead = tuple(src.ll.shape[:-1])
    chunk = min(source_chunk, S) if S > 0 else 1
    acc = torch.zeros(lead + (F, 4, rows), dtype=cdtype, device=u.device)
    for s0 in range(0, S, chunk):
        c = src.map(lambda x: x[..., s0:s0 + chunk])
        # phase term G (..., rows, chunk), seconds
        G = 2.0 * torch.pi * (
            u[:, None] * c.ll[..., None, :]
            + v[:, None] * c.mm[..., None, :]
            + w[:, None] * c.nn[..., None, :]
        )
        ang = freqs[:, None, None] * G[..., None, :, :]  # (..., F, rows, chunk)
        ph = torch.complex(torch.cos(ang), torch.sin(ang))
        smear = sinc_abs(G * (0.5 * fdelta))[..., None, :, :]
        phs = ph * smear
        flux = lambda s: _spectral_flux(
            s.reshape(-1), c.f0.reshape(-1), c.spec_idx.reshape(-1),
            c.spec_idx1.reshape(-1), c.spec_idx2.reshape(-1), freqs,
        ).reshape(s.shape + (F,))
        I, Q, U, V = flux(c.sI0), flux(c.sQ0), flux(c.sU0), flux(c.sV0)
        C = torch.stack(
            [I + Q, U + 1j * V, U - 1j * V, I - Q], dim=-1
        ).to(cdtype)  # (..., chunk, F, 4)
        acc = acc + torch.einsum("...frs,...sfc->...fcr", phs, C)
    return acc


def predict_model(u, v, w, freqs, clusters, fdelta=0.0, jones=None,
                  ant_p=None, ant_q=None, source_chunk: int = 32):
    """Full-sky model: sum over clusters, each optionally corrupted by
    its own Jones (``jones`` (nclus, N, 2, 2)).  Flat (F, 4, rows)."""
    from sagecal_tpu_torch.core.types import corrupt_flat

    if not clusters:
        raise ValueError("predict_model: empty cluster list")
    total = None
    for ci, src in enumerate(clusters):
        coh = predict_coherencies(u, v, w, freqs, src, fdelta, source_chunk)
        if jones is not None:
            coh = corrupt_flat(jones[ci], coh, ant_p, ant_q)
        total = coh if total is None else total + coh
    return total
