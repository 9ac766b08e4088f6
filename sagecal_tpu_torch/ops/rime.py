"""RIME sky-model prediction: per-baseline coherencies of source clusters.

Counterpart of ``sagecal_tpu/ops/rime.py``.  The per-source phase,
smearing and shape factors form a complex (F, rows, S) tensor that is
contracted against the per-source Stokes coherencies (S, F, 4) by one
``einsum``; sources go in chunks to bound the intermediate, as in the
JAX package.

Conventions (same as the reference and the JAX package):
- phase ``G = 2*pi*(u*l + v*m + w*(n-1))``, u, v, w in seconds; the
  applied phase is ``exp(+i*G*freq)``;
- bandwidth smearing ``|sinc(G*fdelta/2)|``; time smearing
  ``1.0645 erf(0.8326 x)/x`` of the baseline's east-west drift
  (:func:`time_smear_factor`);
- extended sources at uv in wavelengths after the tangent-plane
  projection: Gaussian ``exp(-2 pi^2 (ut^2 + vt^2))`` (sigma = fwhm /
  (2 sqrt(2 ln 2))), disk ``J1(2 pi a r_uv)``, ring ``J0(2 pi a r_uv)``
  (the reference's literal J1 for the disk); shapelets from a
  :class:`ShapeletTable` (``ops/shapelets.py``);
- ``C = [[I+Q, U+iV], [U-iV, I-Q]]``;
- spectra ``exp(ln I0 + p1 ln(f/f0) + p2 ln^2 + p3 ln^3)``, sign kept.

A shapelet source with no table is refused (``ValueError``), never
predicted as a point.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from sagecal_tpu_torch.core.types import complex_dtype_of
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.obs.trace import host_read
from sagecal_tpu_torch.ops.special import bessel_j0, bessel_j1, sinc_abs

ST_POINT = 0
ST_GAUSSIAN = 1
ST_DISK = 2
ST_RING = 3
ST_SHAPELET = 4

# complex elements of one shapelet chunk's (F, rows, chunk, n0^2) mode
# tensor: a shapelet cluster's source chunk is cut to stay within it
# (the order of the sum over sources changes, nothing else)
SHAPELET_CHUNK_ELEMS = 1 << 26

_NO_TABLE = ("SourceBatch contains ST_SHAPELET sources but no ShapeletTable "
             "was supplied — they would silently predict as point sources")


@dataclasses.dataclass
class ShapeletTable:
    """Padded table of shapelet models (one cluster or the whole sky);
    sources point at rows through ``SourceBatch.shapelet_idx``.  Models
    with fewer than ``n0max`` orders zero-pad ``modes`` (exact).

    modes: (K, n0max*n0max); beta, eX, eY, eP: (K,)."""

    modes: torch.Tensor
    beta: torch.Tensor
    eX: torch.Tensor
    eY: torch.Tensor
    eP: torch.Tensor
    n0max: int = 1

    @staticmethod
    def empty(dtype=torch.float32, device=None) -> "ShapeletTable":
        dev = resolve_device(device)
        one = torch.ones((1,), dtype=dtype, device=dev)
        return ShapeletTable(
            modes=torch.zeros((1, 1), dtype=dtype, device=dev), beta=one,
            eX=one, eY=one, eP=torch.zeros((1,), dtype=dtype, device=dev),
            n0max=1)


@dataclasses.dataclass
class SourceBatch:
    """A padded struct-of-arrays batch of sources; every field (S,).

    Padding sources have zero flux, so they are exact no-ops.  Shapelet
    sources point into a :class:`ShapeletTable` by ``shapelet_idx``."""

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
    ex_a: torch.Tensor  # Gaussian sigma_X / disk, ring radius
    ex_b: torch.Tensor  # Gaussian sigma_Y
    ex_cp: torch.Tensor  # cos(position angle)
    ex_sp: torch.Tensor  # sin(position angle)
    cxi: torch.Tensor
    sxi: torch.Tensor  # sin(-xi)
    cphi: torch.Tensor
    sphi: torch.Tensor  # sin(-phi)
    shapelet_idx: torch.Tensor  # int32, -1 if not a shapelet

    @property
    def nsources(self) -> int:
        return self.ll.shape[0]

    def map(self, fn) -> "SourceBatch":
        """Apply ``fn`` to every field."""
        return SourceBatch(**{f.name: fn(getattr(self, f.name))
                              for f in dataclasses.fields(self)})

    def replace(self, **changes) -> "SourceBatch":
        return dataclasses.replace(self, **changes)


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


def _shape_factor(src: SourceBatch, u, v, w, freqs):
    """Extended-source UV attenuation per channel: (..., F, rows, S)
    real for ``src`` fields (..., S) and u, v, w (rows,) in seconds."""
    col = lambda x: x[..., None, :]  # (..., 1, S) against (rows, 1)
    # tangent-plane projection, still in seconds: (..., rows, S)
    up = (u[:, None] * col(src.cxi)
          - v[:, None] * col(src.cphi) * col(src.sxi)
          + w[:, None] * col(src.sphi) * col(src.sxi))
    vp = (u[:, None] * col(src.sxi)
          + v[:, None] * col(src.cphi) * col(src.cxi)
          - w[:, None] * col(src.sphi) * col(src.cxi))
    # wavelengths per channel: (..., F, rows, S)
    upf = freqs[:, None, None] * up[..., None, :, :]
    vpf = freqs[:, None, None] * vp[..., None, :, :]
    per = lambda x: x[..., None, None, :]
    ut = per(src.ex_a) * (per(src.ex_cp) * upf - per(src.ex_sp) * vpf)
    vt = per(src.ex_b) * (per(src.ex_sp) * upf + per(src.ex_cp) * vpf)
    gauss = torch.exp(-2.0 * math.pi ** 2 * (ut ** 2 + vt ** 2))
    ruv = 2.0 * math.pi * per(src.ex_a) * torch.sqrt(upf ** 2 + vpf ** 2)
    st = per(src.stype)
    fac = torch.where(st == ST_GAUSSIAN, gauss, torch.ones_like(gauss))
    fac = torch.where(st == ST_DISK, bessel_j1(ruv), fac)
    return torch.where(st == ST_RING, bessel_j0(ruv), fac)


def _shapelet_factor(c: SourceBatch, tab: ShapeletTable, u, v, w, freqs):
    """Complex shapelet uv factor (F, rows, chunk) of the chunk's
    ST_SHAPELET members: tangent-plane projection with negated signs,
    (1/eX, 1/eY, eP) transform, mode sum, scaled by 2 pi a b."""
    from sagecal_tpu_torch.ops.shapelets import uv_mode_vectors

    idx = torch.clamp(c.shapelet_idx.long(), 0, tab.modes.shape[0] - 1)
    beta = tab.beta[idx]
    a = 1.0 / tab.eX[idx]
    b = 1.0 / tab.eY[idx]
    eP = tab.eP[idx]
    modes = tab.modes[idx]  # (chunk, n0max^2)
    up = (-u[:, None] * c.cxi[None, :]
          + v[:, None] * c.cphi[None, :] * c.sxi[None, :]
          - w[:, None] * c.sphi[None, :] * c.sxi[None, :])  # (rows, chunk)
    vp = (-u[:, None] * c.sxi[None, :]
          - v[:, None] * c.cphi[None, :] * c.cxi[None, :]
          + w[:, None] * c.sphi[None, :] * c.cxi[None, :])
    upf = freqs[:, None, None] * up[None]  # (F, rows, chunk)
    vpf = freqs[:, None, None] * vp[None]
    cp, sp = torch.cos(eP), torch.sin(eP)
    ut = a * (cp * upf - sp * vpf)
    vt = b * (sp * upf + cp * vpf)
    Av = uv_mode_vectors(-ut, vt, beta, tab.n0max)  # (F, rows, chunk, n0^2)
    sfac = torch.einsum("frsm,sm->frs", Av, modes.to(Av.dtype))
    return (2.0 * math.pi) * (a * b)[None, None, :] * sfac


def resolve_source_flags(src: SourceBatch,
                         shapelets: Optional[ShapeletTable] = None) -> tuple:
    """``(has_extended, has_shapelet)`` of a source batch, read from the
    host once; a shapelet member without a table raises ValueError."""
    with host_read("rime.source_flags"):
        stype = src.stype.cpu()
    has_extended = bool((stype != ST_POINT).any())
    has_shapelet = bool((stype == ST_SHAPELET).any())
    if has_shapelet and shapelets is None:
        raise ValueError(_NO_TABLE)
    return has_extended, has_shapelet


def time_smear_factor(ll, mm, dec0, tdelta, u, v, w, freqs):
    """Time-smearing attenuation of an east-west array:
    1.0645 erf(0.8326 x)/x, x = omega_E tdelta |b|_lambda
    sqrt(l^2 + (sin(dec0) m)^2).  u, v, w (rows,), ll, mm (..., S),
    freqs (F,) -> (..., F, rows, S)."""
    bl = torch.sqrt(u * u + v * v + w * w)  # seconds
    ds = math.sin(dec0) * mm
    r1 = torch.sqrt(ll * ll + ds * ds)  # (..., S)
    prod = (7.2921150e-5 * tdelta * freqs[:, None, None] * bl[None, :, None]
            * r1[..., None, None, :])
    safe = torch.clamp(prod, min=1e-30)
    return torch.where(prod > 1e-12,
                       1.0645 * torch.special.erf(0.8326 * safe) / safe,
                       torch.ones_like(prod))


def predict_coherencies(u, v, w, freqs, src: SourceBatch, fdelta: float = 0.0,
                        source_chunk: int = 32,
                        shapelets: Optional[ShapeletTable] = None,
                        tdelta: float = 0.0, dec0: float = 0.0, *,
                        has_extended: Optional[bool] = None,
                        has_shapelet: Optional[bool] = None) -> torch.Tensor:
    """Sum of the sources' coherencies on every row: (F, 4, rows) complex.

    ``fdelta``: the per-channel bandwidth for smearing; ``tdelta``/
    ``dec0``: integration time (s) and field declination for time
    smearing (0 disables); ``shapelets``: the mode table of the batch's
    ST_SHAPELET members.  ``has_extended``/``has_shapelet``: the
    source-type flags; the batch's own (:func:`resolve_source_flags`)
    are always read from the host, a flag may only widen them (True on
    a point batch takes the extended path, whose factors are 1), and a
    False that the batch contradicts raises ValueError."""
    probed_ext, probed_sh = resolve_source_flags(src, shapelets)
    for name, given, probed in (("has_extended", has_extended, probed_ext),
                                ("has_shapelet", has_shapelet, probed_sh)):
        if given is not None and not given and probed:
            raise ValueError(f"{name}=False, but the source batch has "
                             "members of that type")
    if has_shapelet and shapelets is None:
        raise ValueError(_NO_TABLE)
    return _predict_coherencies(u, v, w, freqs, src, float(fdelta),
                                int(source_chunk), shapelets,
                                bool(has_extended or probed_ext),
                                bool(has_shapelet or probed_sh),
                                float(tdelta), float(dec0))


def _predict_coherencies(u, v, w, freqs, src: SourceBatch, fdelta: float,
                         source_chunk: int,
                         shapelets: Optional[ShapeletTable] = None,
                         has_extended: bool = False,
                         has_shapelet: bool = False, tdelta: float = 0.0,
                         dec0: float = 0.0) -> torch.Tensor:
    """The predict of :func:`predict_coherencies`; leading batch dims of
    ``src`` fields (B, S) give a (B, F, 4, rows) result (no shapelets
    then)."""
    rows = u.shape[0]
    F = freqs.shape[0]
    S = src.ll.shape[-1]
    cdtype = complex_dtype_of(u.dtype)
    lead = tuple(src.ll.shape[:-1])
    if has_shapelet and lead:
        raise ValueError("shapelet clusters are predicted one at a time")
    chunk = min(source_chunk, S) if S > 0 else 1
    if has_shapelet:
        per_source = F * rows * shapelets.n0max ** 2
        chunk = max(1, min(chunk, SHAPELET_CHUNK_ELEMS // per_source))
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
        if tdelta > 0.0:
            smear = smear * time_smear_factor(c.ll, c.mm, dec0, tdelta, u, v,
                                              w, freqs)
        if has_extended:
            amp = smear * _shape_factor(c, u, v, w, freqs)
        else:
            amp = smear.expand(ph.shape)
        phs = ph * amp
        if has_shapelet:
            fac_s = _shapelet_factor(c, shapelets, u, v, w, freqs)
            sel = (c.stype == ST_SHAPELET)[None, None, :]
            phs = torch.where(sel, ph * smear * fac_s.to(phs.dtype), phs)
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
                  ant_p=None, ant_q=None, source_chunk: int = 32,
                  shapelet_tables=None):
    """Full-sky model: sum over clusters, each optionally corrupted by
    its own Jones (``jones`` (nclus, N, 2, 2)); ``shapelet_tables``: an
    optional per-cluster list of :class:`ShapeletTable` (or None).
    Flat (F, 4, rows)."""
    from sagecal_tpu_torch.core.types import corrupt_flat

    if not clusters:
        raise ValueError("predict_model: empty cluster list")
    total = None
    for ci, src in enumerate(clusters):
        tab = shapelet_tables[ci] if shapelet_tables is not None else None
        coh = predict_coherencies(u, v, w, freqs, src, fdelta, source_chunk,
                                  shapelets=tab)
        if jones is not None:
            coh = corrupt_flat(jones[ci], coh, ant_p, ant_q)
        total = coh if total is None else total + coh
    return total


def uv_cut_mask(u, v, freq0, uvmin=0.0, uvmax=1e20):
    """1.0 where the baseline length in wavelengths lies in [uvmin,
    uvmax], else 0.0 (the reference's uv-distance exclusion)."""
    uvdist = torch.sqrt(u ** 2 + v ** 2) * freq0
    return ((uvdist >= uvmin) & (uvdist <= uvmax)).to(u.dtype)


# the reference's instrumented_jit entries: call counts (telemetry)
# and value contracts (SAGECAL_CHECKIFY), obs/perf.py
from sagecal_tpu_torch.obs.perf import instrumented  # noqa: E402

predict_coherencies = instrumented(predict_coherencies, name="predict_coherencies")
