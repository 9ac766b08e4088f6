"""Station (array-factor) and element (dipole) beams and the beam-aware
predict (counterpart of ``sagecal_tpu/ops/beam.py``).

The reference's ``stationbeam.c``, ``elementbeam.c`` and the beam
application of ``predict_withbeam.c`` as batched torch ops over a
(time, freq, station, source, element) grid; the az/el geometry is
computed on the host once per tile (numpy, ``ops/transforms.py``), as
the reference precomputes its beam tables.

Beam types mirror ``STAT_NONE/SINGLE/TILE`` and the modes ``DOBEAM_*``.
Element coefficients load from an .npz (``ElementCoeffs``); the LOFAR
LBA / HBA and lunar ALO tables are shipped in ``data/element/``, and a
synthetic short-dipole default stands in for simulation.

Precision: the geometry is float64 and so is the beam; the caller casts
it to the data's complex dtype.  The JAX package builds the identity
E-Jones of the array-factor-only branch (and of a missing element
table) as complex64 even at float64, which rounds that branch's gain to
~1e-7; here the beam keeps the geometry's precision (ROADMAP.md, Queue C,
deliberate differences).

The 2x2 complex products (B_p C B_q^H per row and source) are broadcast
multiplies and sums, not ``einsum``/batched matmul: cuBLAS's batched
gemm took 0.87 ms a call against 0.02 ms for the broadcast form on an
"NVIDIA H100 80GB HBM3, 700.00 W" (ROADMAP.md, Recent).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.ops.transforms import jd2gmst, radec2azel_gmst

C0 = 299792458.0

STAT_NONE = 0
STAT_SINGLE = 1
STAT_TILE = 2

HBA_TILE_SIZE = 16  # LOFAR HBA dual-stage tile

# beam modes (the roles of the reference's DOBEAM_* codes)
DOBEAM_NONE = 0
DOBEAM_ARRAY = 1  # array factor only
DOBEAM_ELEMENT = 2  # element beam only
DOBEAM_FULL = 3  # array factor x element


@dataclasses.dataclass
class StationGeometry:
    """Per-station geometry of the beamformer.

    longitude/latitude: (N,) rad; element offsets x, y, z (N, Kmax)
    metres, padded, with ``elem_mask`` (N, Kmax) 1.0 on valid entries.
    For ``STAT_TILE`` the first ``HBA_TILE_SIZE`` entries are the
    within-tile dipole offsets and the rest the tile centroids."""

    longitude: torch.Tensor
    latitude: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    elem_mask: torch.Tensor
    bf_type: int = STAT_SINGLE

    def to(self, device) -> "StationGeometry":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "bf_type"})


class BeamPointing(NamedTuple):
    ra0: float  # pointing / phase centre
    dec0: float
    b_ra0: float  # tile beam centre (STAT_TILE)
    b_dec0: float
    f0: float  # beamformer reference frequency


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def azel_grid(ra, dec, longitude, latitude, time_jd):
    """az, el of each (time, station, source): (T, N, S) numpy each, on
    the host (once per tile)."""
    gmst = jd2gmst(_host(time_jd))  # (T,)
    return radec2azel_gmst(
        _host(ra)[None, None, :], _host(dec)[None, None, :],
        _host(longitude)[None, :, None], _host(latitude)[None, :, None],
        np.asarray(gmst)[:, None, None])


def _offset_gain(r1, r2, r3, x, y, z, mask):
    """|sum_k m_k exp(-i 2pi/c (r . x_k))| / K per (T, F, N, S): the
    beamformer of one set of element offsets, steering r* (T, F, N, S),
    offsets x, y, z and mask (N, K)."""
    tpc = 2.0 * math.pi / C0
    per = lambda a: a[None, None, :, None, :]  # noqa: E731
    prod = -tpc * (r1[..., None] * per(x) + r2[..., None] * per(y)
                   + r3[..., None] * per(z))
    m = per(mask)
    csum = (torch.cos(prod) * m).sum(-1)
    ssum = (torch.sin(prod) * m).sum(-1)
    k = torch.clamp(mask.sum(-1), min=1.0)  # (N,)
    return torch.sqrt(csum ** 2 + ssum ** 2) / k[None, None, :, None]


def _steering(beam_f, freqs, st0, ct0, sp0, cp0, st, ct, sp, cp):
    """The steering vectors r1, r2, r3 (T, F, N, S) of a beam centred at
    (theta0, phi0) (T, N) toward sources at (theta, phi) (T, N, S)."""
    rat1 = beam_f[None, :, None] * st0[:, None]  # (T, F, N)
    rat2 = freqs[None, :, None, None] * st[:, None]  # (T, F, N, S)
    r1 = rat1[..., None] * cp0[:, None, :, None] - rat2 * cp[:, None]
    r2 = rat1[..., None] * sp0[:, None, :, None] - rat2 * sp[:, None]
    r3 = ((beam_f[None, :, None] * ct0[:, None])[..., None]
          - freqs[None, :, None, None] * ct[:, None])
    return r1, r2, r3


def _trig(el, az):
    theta, phi = math.pi / 2 - el, -az
    return (torch.sin(theta), torch.cos(theta), torch.sin(phi),
            torch.cos(phi))


def array_beam_gain(geom: StationGeometry, pointing: BeamPointing,
                    az, el, az0, el0, azb, elb, freqs,
                    wideband: bool = False, source_chunk: int = 16):
    """Array-factor gain (T, F, N, S), real (``arraybeam``).

    az/el: (T, N, S) source directions; az0/el0: (T, N) beam centres;
    azb/elb: (T, N) tile centres (``STAT_TILE`` only; pass az0/el0
    otherwise); freqs (F,).  ``wideband``: the beamformer at each
    channel's frequency, else at ``pointing.f0``.  Sources go in chunks
    of ``source_chunk``, so the (T, F, N, chunk, K) phase tensor does not
    grow with the cluster (each source's gain is independent of the
    others)."""
    beam_f = freqs if wideband else torch.full_like(freqs, pointing.f0)
    st0, ct0, sp0, cp0 = _trig(el0, az0)
    stb, ctb, spb, cpb = _trig(elb, azb)
    K = HBA_TILE_SIZE
    parts = []
    for s0 in range(0, az.shape[-1], max(source_chunk, 1)):
        sl = slice(s0, s0 + source_chunk)
        st, ct, sp, cp = _trig(el[..., sl], az[..., sl])
        r = _steering(beam_f, freqs, st0, ct0, sp0, cp0, st, ct, sp, cp)
        if geom.bf_type == STAT_TILE:
            # the station beamformer over the tile centroids, times the
            # tile beamformer over the dipoles steered at (azb, elb)
            g = _offset_gain(*r, geom.x[:, K:], geom.y[:, K:],
                             geom.z[:, K:], geom.elem_mask[:, K:])
            rb = _steering(beam_f, freqs, stb, ctb, spb, cpb, st, ct, sp, cp)
            g = g * _offset_gain(*rb, geom.x[:, :K], geom.y[:, :K],
                                 geom.z[:, :K], geom.elem_mask[:, :K])
        else:
            g = _offset_gain(*r, geom.x, geom.y, geom.z, geom.elem_mask)
        parts.append(g)
    gain = torch.cat(parts, dim=-1)
    # no gain below the horizon
    return torch.where(el[:, None] >= 0.0, gain, torch.zeros_like(gain))


# ---------------------------------------------------------------------------
# element beam


@dataclasses.dataclass
class ElementCoeffs:
    """Spherical-wave element model (``elementcoeff``): modes (n, m) with
    n < M, m = -n..n step 2, flat index in that order.

    pattern_theta/pattern_phi: (Nmode,) complex coefficients; preamble:
    (Nmode,) real normalizations; beta: scale."""

    pattern_theta: torch.Tensor
    pattern_phi: torch.Tensor
    preamble: torch.Tensor
    beta: float = 1.0
    M: int = 1

    @staticmethod
    def mode_count(M: int) -> int:
        return sum(len(range(-n, n + 1, 2)) for n in range(M))

    def to(self, device) -> "ElementCoeffs":
        return dataclasses.replace(
            self, pattern_theta=self.pattern_theta.to(device),
            pattern_phi=self.pattern_phi.to(device),
            preamble=self.preamble.to(device))

    @staticmethod
    def _of_arrays(th, ph, pre, beta, M, device) -> "ElementCoeffs":
        dev = resolve_device(device)
        as_t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)  # noqa: E731
        return ElementCoeffs(pattern_theta=as_t(th), pattern_phi=as_t(ph),
                             preamble=as_t(pre), beta=float(beta), M=int(M))

    @staticmethod
    def load(path: str, device=None) -> "ElementCoeffs":
        """A single-frequency table saved by :meth:`save`, on ``device``
        (CUDA unless ``device="cpu"``)."""
        d = np.load(path)
        return ElementCoeffs._of_arrays(d["pattern_theta"], d["pattern_phi"],
                                        d["preamble"], d["beta"], d["M"],
                                        device)

    def save(self, path: str) -> None:
        np.savez(path, pattern_theta=_host(self.pattern_theta),
                 pattern_phi=_host(self.pattern_phi),
                 preamble=_host(self.preamble), beta=self.beta, M=self.M)

    @staticmethod
    def preamble_for(M: int, beta: float) -> np.ndarray:
        """Basis normalizations sqrt(((n-|m|)/2)! / (pi ((n+|m|)/2)!)) *
        (-1)^((n-|m|)/2 odd) * beta^(-1-|m|) of the modes (n, m)."""
        out = []
        for n in range(M):
            for m in range(-n, n + 1, 2):
                am = abs(m)
                v = math.sqrt(math.factorial((n - am) // 2)
                              / (math.pi * math.factorial((n + am) // 2)))
                if ((n - am) // 2) % 2:
                    v = -v
                out.append(v * beta ** (-1.0 - am))
        return np.asarray(out)

    @staticmethod
    def from_table(kind_or_path: str, frequency_hz: float,
                   device=None) -> "ElementCoeffs":
        """A LOFAR LBA / HBA or lunar ALO coefficient table ('lba',
        'hba', 'alo': the port's copies in ``data/element/``; any other
        value: the path of such an npz), linearly interpolated to
        ``frequency_hz`` with the ends clamped, on ``device``."""
        if kind_or_path in ("lba", "hba", "alo"):
            path = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "data", "element", f"{kind_or_path}.npz")
        else:
            path = kind_or_path
        d = np.load(path)
        M = int(d["M"])
        beta = float(d["beta"])
        freqs = np.asarray(d["freqs_ghz"])
        f = frequency_hz / 1e9
        idh = int(np.searchsorted(freqs, f, side="left"))
        if idh >= len(freqs):
            th, ph = d["theta"][-1], d["phi"][-1]
        elif idh == 0 or freqs[idh] == f:
            th, ph = d["theta"][idh], d["phi"][idh]
        else:
            idl = idh - 1
            t = (f - freqs[idl]) / (freqs[idh] - freqs[idl])
            th = (1 - t) * d["theta"][idl] + t * d["theta"][idh]
            ph = (1 - t) * d["phi"][idl] + t * d["phi"][idh]
        return ElementCoeffs._of_arrays(th, ph,
                                        ElementCoeffs.preamble_for(M, beta),
                                        beta, M, device)


def synthetic_dipole_coeffs(M: int = 3, beta: float = 1.0,
                            device=None) -> ElementCoeffs:
    """A smooth default: the (0, 0) mode plus a small (2, 0) taper, a
    cos-like response in zenith angle (for simulation)."""
    K = ElementCoeffs.mode_count(M)
    pt = np.zeros(K, complex)
    pp = np.zeros(K, complex)
    pt[0] = pp[0] = 1.0
    if M > 2:  # (n=2, m=0) is flat index 1 + 2 + 1 = 4
        pt[4] = pp[4] = -0.3
    return ElementCoeffs._of_arrays(pt, pp, np.ones(K), beta, M, device)


def _laguerre(k: int, a, x):
    """Generalized Laguerre L_k^a(x) by the three-term recurrence."""
    L0 = torch.ones_like(x)
    if k == 0:
        return L0
    L1 = 1.0 + a - x
    if k == 1:
        return L1
    for i in range(2, k + 1):
        L2 = ((2.0 * i - 1.0 + a - x) * L1 - (i - 1.0 + a) * L0) / i
        L0, L1 = L1, L2
    return L1


def eval_element(coeff: ElementCoeffs, r, theta):
    """(phi, theta) complex patterns at zenith angle ``r`` and azimuthal
    coordinate ``theta`` (``eval_elementcoeffs``): the sum over modes of
    preamble (pi/4 + r)^|m| L_{(n-|m|)/2}^{|m|}(r^2/b^2) exp(-r^2/(2b^2))
    exp(-i m theta) times each pattern's coefficient."""
    rb = (r / coeff.beta) ** 2
    ex = torch.exp(-0.5 * rb)
    vals_phi = vals_theta = 0.0
    idx = 0
    for n in range(coeff.M):
        for m in range(-n, n + 1, 2):
            absm = abs(m)
            Lg = _laguerre((n - absm) // 2, float(absm), rb)
            rm = (math.pi / 4 + r) ** absm
            basis = (coeff.preamble[idx] * rm * Lg * ex
                     * torch.exp(-1j * m * theta))
            vals_phi = vals_phi + coeff.pattern_phi[idx] * basis
            vals_theta = vals_theta + coeff.pattern_theta[idx] * basis
            idx += 1
    return vals_phi, vals_theta


def element_ejones(coeff: ElementCoeffs, az, el):
    """Element E-Jones (..., 2, 2) complex at az/el: gamma = pi/2 - el,
    beta = az - pi/4, E = [[Etheta(g, b), Ephi(g, b)], [Etheta(g, b +
    pi/2), Ephi(g, b + pi/2)]]; zero below the horizon."""
    gamma = math.pi / 2 - el
    beta = az - math.pi / 4
    phi_x, theta_x = eval_element(coeff, gamma, beta)
    phi_y, theta_y = eval_element(coeff, gamma, beta + math.pi / 2)
    E = torch.stack([torch.stack([theta_x, phi_x], -1),
                     torch.stack([theta_y, phi_y], -1)], -2)
    return torch.where(el[..., None, None] >= 0.0, E, torch.zeros_like(E))


# ---------------------------------------------------------------------------
# beam-aware coherencies


def beam_jones(geom: StationGeometry, pointing: BeamPointing,
               coeff: Optional[ElementCoeffs], ra, dec, time_jd, freqs,
               mode: int = DOBEAM_FULL, wideband: bool = False):
    """Per-source beam B (T, F, N, S, 2, 2), complex of the geometry's
    precision: the scalar array factor times the element E-Jones (the
    precompute of ``predict_withbeam.c``).  ``ra``/``dec`` (S,) and
    ``time_jd`` (T,) are host arrays; the result lies on the geometry's
    device."""
    lon, lat = _host(geom.longitude), _host(geom.latitude)
    dev, rdt = geom.x.device, geom.x.dtype
    as_t = lambda a: torch.as_tensor(a, dtype=rdt).to(dev)  # noqa: E731
    az, el = (as_t(a) for a in azel_grid(ra, dec, lon, lat, time_jd))
    T, N, S = az.shape
    F = freqs.shape[0]
    fr = freqs.to(device=dev, dtype=rdt)
    if mode in (DOBEAM_ARRAY, DOBEAM_FULL):
        az0, el0 = azel_grid(np.asarray([pointing.ra0]),
                             np.asarray([pointing.dec0]), lon, lat, time_jd)
        azb, elb = azel_grid(np.asarray([pointing.b_ra0]),
                             np.asarray([pointing.b_dec0]), lon, lat, time_jd)
        g = array_beam_gain(geom, pointing, az, el, as_t(az0[..., 0]),
                            as_t(el0[..., 0]), as_t(azb[..., 0]),
                            as_t(elb[..., 0]), fr, wideband)
    else:
        g = torch.ones((T, F, N, S), dtype=rdt, device=dev)
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    if mode in (DOBEAM_ELEMENT, DOBEAM_FULL) and coeff is not None:
        E = element_ejones(coeff, az, el).to(cdt)[:, None]  # (T, 1, N, S, 2, 2)
    else:
        E = torch.eye(2, dtype=cdt, device=dev)
    return g[..., None, None].to(cdt) * E


def _mm22(A, B):
    """Batched 2x2 product A @ B over the leading dims (broadcast)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def predict_coherencies_withbeam(u, v, w, freqs, src, B, time_idx, ant_p,
                                 ant_q, fdelta: float = 0.0,
                                 source_chunk: int = 16, shapelets=None):
    """Beam-aware cluster coherencies sum_s B_p,s (C_s phase_s) B_q,s^H
    per row: flat (F, 4, rows) of B's complex dtype
    (``precalculate_coherencies_withbeam``).  Extended-source and
    shapelet factors as in the unbeamed predict.

    B: (T, F, N, S, 2, 2) from :func:`beam_jones`; time_idx (rows,)."""
    from sagecal_tpu_torch.ops.rime import (
        ST_SHAPELET, _shape_factor, _shapelet_factor, _spectral_flux,
        resolve_source_flags,
    )
    from sagecal_tpu_torch.ops.special import sinc_abs

    has_extended, has_shapelet = resolve_source_flags(src, shapelets)
    rows = u.shape[0]
    F = freqs.shape[0]
    S = src.nsources
    cdtype = B.dtype
    chunk = min(source_chunk, S) if S > 0 else 1
    fidx = torch.arange(F, device=u.device)[None, :]
    acc = torch.zeros((rows, F, 2, 2), dtype=cdtype, device=u.device)
    for s0 in range(0, S, chunk):
        c = src.map(lambda x: x[s0:s0 + chunk])
        Bc = B[:, :, :, s0:s0 + chunk]  # (T, F, N, chunk, 2, 2)
        G = 2.0 * torch.pi * (u[:, None] * c.ll[None, :]
                              + v[:, None] * c.mm[None, :]
                              + w[:, None] * c.nn[None, :])  # (rows, chunk)
        ang = freqs[:, None, None] * G[None]
        ph = torch.complex(torch.cos(ang), torch.sin(ang))
        smear = sinc_abs(G * (0.5 * fdelta))[None]
        if has_extended:
            amp = smear * _shape_factor(c, u, v, w, freqs)
        else:
            amp = smear.expand(ph.shape)
        phs = (ph * amp).to(cdtype)  # (F, rows, chunk)
        if has_shapelet:
            fac_s = _shapelet_factor(c, shapelets, u, v, w, freqs)
            sel = (c.stype == ST_SHAPELET)[None, None, :]
            phs = torch.where(sel, ph * smear * fac_s.to(cdtype), phs)
        flux = lambda s0_: _spectral_flux(  # noqa: E731
            s0_, c.f0, c.spec_idx, c.spec_idx1, c.spec_idx2, freqs)
        I, Q, U, V = flux(c.sI0), flux(c.sQ0), flux(c.sU0), flux(c.sV0)
        Cm = torch.stack([torch.stack([I + Q, U + 1j * V], -1),
                          torch.stack([U - 1j * V, I - Q], -1)],
                         -2).to(cdtype)  # (chunk, F, 2, 2)
        # the beams per row: (rows, F, chunk, 2, 2)
        Bp = Bc[time_idx[:, None], fidx, ant_p[:, None]]
        Bq = Bc[time_idx[:, None], fidx, ant_q[:, None]]
        BCB = _mm22(_mm22(Bp, Cm.transpose(0, 1)[None]),
                    Bq.conj().transpose(-1, -2))
        acc = acc + (phs.permute(1, 0, 2)[..., None, None] * BCB).sum(2)
    return acc.reshape(rows, F, 4).permute(1, 2, 0)
