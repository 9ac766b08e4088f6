"""The radio interferometer measurement equation in plain torch: the
reference that decides whether a run of the fullbatch app is correct.

Written from SAGECal's published conventions (Yatawatta et al.; the
LSM sky format), not from the program:

- a source at (ra, dec) lies at direction cosines
  ``l = cos(dec) sin(ra - ra0)``,
  ``m = sin(dec) cos(dec0) - cos(dec) sin(dec0) cos(ra - ra0)``,
  ``n = sin(dec) sin(dec0) + cos(dec) cos(dec0) cos(ra - ra0)``;
- with u, v, w in seconds (metres over c) its visibility on a baseline
  at frequency f is ``exp(+i 2 pi f (u l + v m + w (n - 1)))``, times
  the bandwidth smearing ``|sinc(pi dnu (u l + v m + w (n - 1)))|`` of a
  channel dnu wide;
- a Gaussian of full widths eX, eY (radians) at position angle eP is
  seen in the source's own tangent plane, where it multiplies the
  visibility by ``exp(-2 pi^2 (sx^2 ut^2 + sy^2 vt^2))``,
  ``sx = eX / (2 sqrt(2 ln 2))``;
- the flux at f is ``I0 (f / f0)^alpha`` and the coherency
  ``[[I + Q, U + iV], [U - iV, I - Q]]``;
- the data of baseline (p, q) are ``sum_k J_pk C_k J_qk^H`` plus noise,
  and the residual is the data less that sum for the solved gains;
- a tile's residual norm is ``sqrt(sum |r|^2) / (8 F rows)``, and its
  robust cost under Student's t with nu degrees of freedom is
  ``sum log(1 + |r|^2 / nu)`` over the complex entries.

Everything runs in float64 (complex128) unless a function says
otherwise, in blocks of rows so that it fits beside what it judges.
:func:`coherencies_tf32` is the control: the same coherencies with the
phase products of TF32 (10-bit mantissa inputs, float32 sums), the
precision one step below what the configurations state.
"""

from __future__ import annotations

import math

import torch

C_LIGHT = 299792458.0
FWHM_TO_SIGMA = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))
ROW_BLOCK = 1 << 18


def lmn(ra, dec, ra0: float, dec0: float):
    """Direction cosines of sources at (ra, dec): (l, m, n), as tensors."""
    dra = ra - ra0
    l = torch.cos(dec) * torch.sin(dra)
    m = (torch.sin(dec) * math.cos(dec0)
         - torch.cos(dec) * math.sin(dec0) * torch.cos(dra))
    n = (torch.sin(dec) * math.sin(dec0)
         + torch.cos(dec) * math.cos(dec0) * torch.cos(dra))
    return l, m, n


def source_table(sources: dict, ra0: float, dec0: float, device,
                 dtype=torch.float64) -> dict:
    """One cluster's sources (lists ``ra, dec, sI, sQ, sU, sV, alpha, f0,
    gauss, eX, eY, eP``) as tensors with their direction cosines and, for
    Gaussians, the rotation into the source's tangent plane (SAGECal's
    projection: none within 0.998 of the phase centre)."""
    t = {k: torch.as_tensor(sources[k], dtype=torch.float64, device=device)
         for k in ("ra", "dec", "sI", "sQ", "sU", "sV", "alpha", "f0", "eX",
                   "eY", "eP")}
    gauss = torch.as_tensor(sources["gauss"], dtype=torch.bool, device=device)
    l, m, n = lmn(t["ra"], t["dec"], ra0, dec0)
    phi = torch.acos(torch.clamp(n.abs(), max=1.0))
    xi = torch.atan2(-l, m)
    flat = n.abs() >= 0.998
    one, zero = torch.ones_like(l), torch.zeros_like(l)
    out = dict(
        l=l, m=m, n1=n - 1.0, gauss=gauss,
        cxi=torch.where(flat, one, torch.cos(xi)),
        sxi=torch.where(flat, zero, torch.sin(-xi)),
        cphi=torch.where(flat, one, torch.cos(phi)),
        sphi=torch.where(flat, zero, torch.sin(-phi)),
        sx=t["eX"] * FWHM_TO_SIGMA, sy=t["eY"] * FWHM_TO_SIGMA,
        cp=torch.cos(t["eP"]), sp=torch.sin(t["eP"]),
        sI=t["sI"], sQ=t["sQ"], sU=t["sU"], sV=t["sV"],
        alpha=t["alpha"], f0=t["f0"])
    return {k: (v if v.dtype == torch.bool else v.to(dtype))
            for k, v in out.items()}


def _stokes_at(src: dict, freqs):
    """(I, Q, U, V) each (S, F) at the channel frequencies."""
    scale = (freqs[None, :] / src["f0"][:, None]) ** src["alpha"][:, None]
    return tuple(src[k][:, None] * scale for k in ("sI", "sQ", "sU", "sV"))


def _phase_and_shape(src: dict, u, v, w, freqs, fdelta: float):
    """(phase (F, R, S) angle, amplitude (F, R, S)) of every source on
    rows u, v, w (seconds)."""
    g = u[:, None] * src["l"] + v[:, None] * src["m"] + w[:, None] * src["n1"]
    ang = 2.0 * math.pi * freqs[:, None, None] * g[None]
    x = math.pi * fdelta * g
    smear = torch.where(x == 0, torch.ones_like(x),
                        torch.sin(x) / torch.where(x == 0,
                                                   torch.ones_like(x), x))
    amp = smear.abs()[None].expand_as(ang)
    if bool(src["gauss"].any()):
        up = (u[:, None] * src["cxi"] - v[:, None] * src["cphi"] * src["sxi"]
              + w[:, None] * src["sphi"] * src["sxi"])
        vp = (u[:, None] * src["sxi"] + v[:, None] * src["cphi"] * src["cxi"]
              - w[:, None] * src["sphi"] * src["cxi"])
        upf = freqs[:, None, None] * up[None]
        vpf = freqs[:, None, None] * vp[None]
        ut = src["sx"] * (src["cp"] * upf - src["sp"] * vpf)
        vt = src["sy"] * (src["sp"] * upf + src["cp"] * vpf)
        shape = torch.exp(-2.0 * math.pi ** 2 * (ut ** 2 + vt ** 2))
        amp = amp * torch.where(src["gauss"], shape, torch.ones_like(shape))
    return ang, amp


def coherencies(src: dict, u, v, w, freqs, fdelta: float):
    """Coherencies (F, 4, R) complex of one cluster's ``src`` on the
    rows u, v, w (seconds), channel frequencies ``freqs`` and channel
    width ``fdelta`` (Hz), in the dtype of ``u``; order XX, XY, YX, YY."""
    ang, amp = _phase_and_shape(src, u, v, w, freqs, fdelta)
    vis = torch.polar(amp, ang)  # (F, R, S)
    I, Q, U, V = _stokes_at(src, freqs)
    ctype = vis.dtype
    c = torch.stack([I + Q, torch.complex(U, V), torch.complex(U, -V), I - Q],
                    dim=-1).to(ctype)  # (S, F, 4)
    return torch.einsum("frs,sfc->fcr", vis, c)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, nearest even)."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def coherencies_tf32(src: dict, u, v, w, freqs, fdelta: float):
    """:func:`coherencies` one precision down (the control): float32
    throughout, and the products that form the phase and the tangent
    plane, a (rows x 3) by (3 x sources) product, with TF32 inputs as a
    TF32 matrix product takes them.  Complex64 (F, 4, R)."""
    f32 = lambda x: x.to(torch.float32)
    s = {k: (val if val.dtype == torch.bool else f32(val))
         for k, val in src.items()}
    u, v, w, freqs = f32(u), f32(v), f32(w), f32(freqs)
    t = {k: tf32(s[k]) for k in ("l", "m", "n1", "cxi", "sxi", "cphi",
                                 "sphi")}
    tu, tv, tw = tf32(u), tf32(v), tf32(w)
    s = dict(s, **t)
    return coherencies(s, tu, tv, tw, freqs, fdelta)


def corrupt(J, C, ant_p, ant_q):
    """J_p C J_q^H per row: J (N, 2, 2), C (F, 4, R) -> (F, 4, R)."""
    jp, jq = J[ant_p], J[ant_q].conj()  # (R, 2, 2); jq conjugated
    c00, c01, c10, c11 = C[:, 0], C[:, 1], C[:, 2], C[:, 3]  # (F, R)
    # A = C J_q^H: A_ij = sum_k C_ik conj(Jq_jk)
    a00 = c00 * jq[:, 0, 0] + c01 * jq[:, 0, 1]
    a01 = c00 * jq[:, 1, 0] + c01 * jq[:, 1, 1]
    a10 = c10 * jq[:, 0, 0] + c11 * jq[:, 0, 1]
    a11 = c10 * jq[:, 1, 0] + c11 * jq[:, 1, 1]
    v00 = jp[:, 0, 0] * a00 + jp[:, 0, 1] * a10
    v01 = jp[:, 0, 0] * a01 + jp[:, 0, 1] * a11
    v10 = jp[:, 1, 0] * a00 + jp[:, 1, 1] * a10
    v11 = jp[:, 1, 0] * a01 + jp[:, 1, 1] * a11
    return torch.stack([v00, v01, v10, v11], dim=1)


def residual_norm(res, mask=None):
    """sqrt(sum |r|^2) / (8 F R) of a residual (F, 4, R), masked per
    (F, R) when ``mask`` is given."""
    F, _, R = res.shape
    r2 = res.real ** 2 + res.imag ** 2
    if mask is not None:
        r2 = r2 * mask[:, None, :]
    return torch.sqrt(r2.sum()) / (8 * F * R)


def robust_cost(res, nu: float, mask=None):
    """sum log(1 + |r|^2 / nu) over the complex entries of (F, 4, R)."""
    r2 = res.real ** 2 + res.imag ** 2
    if mask is not None:
        r2 = r2 * mask[:, None, :]
    return torch.log1p(r2 / nu).sum()


def tile_coherencies(clusters: list, u, v, w, freqs, fdelta: float):
    """The coherencies of every cluster on every row, (K, F, 4, R),
    formed in blocks of rows."""
    R = u.shape[0]
    return torch.stack([
        torch.cat([coherencies(src, u[a:a + ROW_BLOCK], v[a:a + ROW_BLOCK],
                               w[a:a + ROW_BLOCK], freqs, fdelta)
                   for a in range(0, R, ROW_BLOCK)], dim=-1)
        for src in clusters])


def jones(p):
    """Real gain parameters (..., 8N), station by station ``Re J00, Im
    J00, Re J10, Im J10, Re J01, Im J01, Re J11, Im J11`` (the order of
    SAGECal's solutions file), as complex Jones (..., N, 2, 2)."""
    s = p.reshape(p.shape[:-1] + (-1, 4, 2))
    z = torch.complex(s[..., 0], s[..., 1])
    return torch.stack([torch.stack([z[..., 0], z[..., 2]], dim=-1),
                        torch.stack([z[..., 1], z[..., 3]], dim=-1)], dim=-2)


def model(coh, J, ant_p, ant_q):
    """``sum_k J_pk C_k J_qk^H`` (F, 4, R): ``coh`` (K, F, 4, R), ``J``
    (K, N, 2, 2)."""
    out = corrupt(J[0], coh[0], ant_p, ant_q)
    for k in range(1, coh.shape[0]):
        out = out + corrupt(J[k], coh[k], ant_p, ant_q)
    return out


def joint_cost_and_grad(coh, data, p, nu, ant_p, ant_q):
    """The joint fit's cost of the gain parameters ``p`` (K, 8N) on
    ``data`` (F, 4, R), Student's t with ``nu`` degrees of freedom
    (:func:`robust_cost`; ``nu`` None: the Gaussian ``sum |r|^2``), and
    its gradient with respect to ``p``: (cost, grad (K, 8N)).

    With r the residual, d cost / d (Re m, Im m) is ``-2 r / (nu +
    |r|^2)`` (``-2 r`` for the Gaussian), a fixed G; the gradient of
    cluster k's parameters is then that of ``sum Re(conj(G) m_k)``, one
    cluster at a time."""
    with torch.no_grad():
        r = data - model(coh, jones(p), ant_p, ant_q)
        r2 = r.real ** 2 + r.imag ** 2
        if nu is None:
            cost, G = r2.sum(), -2.0 * r
        else:
            cost, G = torch.log1p(r2 / nu).sum(), -2.0 * r / (nu + r2)
        del r, r2
    grad = torch.empty_like(p)
    for k in range(coh.shape[0]):
        with torch.enable_grad():
            pk = p[k].detach().requires_grad_(True)
            m = corrupt(jones(pk), coh[k], ant_p, ant_q)
            (grad[k],) = torch.autograd.grad(
                (G.real * m.real + G.imag * m.imag).sum(), pk)
    return float(cost), grad
