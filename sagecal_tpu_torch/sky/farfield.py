"""Far-field low-rank expansion of the RIME phase about node centroids
(counterpart of ``sagecal_tpu/sky/farfield.py``).

For a source s in a tree node with centroid ``(l0, m0, n0-1)`` the
per-row, per-channel phase splits as

    f*G_s = f*G_0 + y_s,   y_s = 2*pi*f*(u*dl + v*dm + w*dn)

(``G`` as in :mod:`sagecal_tpu_torch.ops.rime`).  Truncating
``exp(i*y)`` at multipole order p,

    exp(i*y) = sum_{k<=p} (i*y)^k / k!  + R_p,   |R_p| <= |y|^{p+1}/(p+1)!

and expanding ``y^k`` multinomially separates source factors from
baseline factors:

    coh(f,c,r) ~= exp(i*f*G_0(r)) * sum_{a+b+c<=p}
        (i*2*pi*f)^{a+b+c} / (a! b! c!) * u^a v^b w^c * M_abc(f,p)

with the per-node aggregate moments

    M_abc(f,p) = sum_{s in node} stokes_s(f,p) * dl^a dm^b dn^c

(``stokes_s`` the per-source real Stokes fluxes with the spectral
model applied; the constant Stokes-to-coherency map is applied last).
The node sums over sources happen once, in the moments; the
per-(node, tile) work is a dense (rows, nmoments) x (F, npol, nmoments)
real contraction, a plain ``torch.einsum`` as the JAX package's is a
plain XLA product (TF32 stays off: ``utils/precision.py``).  ``npol``
is 1 for an unpolarized sky and 4 otherwise.

The moments' sum over a node's sources is one dense product per
routed tree level: a 0/1 matrix of the level's nodes by the sources
times the (S, F*npol*Q) per-source data.  One launch a level, no float
atomics (bit-identical on repeat on the CPU and on CUDA), and
differentiable in the fluxes and positions.  The matrix holds the
level's node range present in the sky by S values: at most ``4**depth *
S``, with ``depth`` at most 6 (``sky/tree.py::choose_depth``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sagecal_tpu_torch.ops.rime import SourceBatch, _spectral_flux


def multipole_table(order: int) -> tuple:
    """Host-side enumeration of the multi-indices with |(a,b,c)| <= p.

    Returns ``(abc, invfact, degree)``: ``abc`` (Q, 3) int exponents,
    ``invfact`` (Q,) float 1/(a! b! c!), ``degree`` (Q,) int a+b+c.
    Ordered by total degree so truncation to a lower order is a prefix.
    """
    if order < 0:
        raise ValueError("order must be >= 0")
    rows = []
    for k in range(order + 1):
        for a in range(k, -1, -1):
            for b in range(k - a, -1, -1):
                c = k - a - b
                rows.append((a, b, c))
    abc = np.asarray(rows, np.int64)
    invfact = np.asarray(
        [1.0 / (math.factorial(a) * math.factorial(b) * math.factorial(c))
         for a, b, c in rows], np.float64)
    degree = abc.sum(axis=1)
    return abc, invfact, degree


def apriori_rel_bound(order: int, theta: float) -> float:
    """Taylor-remainder bound on the far-field truncation error.

    Every admissible (node, tile) pair satisfies ``|y| <= theta`` for
    all of its rows/channels, so the pointwise error of the expanded
    node contribution is at most ``theta^(p+1)/(p+1)!`` times the
    node's summed absolute coherency amplitude.  Normalized by the
    total absolute source amplitude this is the sky-wide relative
    bound the quality watchdog verifies a-posteriori."""
    if theta <= 0:
        return 0.0
    return float(theta) ** (order + 1) / math.factorial(order + 1)


def source_stokes(src: SourceBatch, freqs: torch.Tensor,
                  npol: int) -> torch.Tensor:
    """Per-source Stokes fluxes (S, F, npol), real, with the spectral
    model applied: I only (``npol`` 1) or (I, Q, U, V) (``npol`` 4)."""
    def flux(s0):
        return _spectral_flux(s0, src.f0, src.spec_idx, src.spec_idx1,
                              src.spec_idx2, freqs)

    if npol == 1:
        return flux(src.sI0)[:, :, None]
    return torch.stack([flux(src.sI0), flux(src.sQ0), flux(src.sU0),
                        flux(src.sV0)], dim=-1)


def _monomials(d: torch.Tensor, abc: np.ndarray) -> torch.Tensor:
    """``prod_k d[..., k]^abc[q, k]``: (..., Q) from (..., 3) via one
    cumulative-product power table."""
    amax = int(abc.max()) if abc.size else 0
    powers = torch.cumprod(
        torch.cat([torch.ones_like(d)[..., None],
                   d[..., None].expand(d.shape + (max(amax, 1),))], dim=-1),
        dim=-1)  # (..., 3, amax+1)
    ix = torch.as_tensor(abc, device=d.device)
    return (powers[..., 0, ix[:, 0]] * powers[..., 1, ix[:, 1]]
            * powers[..., 2, ix[:, 2]])


def level_members(node_of_source, dtype, device) -> list:
    """Per routed tree level (the rows of ``node_of_source``, host
    numpy): ``(lo, member)``, ``member`` the (n, S) 0/1 matrix of nodes
    ``lo .. lo + n - 1`` (the level's range present in the sky) by
    source."""
    out = []
    for row in np.asarray(node_of_source, np.int64):
        lo = int(row.min())
        member = np.zeros((int(row.max()) + 1 - lo, row.size))
        member[row - lo, np.arange(row.size)] = 1.0
        out.append((lo, torch.as_tensor(member, dtype=dtype, device=device)))
    return out


def node_moments(src: SourceBatch, freqs: torch.Tensor,
                 node_of_source: torch.Tensor, node_center: torch.Tensor,
                 nnodes: int, abc: np.ndarray, npol: int = 4,
                 members=None) -> torch.Tensor:
    """Aggregate Stokes moments of every routed node: (nnodes, F, npol,
    Q), real: one dense membership product per routed tree level
    (module doc).  ``members``: the levels' :func:`level_members` (a
    plan keeps them; built here when None)."""
    stokes = source_stokes(src, freqs, npol)  # (S, F, npol)
    if members is None:
        members = level_members(node_of_source.cpu().numpy(), stokes.dtype,
                                freqs.device)
    pos = torch.stack([src.ll, src.mm, src.nn], dim=1)  # (S, 3)
    S = stokes.shape[0]
    out = stokes.new_zeros((nnodes, stokes[0].numel() * abc.shape[0]))
    for lev, (lo, member) in enumerate(members):
        idx = node_of_source[lev]
        mono = _monomials(pos - node_center[idx], abc)  # (S, Q)
        data = stokes[:, :, :, None] * mono[:, None, None, :].to(stokes.dtype)
        block = member.to(data.dtype) @ data.reshape(S, -1)
        out = out + torch.nn.functional.pad(
            block, (0, 0, lo, nnodes - lo - block.shape[0]))
    return out.reshape((nnodes,) + tuple(stokes.shape[1:]) + (abc.shape[0],))


def far_field_tile(u_t, v_t, w_t, freqs, centers, moments, far_idx,
                   far_valid, abc, invfact, degree,
                   fdelta: float = 0.0) -> torch.Tensor:
    """One tile's far-field coherency contribution: (F, 4, R) complex
    (:func:`far_field_tiles` of a single tile)."""
    return far_field_tiles(u_t[None], v_t[None], w_t[None], freqs, centers,
                           moments, far_idx[None], far_valid[None], abc,
                           invfact, degree, fdelta)[0]


def far_field_tiles(u_t, v_t, w_t, freqs, centers, moments, far_idx,
                    far_valid, abc, invfact, degree,
                    fdelta: float = 0.0) -> torch.Tensor:
    """Every tile's far-field coherency contribution: (T, F, 4, R)
    complex, for rows ``u_t``/``v_t``/``w_t`` (T, R) in seconds and a
    tile's far list ``far_idx``/``far_valid`` (T, Fmax).  The JAX
    package maps :func:`far_field_tile` over the tiles; here the tile
    axis is a leading batch axis of the same products.

    The Taylor coefficient ``(i 2 pi f)^deg`` splits into a real
    magnitude and a host-constant sign of ``i^deg``, so the node/moment
    contractions stay real; the complex centroid phase and the Stokes
    map touch only the contracted (T, F, npol, R) tensors.  ``fdelta >
    0`` smears in the node-centroid approximation (``sinc`` at G0)."""
    rdtype = u_t.dtype
    ctr = centers[far_idx]  # (T, Fmax, 3)
    Mg = moments[far_idx] * far_valid[..., None, None, None].to(rdtype)
    npol = Mg.shape[-2]

    # centroid phase exp(i f G0): (T, Fmax, F, R)
    G0 = 2.0 * math.pi * (u_t[:, None, :] * ctr[..., 0:1]
                          + v_t[:, None, :] * ctr[..., 1:2]
                          + w_t[:, None, :] * ctr[..., 2:3])  # (T, Fmax, R)
    ang = freqs[None, None, :, None] * G0[:, :, None, :]
    phase0 = torch.complex(torch.cos(ang), torch.sin(ang))
    if fdelta > 0.0:
        from sagecal_tpu_torch.ops.special import sinc_abs

        phase0 = phase0 * sinc_abs(G0 * (0.5 * fdelta))[:, :, None, :].to(
            rdtype)

    # baseline monomials u^a v^b w^c: (T, R, Q)
    P = _monomials(torch.stack([u_t, v_t, w_t], dim=-1), abc)

    deg = np.asarray(degree)
    mag = ((2.0 * math.pi) * freqs)[:, None] ** torch.as_tensor(
        deg, device=freqs.device)[None, :].to(freqs.dtype)
    mag = mag * torch.as_tensor(invfact, dtype=rdtype,
                                device=freqs.device)[None, :]  # (F, Q)
    re_s = torch.as_tensor(np.asarray([1.0, 0.0, -1.0, 0.0])[deg % 4],
                           dtype=rdtype, device=freqs.device)
    im_s = torch.as_tensor(np.asarray([0.0, 1.0, 0.0, -1.0])[deg % 4],
                           dtype=rdtype, device=freqs.device)
    Tr = torch.einsum("tjfpq,trq->tjfpr",
                      Mg * (mag * re_s)[None, None, :, None, :], P)
    Ti = torch.einsum("tjfpq,trq->tjfpr",
                      Mg * (mag * im_s)[None, None, :, None, :], P)
    S = torch.einsum("tjfr,tjfpr->tfpr", phase0, torch.complex(Tr, Ti))

    # constant Stokes -> coherency map on the contracted tensor
    if npol == 1:
        z = torch.zeros_like(S[:, :, 0])
        return torch.stack([S[:, :, 0], z, z, S[:, :, 0]], dim=2)
    I, Qs, U, V = S[:, :, 0], S[:, :, 1], S[:, :, 2], S[:, :, 3]
    return torch.stack([I + Qs, U + 1j * V, U - 1j * V, I - Qs], dim=2)
