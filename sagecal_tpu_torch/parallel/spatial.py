"""Spatial regularization of the consensus solutions and model-order
selection (counterpart of ``sagecal_tpu/parallel/spatial.py``).

Elastic-net regression of the consensus variable onto a spatial basis
by FISTA (``fista.c``), the diffuse-sky constraint's initial model and
per-frequency reduction (``consensus_poly.c``, ``sagecal_slave.cpp``),
and the AIC/MDL scan over consensus orders (``mdl.c``).

Conventions (fista.c:20-36):
  Zs:    (2*Npoly*N, 2G) complex, the spatial model;
  Zbar:  (M, 2*Npoly*N, 2), the per-cluster consensus blocks;
  Phi:   (M, 2G, 2), the per-cluster basis blocks;
  Phikk: (2G, 2G) = sum_k Phi_k Phi_k^H + lambda I.

The bases (:func:`sharmonic_mode_matrix`, :func:`spatial_basis_modes`),
:func:`find_initial_spatial` and :func:`minimum_description_length` are
host math in float64 numpy, evaluated once a run.  The tensor functions
keep the precision of their inputs: complex64 at float32, complex128 at
float64 (the JAX package takes its complex dtype from the process's x64
flag instead; its command line turns x64 on for float64 runs only, so
the two agree there).  FISTA runs its ``maxiter`` steps on the device
with no host read: its step sizes are the data-independent t sequence,
computed on the host in the data's precision.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.parallel import consensus

FISTA_L_MIN = 1e-9
FISTA_L_MAX = 1e9


def _assoc_legendre(l: int, m: int, x):
    """Associated Legendre P_l^m(x) with the Condon-Shortley phase, by
    the standard recurrence (elementbeam.c:560-588 ``P``)."""
    x = np.asarray(x, np.float64)
    pmm = np.ones_like(x)
    if m > 0:
        somx2 = np.sqrt((1.0 - x) * (1.0 + x))
        fact = 1.0
        for _ in range(1, m + 1):
            pmm = pmm * (-fact) * somx2
            fact += 2.0
    if l == m:
        return pmm
    pmmp1 = x * (2.0 * m + 1.0) * pmm
    if l == m + 1:
        return pmmp1
    pll = pmm
    for i in range(m + 2, l + 1):
        pll = ((2.0 * i - 1.0) * x * pmmp1 - (i + m - 1.0) * pmm) / (i - m)
        pmm = pmmp1
        pmmp1 = pll
    return pll


def sharmonic_mode_matrix(theta, phi, n0: int) -> np.ndarray:
    """Spherical-harmonic basis (Nt, n0^2) complex128, one mode vector
    per (theta, phi) point (``sharmonic_modes``, elementbeam.c:600-816).

    Modes l = 0..n0-1, then m = -l..l; negative m is the conjugate of
    the +|m| mode with no extra (-1)^m (the reference's convention).
    Y_l^m = 0.5 sqrt((2l+1)/pi (l-m)!/(l+m)!) P_l^m(cos th) e^{i m ph}."""
    theta = np.atleast_1d(np.asarray(theta, np.float64))
    phi = np.atleast_1d(np.asarray(phi, np.float64))
    ct = np.cos(theta)
    out = np.empty((theta.shape[0], n0 * n0), np.complex128)
    idx = 0
    for l in range(n0):
        pos = {}
        for m in range(0, l + 1):
            pre = 0.5 * math.sqrt(
                (2.0 * l + 1.0) / math.pi
                * math.factorial(l - m) / math.factorial(l + m))
            pos[m] = pre * _assoc_legendre(l, m, ct) * np.exp(1j * m * phi)
        for mi in range(0, 2 * l + 1):
            m_true = mi - l
            out[:, idx] = (np.conj(pos[-m_true]) if m_true < 0
                           else pos[m_true])
            idx += 1
    return out


def cluster_centroids(clusters, nchunk_max: int = 1):
    """Flux-weighted (l, m) of every cluster (``SourceBatch`` list), each
    repeated ``nchunk_max`` times (a hybrid chunk is an effective cluster
    of the basis): two float64 numpy arrays (the master's basis setup,
    sagecal_master.cpp:293-423)."""
    cent = []
    for c in clusters:
        w = np.maximum(np.abs(c.sI0.double().cpu().numpy()), 1e-12)
        cent.append((np.average(c.ll.double().cpu().numpy(), weights=w),
                     np.average(c.mm.double().cpu().numpy(), weights=w)))
    cent = np.asarray(cent, np.float64)
    return (np.repeat(cent[:, 0], nchunk_max),
            np.repeat(cent[:, 1], nchunk_max))


def spatial_basis_modes(ll, mm, n0: int, beta: Optional[float] = None,
                        basis: str = "shapelet"):
    """Raw mode matrix (M, G) complex128 over the cluster centroids
    (sagecal_master.cpp:359-397):
      shapelet:  image-plane modes at (-l, m), scale beta, or the
        master's auto scale 4 sqrt(l_max^2 / M) when ``beta`` is None;
      sharmonic: modes at (r, th) = (sqrt(l^2 + m^2) pi/2, atan2(m, l)),
        no scale.
    Returns (modes, beta_used)."""
    ll = np.asarray(ll, np.float64)
    mm = np.asarray(mm, np.float64)
    if basis == "sharmonic":
        rr = np.sqrt(ll * ll + mm * mm) * (np.pi / 2.0)
        tt = np.arctan2(mm, ll)
        return sharmonic_mode_matrix(rr, tt, n0), 0.0
    if basis != "shapelet":
        raise ValueError(f"unknown spatial basis {basis!r}")
    from sagecal_tpu_torch.ops.shapelets import image_mode_matrix

    if beta is None or beta <= 0.0:
        l_max = max(float(np.max(np.abs(ll))), float(np.max(np.abs(mm))),
                    1e-12)
        beta = 4.0 * math.sqrt(l_max * l_max / max(len(ll), 1))
    phi = image_mode_matrix(torch.from_numpy(-ll), torch.from_numpy(mm),
                            beta, n0).numpy().astype(np.complex128)
    return phi, float(beta)


# JL004 (here and in build_spatial_basis): the JAX package's widest complex
# dtype is the default; the apps pass their data's complex dtype
def basis_blocks(modes, dtype=torch.complex128,  # torchlint: disable=JL004 — see above
                 device=None) -> torch.Tensor:
    """Mode matrix (M, G) -> per-cluster blocks Phi_k = kron(phi_k, I_2),
    (M, 2G, 2) of ``dtype`` on ``device`` (CUDA unless ``device="cpu"``),
    rows ordered (g, i) (sagecal_master.cpp:408-414)."""
    modes = torch.as_tensor(np.asarray(modes)).to(resolve_device(device),
                                                  dtype)
    M, G = modes.shape
    eye = torch.eye(2, dtype=dtype, device=modes.device)
    return torch.einsum("mg,ij->mgij", modes, eye).reshape(M, 2 * G, 2)


def build_spatial_basis(ll, mm, n0: int, beta: Optional[float] = None,
                        basis: str = "shapelet",
                        dtype=torch.complex128,  # torchlint: disable=JL004 — see basis_blocks
                        device=None) -> torch.Tensor:
    """Per-cluster basis blocks Phi (M, 2G, 2), G = n0*n0, at the cluster
    centroids (the master's basis setup, sagecal_master.cpp:293-423)."""
    modes, _ = spatial_basis_modes(ll, mm, n0, beta, basis)
    return basis_blocks(modes, dtype, device)


def phikk_matrix(Phi: torch.Tensor, lam: float = 1e-6) -> torch.Tensor:
    """sum_k Phi_k Phi_k^H + lambda I: (2G, 2G)."""
    P = torch.einsum("mac,mbc->ab", Phi, Phi.conj())
    return P + lam * torch.eye(P.shape[0], dtype=P.dtype, device=P.device)


def _soft_threshold_complex(z: torch.Tensor, thresh) -> torch.Tensor:
    """Independent re/im soft threshold (fista.c:86-99)."""
    re = torch.sign(z.real) * torch.clamp(z.real.abs() - thresh, min=0.0)
    im = torch.sign(z.imag) * torch.clamp(z.imag.abs() - thresh, min=0.0)
    return torch.complex(re, im)


def update_spatialreg_fista(Zbar: torch.Tensor, Phikk: torch.Tensor,
                            Phi: torch.Tensor, mu: float, maxiter: int = 40,
                            Z_diff: Optional[torch.Tensor] = None,
                            Psi: Optional[torch.Tensor] = None,
                            gamma: float = 0.0) -> torch.Tensor:
    """Zs = argmin sum_k ||Zbar_k - Zs Phi_k||^2 + lambda ||Zs||^2 +
    mu ||Zs||_1 [+ Psi^H (Zs - Z_diff) + gamma/2 ||Zs - Z_diff||^2] by
    ``maxiter`` FISTA steps (``update_spatialreg_fista[_with_
    diffconstraint]``, fista.c:38, 131).  Returns Zs (D, 2G), D =
    Zbar.shape[1]."""
    M, D, _ = Zbar.shape
    twoG = Phikk.shape[0]
    # the gradient's Lipschitz constant is lambda_max(Phikk), exact for
    # this quadratic (the reference's ||Phikk||_F^2 overestimates it)
    L = torch.linalg.eigvalsh(Phikk).max()
    L = torch.clamp(L, FISTA_L_MIN, FISTA_L_MAX)
    if gamma > 0.0:
        L = L + gamma
    ZbPh = torch.einsum("mdc,mgc->dg", Zbar, Phi.conj())
    thresh = mu / L
    # the momentum weights do not depend on the data: the host computes
    # them in the data's precision
    rdt = np.float32 if Zbar.dtype == torch.complex64 else np.float64
    t = rdt(1.0)
    Z = torch.zeros((D, twoG), dtype=Zbar.dtype, device=Zbar.device)
    Y = Z
    for _ in range(maxiter):
        gradf = Y @ Phikk - ZbPh
        if Z_diff is not None:
            gradf = gradf + 0.5 * Psi + 0.5 * gamma * (Y - Z_diff)
        Znew = _soft_threshold_complex(Y - gradf / L, thresh)
        t_new = rdt(0.5) * (rdt(1.0) + np.sqrt(rdt(1.0) + rdt(4.0) * t * t))
        Y = Znew + float((t - rdt(1.0)) / t_new) * (Znew - Z)
        Z, t = Znew, t_new
    return Z


def spatial_model_apply(Zs: torch.Tensor, Phi: torch.Tensor) -> torch.Tensor:
    """Per-cluster blocks Zs Phi_k (M, D, 2): the target Zbar ~ Zs Phi
    of the master's X update (sagecal_master.cpp:887-930)."""
    return torch.einsum("dg,mgc->mdc", Zs, Phi)


def minimum_description_length(
    J, rho, freqs, freq0: float, weight=None,
    polytype: int = consensus.POLY_BERNSTEIN,
    Kstart: int = 1, Kfinish: int = 5,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Scan consensus polynomial orders and score AIC/MDL
    (``minimum_description_length``, mdl.c:43-260).

    J: (F, M, K) rho-scaled solutions (the master's weight*rho*J blocks);
    rho: (M,); weight: (F,) per-frequency unflagged fractions.  Returns
    (aic, mdl, best_aic_order, best_mdl_order)."""
    J = torch.as_tensor(np.asarray(J, np.float64))
    F, M, K = J.shape
    rho = torch.as_tensor(np.asarray(rho, np.float64))
    w = (torch.ones(F, dtype=torch.float64) if weight is None
         else torch.as_tensor(np.asarray(weight, np.float64)))
    inv_rho = torch.where(rho > 0, 1.0 / torch.where(rho == 0, 1.0, rho), 0.0)
    w3 = w[:, None, None]
    inv_w = torch.where(w3 > 0, 1.0 / torch.clamp(w3, min=1e-30), 0.0)
    orders = list(range(Kstart, Kfinish + 1))
    aic, mdl = [], []
    for Npoly in orders:
        ptype = consensus.POLY_NORMALIZED if Npoly == 1 else polytype
        B = consensus.setup_polynomials(np.asarray(freqs), freq0, Npoly,
                                        ptype)
        Bi = consensus.find_prod_inverse(B, w)  # (Npoly, Npoly)
        z = torch.einsum("fp,fmk->mpk", B, J) * inv_rho[:, None, None]
        Z = torch.einsum("pq,mqk->mpk", Bi, z)
        BZ = torch.einsum("fp,mpk->fmk", B, Z)
        scaled = BZ * (rho[None, :, None] * w3)
        res = (J - scaled) * (inv_rho[None, :, None] * inv_w)
        RSS = float((res ** 2).sum()) / (K * M)
        aic.append(F * np.log(RSS / F) + 2.0 * Npoly)
        mdl.append(0.5 * F * np.log(RSS / F) + 0.5 * Npoly * np.log(F))
    aic = np.asarray(aic)
    mdl = np.asarray(mdl)
    return aic, mdl, orders[int(np.argmin(aic))], orders[int(np.argmin(mdl))]


def find_initial_spatial(B, modes, N: int) -> np.ndarray:
    """Initial diffuse model Zdiff0 (2*N*Npoly, 2G) complex128 such that
    B_f Zdiff0 Phi_k ~ 1_N kron I_2 for every frequency f and cluster k
    (``find_initial_spatial``, consensus_poly.c:1113; intent at
    sagecal_master.cpp:658-660):
    Zdiff0[p*2N + 2i + a, 2g + b] = c_p delta_ab s_g with
      c = pinv(sum_f b_f b_f^T) sum_f b_f,
      s = (sum_k phi_k)^H pinv(sum_k phi_k phi_k^H).
    The reference's loop scales by sum_f b_f instead of the derived
    pseudo-inverse product (consensus_poly.c:1455); this is the
    derivation, as in the JAX package.

    B: (Nf, Npoly) real; modes: (Meff, G) (:func:`spatial_basis_modes`)."""
    B = np.asarray(B, np.float64)
    c = np.linalg.pinv(B.T @ B) @ B.sum(axis=0)  # (Npoly,)
    phi = np.asarray(modes, np.complex128)  # (Meff, G)
    P = phi.T @ np.conj(phi)  # sum_k phi_k phi_k^H
    s = np.conj(phi.sum(axis=0)) @ np.linalg.pinv(P)  # (G,)
    Zc = np.tile(np.kron(s[None, :], np.eye(2)), (N, 1))  # (2N, 2G)
    return np.concatenate([cp * Zc for cp in c], axis=0)


def bz_spatial(Zs: torch.Tensor, B_f, N: int) -> torch.Tensor:
    """Per-frequency spatial model B_f x Zs (2N, 2G) from the full Zs
    (2*N*Npoly, 2G), Npoly-major rows: the slave's reduction of the
    master's spatial model before the diffuse re-predict
    (sagecal_slave.cpp:670-684).  ``B_f`` (Npoly,) is taken in Zs's
    real precision."""
    if not isinstance(B_f, torch.Tensor):
        B_f = torch.from_numpy(np.array(B_f))
    B_f = B_f.to(Zs.device, Zs.real.dtype)
    blocks = Zs.reshape(B_f.shape[-1], 2 * N, Zs.shape[-1])
    return torch.einsum("p,pij->ij", B_f.to(Zs.dtype), blocks)
