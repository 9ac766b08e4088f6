"""Shapelet (Gauss-Hermite) source models: the UV-plane basis of the
predict (counterpart of the predict part of ``sagecal_tpu/ops/shapelets.py``).

- 1-D basis phi_n(x) = H_n(x) exp(-x^2/2) / sqrt(2^(n+1) n!)
  (physicists' Hermite), all n0 orders of every point from the
  three-term recurrence;
- 2-D UV mode (n1, n2) at (u, v): sign * phi_n1(u beta) * phi_n2(v beta),
  real when n1 + n2 is even (sign (-1)^((n1+n2)/2)), imaginary when odd
  (sign (-1)^((n1+n2-1)/2)), stored at flat index n2*n0 + n1;
- a source's contribution: 2 pi a b sum_m c_m mode_m at the projected,
  (1/eX, 1/eY, eP)-transformed, u-negated uv point (in wavelengths);
- the image-plane basis phi_n(x / beta) / sqrt(beta)
  (:func:`image_mode_matrix`, the spatial basis and the spatial plot);
- the product algebra of the diffuse-sky re-predict: the 1-D
  multiplication tensor (:func:`shapelet_product_tensor`, a triple-Hermite
  recurrence), the Gauss-Hermite triple integrals
  (:func:`hermite_product_tensor`) and the Jones-valued 2-D product
  (:func:`shapelet_product_jones`).  The tensors are host numpy in
  float64, built once per shape and scales; the product's two mode
  contractions are ``torch.einsum`` on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from sagecal_tpu_torch.core.types import complex_dtype_of


def hermite_basis_1d(x: torch.Tensor, n0: int) -> torch.Tensor:
    """phi_n(x) for n < n0: x (...,) -> (..., n0)."""
    expv = torch.exp(-0.5 * x * x)
    lognorm = np.array([-0.5 * ((n + 1) * math.log(2.0) + math.lgamma(n + 1))
                        for n in range(n0)])
    norm = torch.as_tensor(np.exp(lognorm), dtype=x.dtype, device=x.device)
    if n0 == 1:
        return (expv * norm[0])[..., None]
    hs = [torch.ones_like(x), 2.0 * x]
    for n in range(2, n0):
        hs.append(2.0 * x * hs[-1] - 2.0 * float(n - 1) * hs[-2])
    H = torch.stack(hs, dim=-1)  # (..., n0)
    return H * expv[..., None] * norm


def uv_mode_signs(n0: int):
    """(sign, is_imag) numpy arrays (n0, n0) for modes (n1, n2); index
    [n2, n1] is the reference's column-major order modes[n2*n0 + n1]."""
    n1 = np.arange(n0)[None, :]
    n2 = np.arange(n0)[:, None]
    s = n1 + n2
    is_imag = (s % 2) == 1
    sign = np.where(is_imag, (-1.0) ** (((s - 1) // 2) % 2),
                    (-1.0) ** ((s // 2) % 2))
    return sign, is_imag


def uv_mode_vectors(u: torch.Tensor, v: torch.Tensor, beta, n0: int):
    """Complex mode tensor (..., n0*n0): mode (n1, n2) at n2*n0 + n1.
    ``beta`` a float or a tensor broadcasting against ``u``."""
    pu = hermite_basis_1d(u * beta, n0)  # (..., n0) over n1
    pv = hermite_basis_1d(v * beta, n0)  # over n2
    prod = pv[..., :, None] * pu[..., None, :]  # (..., n2, n1)
    sign, is_imag = uv_mode_signs(n0)
    fac = torch.as_tensor(np.where(is_imag, 1j, 1.0) * sign,
                          dtype=complex_dtype_of(u.dtype), device=u.device)
    out = prod * fac
    return out.reshape(out.shape[:-2] + (n0 * n0,))


@dataclasses.dataclass
class ShapeletModel:
    """One shapelet source's model: modes c_m (n0*n0,), scale beta and
    the linear transform (eX, eY, eP)."""

    modes: torch.Tensor
    beta: float
    n0: int
    eX: float = 1.0
    eY: float = 1.0
    eP: float = 0.0


def shapelet_uv_contrib(u, v, w, model: ShapeletModel, cxi=1.0, sxi=0.0,
                        cphi=1.0, sphi=0.0, use_projection: bool = True):
    """Complex visibility-plane factor of a shapelet source at uv points
    in wavelengths: u, v, w (...,) -> complex (...,)."""
    if use_projection:
        up = -u * cxi + v * cphi * sxi - w * sphi * sxi
        vp = -u * sxi - v * cphi * cxi + w * sphi * cxi
    else:
        up, vp = u, v
    a = 1.0 / model.eX
    b = 1.0 / model.eY
    cp, sp = math.cos(model.eP), math.sin(model.eP)
    ut = a * (cp * up - sp * vp)
    vt = b * (sp * up + cp * vp)
    Av = uv_mode_vectors(-ut, vt, model.beta, model.n0)
    s = Av @ model.modes.to(Av.dtype)
    return 2.0 * math.pi * a * b * s


def image_mode_matrix(l: torch.Tensor, m: torch.Tensor, beta: float, n0: int):
    """Image-plane basis (..., n0*n0): mode (n1, n2) at (l, m) / beta,
    normalized by 1/beta, at flat index n2*n0 + n1."""
    rb = torch.sqrt(torch.as_tensor(beta, dtype=l.dtype, device=l.device))
    pu = hermite_basis_1d(l / beta, n0) / rb
    pv = hermite_basis_1d(m / beta, n0) / rb
    prod = pv[..., :, None] * pu[..., None, :]
    return prod.reshape(prod.shape[:-2] + (n0 * n0,))


@functools.lru_cache(maxsize=64)
def _product_tensor(L: int, M: int, N: int, alpha: float, beta: float,
                    gamma: float, normalize: bool) -> np.ndarray:
    nu = 1.0 / math.sqrt(alpha ** -2 + beta ** -2 + gamma ** -2)
    a, b, c = (math.sqrt(2.0) * nu / s for s in (alpha, beta, gamma))
    # H(0,0,0) = 1, zero for odd l+m+n; each entry raised along the
    # last index that can be raised (n, else m, else l)
    H = np.zeros((L + 1, M + 1, N + 1))
    H[0, 0, 0] = 1.0

    def val(l, m, n):
        if l < 0 or m < 0 or n < 0:
            return 0.0
        return H[l, m, n]

    for tot in range(0, L + M + N, 2):
        for l in range(0, L + 1):
            for m in range(0, M + 1):
                n = tot + 2 - l - m
                if n < 0 or n > N:
                    continue
                if n > 0:
                    H[l, m, n] = (
                        2.0 * (n - 1) * (c * c - 1.0) * val(l, m, n - 2)
                        + 2.0 * l * c * a * val(l - 1, m, n - 1)
                        + 2.0 * m * c * b * val(l, m - 1, n - 1))
                elif m > 0:
                    H[l, m, n] = (
                        2.0 * (m - 1) * (b * b - 1.0) * val(l, m - 2, n)
                        + 2.0 * n * b * c * val(l, m, n - 1)
                        + 2.0 * l * b * a * val(l - 1, m - 1, n))
                else:
                    H[l, m, n] = (
                        2.0 * (l - 1) * (a * a - 1.0) * val(l - 2, m, n)
                        + 2.0 * m * a * b * val(l - 1, m - 1, n)
                        + 2.0 * n * a * c * val(l - 1, m, n - 1))
    B = np.zeros((L, M, N))
    for l in range(L):
        for m in range(M):
            for n in range(N):
                if (l + m + n) % 2 == 0:
                    B[l, m, n] = nu * H[l, m, n] / math.sqrt(
                        2.0 ** (l + m + n) * math.sqrt(math.pi)
                        * math.factorial(l) * math.factorial(m)
                        * math.factorial(n) * alpha * beta * gamma)
    # the basis functions have norm^2 sqrt(pi)/2, so the exact product
    # coefficient is pi^(1/4) times the raw formula
    B = B * math.pi ** 0.25
    if normalize:
        # the reference's arbitrary overall scale (LMN)^(1/8)/||B||_F
        nrm = np.linalg.norm(B)
        if nrm > 0:
            B = B * ((L * M * N) ** 0.125 / nrm)
    B.setflags(write=False)
    return B


def shapelet_product_tensor(L: int, M: int, N: int, alpha: float,
                            beta: float, gamma: float,
                            normalize: bool = True) -> np.ndarray:
    """1-D multiplication tensor B[l; m, n] (L, M, N), float64 numpy: the
    decomposition of phi_m(x/beta) phi_n(x/gamma) onto phi_l(x/alpha)
    (``shapelet_product_tensor``, shapelet.c:640-692).  ``normalize``
    applies the reference's overall scale (LMN)^(1/8)/||B||_F; False
    keeps the exact decomposition.  Built once per arguments (cached)."""
    return _product_tensor(int(L), int(M), int(N), float(alpha), float(beta),
                           float(gamma), bool(normalize)).copy()


def shapelet_product_jones(T, f: torch.Tensor, g: torch.Tensor,
                           hermitian: bool = False) -> torch.Tensor:
    """2-D Jones-valued shapelet product h = f x g (g^H per mode when
    ``hermitian``; ``shapelet_product_jones``, shapelet.c:864-960): the
    2-D tensor is the Kronecker square of the 1-D ``T`` (L, M, N).

    f: (..., M*M, 2, 2), g: (..., N*N, 2, 2), flat mode index m2*M + m1;
    returns (..., L*L, 2, 2) with index l2*L + l1."""
    L, M, N = T.shape
    fm = f.reshape(f.shape[:-3] + (M, M, 2, 2))  # [m2, m1]
    gm = g.reshape(g.shape[:-3] + (N, N, 2, 2))
    if hermitian:
        gm = gm.transpose(-1, -2).conj()
    # FG[..., m2, m1, n2, n1, i, j] = f[m2, m1] @ g[n2, n1]
    FG = torch.einsum("...abik,...cdkj->...abcdij", fm, gm)
    Tt = torch.as_tensor(np.asarray(T), device=f.device).to(FG.dtype)
    h = torch.einsum("lac,kbd,...abcdij->...lkij", Tt, Tt, FG)
    return h.reshape(h.shape[:-4] + (L * L, 2, 2))


def hermite_product_tensor(n0a: int, n0b: int, n0c: int,
                           nquad: int = 64) -> np.ndarray:
    """Triple integrals T[i, j, k] = int phi_i phi_j phi_k dx by
    Gauss-Hermite quadrature (the ``shapelet_product`` tensors,
    shapelet.c:523-553): (n0a, n0b, n0c) float64 numpy."""
    x, wq = np.polynomial.hermite.hermgauss(nquad)

    # phi_i phi_j phi_k = H~_i H~_j H~_k exp(-3x^2/2): the weight carries
    # two of the gaussians, ``ex`` the third
    def phi(n, xx):
        H = np.polynomial.hermite.hermval(xx, np.eye(max(n0a, n0b, n0c))[n])
        return H / np.sqrt(2.0 ** (n + 1) * math.factorial(n))

    T = np.zeros((n0a, n0b, n0c))
    ex = np.exp(-0.5 * x * x)
    for i in range(n0a):
        pi = phi(i, x)
        for j in range(n0b):
            pj = phi(j, x)
            for k in range(n0c):
                T[i, j, k] = np.sum(wq * pi * pj * phi(k, x) * ex)
    return T
