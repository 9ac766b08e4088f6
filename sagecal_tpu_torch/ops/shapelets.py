"""Shapelet (Gauss-Hermite) source models: the UV-plane basis of the
predict (counterpart of the predict part of ``sagecal_tpu/ops/shapelets.py``).

- 1-D basis phi_n(x) = H_n(x) exp(-x^2/2) / sqrt(2^(n+1) n!)
  (physicists' Hermite), all n0 orders of every point from the
  three-term recurrence;
- 2-D UV mode (n1, n2) at (u, v): sign * phi_n1(u beta) * phi_n2(v beta),
  real when n1 + n2 is even (sign (-1)^((n1+n2)/2)), imaginary when odd
  (sign (-1)^((n1+n2-1)/2)), stored at flat index n2*n0 + n1;
- a source's contribution: 2 pi a b sum_m c_m mode_m at the projected,
  (1/eX, 1/eY, eP)-transformed, u-negated uv point (in wavelengths).

The image-plane basis and the product tensors go with their users
(ROADMAP.md, Queue A).
"""

from __future__ import annotations

import dataclasses
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
