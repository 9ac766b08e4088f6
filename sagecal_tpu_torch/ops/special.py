"""Special functions of the sky predict (counterpart of
``sagecal_tpu/ops/special.py``).

Bessel J0/J1 for ring and disk sources by the Abramowitz & Stegun
9.4.1-9.4.6 polynomial and asymptotic approximations (|error| < 5e-8),
the same terms as the JAX package so the two agree to rounding, and the
bandwidth-smearing factor |sinc|.  Both branches are evaluated and
selected with ``where``: no data-dependent control flow.
"""

from __future__ import annotations

import torch


def bessel_j0(x):
    """J0(x) for real x (A&S 9.4.1 / 9.4.3)."""
    ax = x.abs()
    t = (ax / 3.0) ** 2
    small = (
        1.0
        + t * (-2.2499997
        + t * (1.2656208
        + t * (-0.3163866
        + t * (0.0444479
        + t * (-0.0039444
        + t * 0.0002100)))))
    )
    safe = torch.clamp(ax, min=3.0)
    s = 3.0 / safe
    f0 = (
        0.79788456
        + s * (-0.00000077
        + s * (-0.00552740
        + s * (-0.00009512
        + s * (0.00137237
        + s * (-0.00072805
        + s * 0.00014476)))))
    )
    th0 = (
        safe
        - 0.78539816
        + s * (-0.04166397
        + s * (-0.00003954
        + s * (0.00262573
        + s * (-0.00054125
        + s * (-0.00029333
        + s * 0.00013558)))))
    )
    large = f0 * torch.cos(th0) / torch.sqrt(safe)
    return torch.where(ax < 3.0, small, large)


def bessel_j1(x):
    """J1(x) for real x (A&S 9.4.4 / 9.4.6); odd in x."""
    ax = x.abs()
    t = (ax / 3.0) ** 2
    small = ax * (
        0.5
        + t * (-0.56249985
        + t * (0.21093573
        + t * (-0.03954289
        + t * (0.00443319
        + t * (-0.00031761
        + t * 0.00001109)))))
    )
    safe = torch.clamp(ax, min=3.0)
    s = 3.0 / safe
    f1 = (
        0.79788456
        + s * (0.00000156
        + s * (0.01659667
        + s * (0.00017105
        + s * (-0.00249511
        + s * (0.00113653
        + s * (-0.00020033))))))
    )
    th1 = (
        safe
        - 2.35619449
        + s * (0.12499612
        + s * (0.00005650
        + s * (-0.00637879
        + s * (0.00074348
        + s * (0.00079824
        + s * (-0.00029166))))))
    )
    large = f1 * torch.cos(th1) / torch.sqrt(safe)
    return torch.sign(x) * torch.where(ax < 3.0, small, large)


def sinc_abs(x):
    """|sin(x)/x| with the x == 0 limit (bandwidth smearing)."""
    zero = x == 0.0
    safe = torch.where(zero, torch.ones_like(x), x)
    return torch.where(zero, torch.ones_like(x), torch.sin(safe) / safe).abs()
