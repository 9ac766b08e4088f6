"""Minimal FITS image I/O (no cfitsio/astropy dependency; counterpart of
``sagecal_tpu/io/fits.py``, a copy of its numpy code).

The reference's offline tools read and write FITS through cfitsio +
wcslib (the C SAGECal's ``src/restore/restore.c``,
``src/buildsky/buildsky.c``).  Neither library is in this image, and
the tools only need simple 2-D (or trailing-degenerate-axis) float
images with a linear/SIN celestial WCS — which the FITS standard
encodes in plain 2880-byte ASCII header blocks.  This is a standards
implementation (FITS 4.0, NASA/IAUFWG), not a port.

Supported: BITPIX -32/-64/8/16/32 primary HDUs, NAXIS up to 4 with
degenerate trailing axes, BSCALE/BZERO, CRPIX/CRVAL/CDELT/CTYPE for the
first two axes.  Written files use BITPIX=-32 with a SIN projection —
the radio-interferometric default the reference's tools assume.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

_BLOCK = 2880


@dataclasses.dataclass
class FitsWCS:
    """Linear WCS of the first two image axes (degrees, FITS 1-based
    reference pixel)."""

    crval1: float = 0.0
    crval2: float = 0.0
    crpix1: float = 1.0
    crpix2: float = 1.0
    cdelt1: float = -1.0 / 3600.0
    cdelt2: float = 1.0 / 3600.0
    ctype1: str = "RA---SIN"
    ctype2: str = "DEC--SIN"

    def pixel_to_lm(self, px, py):
        """Pixel (0-based) -> direction cosines (l, m) about the
        reference direction (SIN projection: l,m ARE the projected
        coordinates, in radians)."""
        d2r = math.pi / 180.0
        l = (np.asarray(px) + 1.0 - self.crpix1) * self.cdelt1 * d2r
        m = (np.asarray(py) + 1.0 - self.crpix2) * self.cdelt2 * d2r
        return l, m

    def lm_to_pixel(self, l, m):
        d2r = math.pi / 180.0
        px = np.asarray(l) / (self.cdelt1 * d2r) + self.crpix1 - 1.0
        py = np.asarray(m) / (self.cdelt2 * d2r) + self.crpix2 - 1.0
        return px, py

    def pixel_to_radec(self, px, py):
        """Pixel -> (ra, dec) radians via the inverse SIN projection
        about (crval1, crval2)."""
        l, m = self.pixel_to_lm(px, py)
        ra0 = self.crval1 * math.pi / 180.0
        dec0 = self.crval2 * math.pi / 180.0
        n = np.sqrt(np.maximum(1.0 - l * l - m * m, 0.0))
        dec = np.arcsin(m * np.cos(dec0) + n * np.sin(dec0))
        ra = ra0 + np.arctan2(l, n * np.cos(dec0) - m * np.sin(dec0))
        return ra, dec


def _card(key: str, value, comment: str = "") -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
        s = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        s = f"{key:<8}= {value:>20d}"
    elif isinstance(value, float):
        s = f"{key:<8}= {value:>20.12E}"
    else:
        s = f"{key:<8}= '{value:<8}'"
    if comment:
        s += f" / {comment}"
    return s[:80].ljust(80).encode("ascii")


def write_fits_image(
    path: str,
    image: np.ndarray,
    wcs: Optional[FitsWCS] = None,
    extra: Optional[Dict[str, float]] = None,
) -> None:
    """Write a 2-D image (ny, nx) as a BITPIX=-32 primary HDU."""
    wcs = wcs or FitsWCS()
    ny, nx = image.shape
    cards = [
        _card("SIMPLE", True, "minimal FITS (sagecal-tpu)"),
        _card("BITPIX", -32),
        _card("NAXIS", 2),
        _card("NAXIS1", nx),
        _card("NAXIS2", ny),
        _card("CTYPE1", wcs.ctype1),
        _card("CRVAL1", float(wcs.crval1)),
        _card("CRPIX1", float(wcs.crpix1)),
        _card("CDELT1", float(wcs.cdelt1)),
        _card("CTYPE2", wcs.ctype2),
        _card("CRVAL2", float(wcs.crval2)),
        _card("CRPIX2", float(wcs.crpix2)),
        _card("CDELT2", float(wcs.cdelt2)),
        _card("BUNIT", "JY/PIXEL"),
    ]
    for k, v in (extra or {}).items():
        cards.append(_card(k[:8].upper(), float(v)))
    cards.append(b"END".ljust(80))
    hdr = b"".join(cards)
    hdr += b" " * (-len(hdr) % _BLOCK)
    data = np.asarray(image, ">f4").tobytes()
    data += b"\x00" * (-len(data) % _BLOCK)
    with open(path, "wb") as fp:
        fp.write(hdr)
        fp.write(data)


def read_fits_image(path: str) -> Tuple[np.ndarray, FitsWCS, Dict[str, float]]:
    """Read the primary HDU image; returns (image (ny, nx), wcs, header).

    Degenerate trailing axes (frequency/Stokes of radio images) are
    squeezed, mirroring the reference tools' use of the first plane.
    """
    with open(path, "rb") as fp:
        raw = fp.read()
    # parse header cards until END
    hdr: Dict[str, object] = {}
    off = 0
    done = False
    while not done:
        block = raw[off:off + _BLOCK]
        if len(block) < _BLOCK:
            raise ValueError(f"{path}: truncated FITS header")
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if card[8:10] != "= ":
                continue
            val = card[10:].split("/")[0].strip()
            if val.startswith("'"):
                hdr[key] = val.strip("'").strip()
            elif val in ("T", "F"):
                hdr[key] = val == "T"
            else:
                try:
                    hdr[key] = int(val)
                except ValueError:
                    try:
                        hdr[key] = float(val)
                    except ValueError:
                        hdr[key] = val
        off += _BLOCK
    bitpix = int(hdr["BITPIX"])
    naxis = int(hdr["NAXIS"])
    shape = [int(hdr[f"NAXIS{i}"]) for i in range(naxis, 0, -1)]
    count = int(np.prod(shape)) if shape else 0
    dt = {-64: ">f8", -32: ">f4", 8: ">u1", 16: ">i2", 32: ">i4"}[bitpix]
    nbytes = count * np.dtype(dt).itemsize
    data = np.frombuffer(raw[off:off + nbytes], dt).reshape(shape)
    data = np.asarray(data, np.float64)
    data = data * float(hdr.get("BSCALE", 1.0)) + float(hdr.get("BZERO", 0.0))
    while data.ndim > 2:
        data = data[0]
    wcs = FitsWCS(
        crval1=float(hdr.get("CRVAL1", 0.0)),
        crval2=float(hdr.get("CRVAL2", 0.0)),
        crpix1=float(hdr.get("CRPIX1", 1.0)),
        crpix2=float(hdr.get("CRPIX2", 1.0)),
        cdelt1=float(hdr.get("CDELT1", -1.0 / 3600.0)),
        cdelt2=float(hdr.get("CDELT2", 1.0 / 3600.0)),
        ctype1=str(hdr.get("CTYPE1", "RA---SIN")),
        ctype2=str(hdr.get("CTYPE2", "DEC--SIN")),
    )
    numeric = {k: float(v) for k, v in hdr.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    return data, wcs, numeric
