"""Portable-pixmap output (the writer of ``sagecal_tpu/utils/ppm.py``):
the reference's three-segment blue->green->red colormap and binary
``P6`` PPM files, no image library needed.  The spatial-model plots of
that module wait for their app (ROADMAP.md, A7)."""

from __future__ import annotations

import numpy as np


def _colormap(vals: np.ndarray) -> np.ndarray:
    """[0,1] floats -> (..., 3) uint8 on the reference's 768-step
    blue->green->red ramp."""
    v = np.clip((vals * 767).astype(int), 0, 767)
    off = (v % 256).astype(np.uint8)
    rgb = np.zeros(vals.shape + (3,), np.uint8)
    lo = v < 256
    mid = (v >= 256) & (v < 512)
    hi = v >= 512
    rgb[lo, 2] = off[lo]
    rgb[mid, 1] = off[mid]
    rgb[mid, 2] = 255 - off[mid]
    rgb[hi, 0] = off[hi]
    rgb[hi, 1] = 255 - off[hi]
    return rgb


def write_ppm(path: str, buffer2d: np.ndarray) -> None:
    """Write a [0,1]-valued 2-D array as a binary P6 PPM."""
    h, w = buffer2d.shape
    rgb = _colormap(np.asarray(buffer2d, float))
    with open(path, "wb") as fp:
        fp.write(f"P6\n{w} {h} 255\n".encode())
        fp.write(rgb.tobytes())
