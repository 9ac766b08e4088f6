"""Portable-pixmap output (counterpart of ``sagecal_tpu/utils/ppm.py``;
``convert_tensor_to_image``, pngoutput.c:87-160, and the master's
``plot_spatial_model``, shapelet.c:975): per-panel normalized square
patches on the reference's three-segment blue->green->red colormap, as
binary ``P6`` PPM files, no image library needed.  Host numpy; the
spatial plot's image-plane basis is evaluated in the spatial model's
real precision, as the JAX package's command line does.  The bytes are
the JAX package's for the same model."""

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


def convert_tensor_to_image(W: np.ndarray, path: str,
                            normalize: bool = True) -> None:
    """N panels of M x M patches -> a near-square grid image: each panel
    scaled to [0, 1], except that a panel whose range is below a tenth
    of the largest range and below 1.0 plots as flat (the reference's
    noise cutoff)."""
    W = np.asarray(W, float)
    if W.ndim == 2:
        N = W.shape[0]
        M = int(round(np.sqrt(W.shape[1])))
        W = W.reshape(N, M, M)
    N, M, _ = W.shape
    panel_m = int(np.ceil(np.sqrt(N)))
    P = max(panel_m, (N + panel_m - 1) // panel_m)
    img = np.zeros((P * M, P * M))
    wmin = W.reshape(N, -1).min(axis=1)
    wmax = W.reshape(N, -1).max(axis=1)
    max_diff = float(np.max(wmax - wmin)) if N else 0.0
    for col in range(N):
        lo, hi = wmin[col], wmax[col]
        if normalize:
            if (max_diff * 0.1 > hi - lo) and (hi - lo < 1.0):
                lo, hi = 0.0, 1.0
            patch = (W[col] - lo) / max(hi - lo, 1e-30)
        else:
            patch = np.clip(W[col], 0.0, 1.0)
        r, c = divmod(col, P)
        img[r * M:(r + 1) * M, c * M:(c + 1) * M] = patch
    write_ppm(path, img)


def plot_spatial_model(Zspat, npoly: int, nstations: int, sh_n0: int,
                       beta: float, path: str, npix: int = 64,
                       extent: float = None) -> None:
    """One panel per station: the Frobenius norm of the station's poly-0
    Jones-valued shapelet series on an (l, m) grid of ``npix`` points
    over +-``extent`` (3 beta by default); the shapelet-basis branch of
    ``plot_spatial_model``.  Zspat: (2*Npoly*N, 2G) complex, the
    ``AdmmResult.Zspat`` layout (a tensor or an array)."""
    import torch

    from sagecal_tpu_torch.ops.shapelets import image_mode_matrix

    if isinstance(Zspat, torch.Tensor):
        Zspat = Zspat.detach().cpu().numpy()
    Zspat = np.asarray(Zspat)
    rdt = np.float32 if Zspat.dtype == np.complex64 else np.float64
    G = sh_n0 * sh_n0
    if extent is None:
        extent = 3.0 * beta
    grid = np.linspace(-extent, extent, npix)
    ll, mm = np.meshgrid(grid, grid)
    phi = image_mode_matrix(torch.from_numpy(ll.ravel().astype(rdt)),
                            torch.from_numpy(mm.ravel().astype(rdt)),
                            beta, sh_n0).numpy()  # (npix^2, G)
    Z = Zspat.reshape(npoly, nstations, 2, G, 2)
    patches = np.zeros((nstations, npix, npix))
    for s in range(nstations):
        Zt = np.transpose(Z[0, s], (1, 0, 2))  # (G, 2, 2) poly-0 block
        J = np.einsum("pg,gij->pij", phi, Zt)  # (npix^2, 2, 2)
        patches[s] = np.linalg.norm(J, axis=(1, 2)).reshape(npix, npix)
    convert_tensor_to_image(patches, path, normalize=True)
