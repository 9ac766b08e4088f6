"""ctypes loader for the native tool core (counterpart of
``sagecal_tpu/tools/_native.py``).

The port keeps its own copy of the C++ source,
``sagecal_tpu_torch/native/clusterlib.cpp`` (8-connected island
labelling and weighted 2-D k-means, the roles of the reference's
embedded C Clustering Library and buildsky's island walks).  It is built
with ``g++`` at first use into the git-ignored ``sagecal_tpu_torch/_build/``
(as ``kernels/build.py`` builds the CUDA sources), named by a digest of
the source and the flags, so an edited source is rebuilt and nothing is
written beside the sources.  Where the build fails (no compiler), the
functions fall back to the reference's numpy/scipy versions, so the tools
never hard-fail; :func:`backend` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "clusterlib.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
builds = 0  # g++ runs of this process


def library_path() -> str:
    """Where the built library lives: ``_build/`` and a digest of the
    source and the flags."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libsagecal_native_{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    """``g++`` into a temporary file beside ``so``, then an atomic
    rename, so concurrent first uses never load a half-written file."""
    global builds
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        builds += 1
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        lib.label_islands.restype = ctypes.c_int
        lib.kmeans_weighted.restype = ctypes.c_int
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def backend() -> str:
    """``"native"`` when the C++ library is built and loaded, else
    ``"fallback"`` (the numpy/scipy versions)."""
    return "native" if _load() is not None else "fallback"


def label_islands(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """8-connected labeling: (labels int32 (ny, nx), count)."""
    mask8 = np.ascontiguousarray(mask.astype(np.int8))
    ny, nx = mask8.shape
    lib = _load()
    if lib is not None:
        labels = np.zeros((ny, nx), np.int32)
        n = lib.label_islands(
            mask8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int(ny), ctypes.c_int(nx),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return labels, int(n)
    # fallback: scipy 8-connected structure
    from scipy import ndimage

    labels, n = ndimage.label(mask8, structure=np.ones((3, 3), int))
    return labels.astype(np.int32), int(n)


def kmeans_weighted(
    x: np.ndarray, y: np.ndarray, w: Optional[np.ndarray], k: int,
    niter: int = 50, seed: int = 7,
) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted 2-D k-means: (assignment (n,), centers (k, 2))."""
    x = np.ascontiguousarray(np.asarray(x, np.float64))
    y = np.ascontiguousarray(np.asarray(y, np.float64))
    n = x.shape[0]
    k = min(max(k, 1), max(n, 1))
    wv = (np.ascontiguousarray(np.asarray(w, np.float64))
          if w is not None else None)
    lib = _load()
    if lib is not None and n:
        assign = np.zeros((n,), np.int32)
        centers = np.zeros((k, 2), np.float64)
        pd = ctypes.POINTER(ctypes.c_double)
        lib.kmeans_weighted(
            x.ctypes.data_as(pd), y.ctypes.data_as(pd),
            wv.ctypes.data_as(pd) if wv is not None else None,
            ctypes.c_int(n), ctypes.c_int(k), ctypes.c_int(niter),
            ctypes.c_uint64(seed),
            assign.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            centers.ctypes.data_as(pd),
        )
        return assign, centers
    # numpy fallback: plain Lloyd with weighted centroids
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=k, replace=False)
    cx, cy = x[idx].copy(), y[idx].copy()
    wv2 = wv if wv is not None else np.ones(n)
    assign = np.zeros(n, np.int32)
    for _ in range(niter):
        d2 = (x[:, None] - cx[None]) ** 2 + (y[:, None] - cy[None]) ** 2
        assign = np.argmin(d2, axis=1).astype(np.int32)
        for c in range(k):
            m = assign == c
            if np.any(m):
                cx[c] = np.average(x[m], weights=wv2[m])
                cy[c] = np.average(y[m], weights=wv2[m])
    return assign, np.stack([cx, cy], axis=1)
