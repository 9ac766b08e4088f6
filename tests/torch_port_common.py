"""Helpers shared by the tests that hold sagecal_tpu_torch against sagecal_tpu.

Data crosses between the packages as numpy arrays only: the JAX
package's tile is flattened to a dict of numpy arrays and handed to
``sagecal_tpu_torch.interop.tile_from_numpy``.
"""

import numpy as np
import pytest
import torch

VIS_FIELDS = ("u", "v", "w", "ant_p", "ant_q", "vis", "mask", "freqs",
              "time_idx")
STATIC_FIELDS = ("freq0", "deltaf", "deltat", "tilesz", "nbase", "nstations")


def tile_arrays(data, cdata, p0) -> dict:
    """JAX VisData / ClusterData / p0 -> the numpy dict of the interop
    contract."""
    d = {k: np.array(getattr(data, k)) for k in VIS_FIELDS}
    d.update({k: getattr(data, k) for k in STATIC_FIELDS})
    d.update(coh=np.array(cdata.coh), chunk_map=np.array(cdata.chunk_map),
             nchunk=np.array(cdata.nchunk), p0=np.array(p0))
    return d


def jax_entry_tile(dtype=np.float32, **kw):
    """The ``__graft_entry__.entry()`` tile (8 stations, 2 clusters),
    built by the JAX package, and its numpy dict."""
    from __graft_entry__ import _build_tile

    data, cdata, p0 = _build_tile(dtype=dtype, **kw)
    return data, cdata, p0, tile_arrays(data, cdata, p0)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel(a, b) -> float:
    """Relative difference of two scalars."""
    return abs(float(a) - float(b)) / abs(float(b))


def norm_rel(a, b) -> float:
    """||a - b|| / ||b|| over whole arrays."""
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(autouse=True)
def free_jax_programs():
    """Drop the JAX programs a test compiled when it ends (autouse in the
    modules that import it): each JAX app run compiles its own, and an
    xdist worker would otherwise keep every one it ever ran."""
    yield
    import jax

    jax.clear_caches()
