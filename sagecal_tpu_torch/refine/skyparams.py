"""Free sky-parameter specification for differentiable refinement
(counterpart of ``sagecal_tpu/refine/skyparams.py``).

The refinement optimizes a flat real vector ``theta`` over a chosen
subset of the sky-model parameters (per-source fluxes, spectral
indices, positions, shapelet mode coefficients) while the rest of the
sky stays at its catalog values.  :class:`SkySpec` says which
parameters are free; it packs the current cluster list into ``theta``
and applies a ``theta`` back onto the clusters by functional updates (a
copy with the entries set), so the application is differentiable in
``theta`` and the cluster structure (source counts, types, shapelet
tables) never changes shape under the optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from sagecal_tpu_torch.ops.rime import ShapeletTable, SourceBatch


def _set(x: torch.Tensor, idx, val: torch.Tensor) -> torch.Tensor:
    """``x`` with ``x[idx] = val``, differentiable in ``val``."""
    out = x.clone()
    out[idx] = val.to(x.dtype)
    return out


class SkySpec:
    """Which sky parameters are free, as static (cluster, source) keys.

    - ``flux``: entries ``(cluster, source)``, free ``sI0`` values;
    - ``spec``: entries ``(cluster, source)``, free spectral indices
      (``spec_idx``; the predict's si == 0 gate kinks the model at 0, so
      seed a freed index nonzero);
    - ``pos``: entries ``(cluster, source)``, free (ll, mm) pairs (``nn``
      is recomputed, staying on the celestial sphere);
    - ``modes``: entries ``(cluster, flat_mode_index)``, free shapelet
      coefficients of that cluster's table row 0.

    ``theta`` is the concatenation [flux, spec, ll, mm, modes] in the
    order the keys were given.  The ``repr`` is the JAX package's, so
    configuration fingerprints agree.
    """

    def __init__(self, flux: Sequence[Tuple[int, int]] = (),
                 spec: Sequence[Tuple[int, int]] = (),
                 pos: Sequence[Tuple[int, int]] = (),
                 modes: Sequence[Tuple[int, int]] = ()):
        self.flux = tuple((int(c), int(s)) for c, s in flux)
        self.spec = tuple((int(c), int(s)) for c, s in spec)
        self.pos = tuple((int(c), int(s)) for c, s in pos)
        self.modes = tuple((int(c), int(m)) for c, m in modes)

    @property
    def nparams(self) -> int:
        return (len(self.flux) + len(self.spec) + 2 * len(self.pos)
                + len(self.modes))

    def __repr__(self):  # stable key for config fingerprints
        return (f"SkySpec(flux={self.flux}, spec={self.spec}, "
                f"pos={self.pos}, modes={self.modes})")

    def theta0(self, clusters: List[SourceBatch],
               tables: Optional[List[Optional[ShapeletTable]]] = None,
               dtype=None) -> torch.Tensor:
        """Current values of the free parameters: the flat start
        vector."""
        vals = []
        for c, s in self.flux:
            vals.append(clusters[c].sI0[s])
        for c, s in self.spec:
            vals.append(clusters[c].spec_idx[s])
        for c, s in self.pos:
            vals.append(clusters[c].ll[s])
        for c, s in self.pos:
            vals.append(clusters[c].mm[s])
        for c, m in self.modes:
            if tables is None or tables[c] is None:
                raise ValueError(
                    f"SkySpec frees shapelet mode {m} of cluster {c} "
                    f"but that cluster has no ShapeletTable")
            vals.append(tables[c].modes[0, m])
        if not vals:
            raise ValueError("SkySpec frees no parameters")
        th = torch.stack(vals)
        return th.to(dtype) if dtype is not None else th

    def apply(self, theta: torch.Tensor, clusters: List[SourceBatch],
              tables: Optional[List[Optional[ShapeletTable]]] = None,
              ) -> Tuple[List[SourceBatch],
                         Optional[List[Optional[ShapeletTable]]]]:
        """Clusters and tables with the free parameters replaced by
        ``theta`` (differentiable in ``theta``)."""
        out = list(clusters)
        out_t = list(tables) if tables is not None else None
        j = 0
        for c, s in self.flux:
            out[c] = out[c].replace(sI0=_set(out[c].sI0, s, theta[j]))
            j += 1
        for c, s in self.spec:
            out[c] = out[c].replace(
                spec_idx=_set(out[c].spec_idx, s, theta[j]))
            j += 1
        npos = len(self.pos)
        for i, (c, s) in enumerate(self.pos):
            ll = theta[j + i].to(out[c].ll.dtype)
            mm = theta[j + npos + i].to(out[c].mm.dtype)
            nn = torch.sqrt(torch.clamp(1.0 - ll ** 2 - mm ** 2,
                                        min=0.0)) - 1.0
            out[c] = out[c].replace(ll=_set(out[c].ll, s, ll),
                                    mm=_set(out[c].mm, s, mm),
                                    nn=_set(out[c].nn, s, nn))
        j += 2 * npos
        for c, m in self.modes:
            if out_t is None or out_t[c] is None:
                raise ValueError(
                    f"SkySpec frees shapelet mode {m} of cluster {c} "
                    f"but that cluster has no ShapeletTable")
            tab = out_t[c]
            out_t[c] = dataclasses.replace(
                tab, modes=_set(tab.modes, (0, m), theta[j]))
            j += 1
        return out, out_t
