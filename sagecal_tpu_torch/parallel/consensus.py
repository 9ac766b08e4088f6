"""Consensus health metrics (counterpart of
``sagecal_tpu/parallel/consensus.py``).

Only :func:`band_imbalance` so far, the straggler gauge that
``obs/trace.py::straggler_stats`` reads; the consensus ADMM itself is
ROADMAP.md's A7.
"""

from __future__ import annotations

import numpy as np


def band_imbalance(band_seconds, eps: float = 1e-30):
    """Per-band work-imbalance gauges ``(ratio, skew, argmax)``: the
    slowest/median ratio (the straggler gauge: a collective over bands
    runs at the pace of the slowest, so ratio ~1 wastes nothing), the
    relative skew ``(max - mean) / mean`` and the index of the slowest
    band.  ``band_seconds``: (Nf,) per-band wall seconds, real or
    attributed.  The median of an even count averages the two middle
    values (numpy's, as the JAX package's ``jnp.median``)."""
    t = np.asarray(band_seconds, dtype=np.float64)
    med = np.median(t)
    mean = np.mean(t)
    ratio = np.max(t) / max(med, eps)
    skew = (np.max(t) - mean) / max(mean, eps)
    return float(ratio), float(skew), int(np.argmax(t))
