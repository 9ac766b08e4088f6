"""Synthetic multi-tenant request workloads (counterpart of
``sagecal_tpu/serve/synthetic.py``).

``serve --synthetic N`` needs a reproducible mixed-shape request mix
without real observations on disk.  This module simulates small
datasets across a couple of shape classes and writes a request manifest
spread over a few tenants — enough to exercise bucketing (two buckets),
ragged padding (odd counts), and the per-tenant queues.  For equal
arguments the datasets and the manifest are the reference's (the
datasets to the predict's rounding).
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Tuple

import numpy as np
import torch

# two-point-source sky shared by every synthetic dataset
_SKY = (
    "P1 0 0 0.0 51 0 0.0 2.0 0 0 0 0 0 0 0 0 0 0 150e6\n"
    "P2 0 2 0.0 50 30 0.0 1.0 0 0 0 0 0 0 0 0 0 0 150e6\n"
)
_CLUSTER = "1 1 P1\n2 1 P2\n"

#: (nstations, ntime, nchan) shape classes the mix cycles through;
#: two classes -> two buckets
SHAPE_CLASSES: Tuple[Tuple[int, int, int], ...] = ((7, 4, 2), (8, 4, 2))


def make_synthetic_workload(workdir: str, n_requests: int,
                            n_tenants: int = 2, tilesz: int = 2,
                            shapes=SHAPE_CLASSES, open_file=None,
                            device=None) -> str:
    """Simulate datasets + write ``<workdir>/requests.json``; returns
    the manifest path.  Requests cycle tenants round-robin and shape
    classes per tenant, so every tenant's stream is homogeneous (one
    prefetcher each) while the service still sees a mixed bucket set.
    ``open_file``: the dataset opener (``io.dataset``; None:
    ``h5py.File``, ``io.memh5.MemFile`` where h5py is absent); the
    datasets are predicted on ``device`` (CUDA unless ``device="cpu"``)."""
    from sagecal_tpu_torch.io.dataset import _opener, simulate_dataset
    from sagecal_tpu_torch.io.simulate import random_jones
    from sagecal_tpu_torch.io.skymodel import load_sky

    os.makedirs(workdir, exist_ok=True)
    sky = os.path.join(workdir, "sky.txt")
    with open(sky, "w") as f:
        f.write(_SKY)
    with open(sky + ".cluster", "w") as f:
        f.write(_CLUSTER)
    dec0 = math.radians(51.0)

    datasets = {}

    def dataset_for(tenant_i: int, shape) -> str:
        key = (tenant_i, shape)
        if key in datasets:
            return datasets[key]
        nstations, ntime, nchan = shape
        path = os.path.join(
            workdir, f"tenant{tenant_i}_N{nstations}.vis.h5")
        clusters, _, _ = load_sky(sky, sky + ".cluster", 0.0, dec0,
                                  dtype=torch.float64, device=device)
        simulate_dataset(
            path, nstations=nstations, ntime=ntime, nchan=nchan,
            clusters=clusters,
            jones=random_jones(len(clusters), nstations,
                               seed=17 + tenant_i, amp=0.1,
                               dtype=np.complex128, device=device),
            noise_sigma=1e-4, seed=tenant_i, dec0=dec0,
            open_file=open_file, device=device)
        with _opener(open_file)(path, "r+") as f:
            f.attrs["ra0"] = 0.0
            f.attrs["dec0"] = dec0
        datasets[key] = path
        return path

    requests: List[dict] = []
    for i in range(n_requests):
        tenant_i = i % n_tenants
        shape = shapes[tenant_i % len(shapes)]
        nstations, ntime, nchan = shape
        path = dataset_for(tenant_i, shape)
        ntiles = max(ntime // tilesz, 1)
        requests.append({
            "request_id": f"req{i:03d}",
            "tenant": f"tenant{tenant_i}",
            "dataset": path,
            "sky_model": sky,
            "t0": (i // n_tenants % ntiles) * tilesz,
            "tilesz": tilesz,
            "solver_mode": 1,
            "max_emiter": 1, "max_iter": 2, "max_lbfgs": 4,
        })
    manifest = os.path.join(workdir, "requests.json")
    # tmp + replace: a concurrently-starting worker never reads a
    # half-written request manifest
    tmp = f"{manifest}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"requests": requests}, f, indent=1)
    os.replace(tmp, manifest)
    return manifest
