"""``uvwriter``: recompute a dataset's UVW coordinates, including the
lunar body-fixed frame (counterpart of ``sagecal_tpu/tools/uvwriter.py``).

Redesign of the C SAGECal's ``src/uvwriter/uvwriter.cpp`` (rewrites MS
UVW columns in the ``MOON_ME`` frame through CSPICE) for the vis.h5
container.  CSPICE and its kernels are not in this image; the Moon's
mean-Earth/rotation frame orientation is instead evaluated from the
published IAU/WGCCRE 2009 series (alpha0, delta0, W with the E1..E13
nutation arguments) — standards data, not a code port.  Earth-frame
recomputation uses the same GMST rotation as the simulator.

For each timeslot: baseline vectors in the body-fixed frame are rotated
to the celestial frame with R = Rz(alpha0 + 90deg) Rx(90deg - delta0)
Rz(W), then projected onto the (u, v, w) triad of the phase center.

Host numpy only.  The dataset is opened with ``open_file`` (None:
``h5py.File``; ``io/memh5.py::MemFile`` on a machine without h5py), as
``io/dataset.py`` opens it.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

# IAU/WGCCRE 2009 lunar orientation series (degrees; d = days since
# J2000 TDB, T = d / 36525): published constants.
_E_ARGS = [
    (125.045, -0.0529921), (250.089, -0.1059842), (260.008, 13.0120009),
    (176.625, 13.3407154), (357.529, 0.9856003), (311.589, 26.4057084),
    (134.963, 13.0649930), (276.617, 0.3287146), (34.226, 1.7484877),
    (15.134, -0.1589763), (119.743, 0.0036096), (239.961, 0.1643573),
    (25.053, 12.9590088),
]
_ALPHA_TERMS = {1: -3.8787, 2: -0.1204, 3: 0.0700, 4: -0.0172, 6: 0.0072,
                10: -0.0052, 13: 0.0043}
_DELTA_TERMS = {1: 1.5419, 2: 0.0239, 3: -0.0278, 4: 0.0068, 6: -0.0029,
                7: 0.0009, 10: 0.0008, 13: -0.0009}
_W_TERMS = {1: 3.5610, 2: 0.1208, 3: -0.0642, 4: 0.0158, 5: 0.0252,
            6: -0.0066, 7: -0.0047, 8: -0.0046, 9: 0.0028, 10: 0.0052,
            11: 0.0040, 12: 0.0019, 13: -0.0044}


def moon_orientation(jd: np.ndarray):
    """(alpha0, delta0, W) radians of the IAU_MOON frame at Julian dates."""
    d = np.asarray(jd, float) - 2451545.0
    T = d / 36525.0
    E = {i + 1: np.radians(a0 + a1 * d) for i, (a0, a1) in enumerate(_E_ARGS)}
    alpha = 269.9949 + 0.0031 * T
    delta = 66.5392 + 0.0130 * T
    W = 38.3213 + 13.17635815 * d - 1.4e-12 * d * d
    for i, c in _ALPHA_TERMS.items():
        alpha = alpha + c * np.sin(E[i])
    for i, c in _DELTA_TERMS.items():
        delta = delta + c * np.cos(E[i])
    for i, c in _W_TERMS.items():
        W = W + c * np.sin(E[i])
    return np.radians(alpha), np.radians(delta), np.radians(W)


def _rz(a):
    ca, sa = np.cos(a), np.sin(a)
    z = np.zeros_like(ca)
    o = np.ones_like(ca)
    return np.stack([
        np.stack([ca, -sa, z], -1),
        np.stack([sa, ca, z], -1),
        np.stack([z, z, o], -1),
    ], -2)


def _rx(a):
    ca, sa = np.cos(a), np.sin(a)
    z = np.zeros_like(ca)
    o = np.ones_like(ca)
    return np.stack([
        np.stack([o, z, z], -1),
        np.stack([z, ca, -sa], -1),
        np.stack([z, sa, ca], -1),
    ], -2)


def body_to_celestial(jd: np.ndarray, body: str = "moon") -> np.ndarray:
    """(T, 3, 3) rotation matrices body-fixed -> celestial at each jd."""
    if body == "moon":
        alpha, delta, W = moon_orientation(jd)
        return _rz(alpha + np.pi / 2) @ _rx(np.pi / 2 - delta) @ _rz(W)
    # earth: GMST rotation about z (the simulator's synthesis frame)
    from sagecal_tpu_torch.ops.transforms import jd2gmst

    gmst = np.asarray([jd2gmst(j) for j in np.atleast_1d(jd)])
    return _rz(gmst)


def uvw_from_positions(xyz, ant_p, ant_q, jd, ra0, dec0, body="moon"):
    """Per-timeslot UVW (metres) for body-fixed station positions.

    xyz: (N, 3); ant_p/ant_q: (nbase,); jd: (T,).  Returns
    (T, nbase, 3)."""
    R = body_to_celestial(np.asarray(jd), body)  # (T, 3, 3)
    B = xyz[ant_p] - xyz[ant_q]  # (nbase, 3)
    Bc = np.einsum("tij,bj->tbi", R, B)  # celestial-frame baselines
    sr, cr = math.sin(ra0), math.cos(ra0)
    sd, cd = math.sin(dec0), math.cos(dec0)
    uhat = np.asarray([-sr, cr, 0.0])
    vhat = np.asarray([-cr * sd, -sr * sd, cd])
    what = np.asarray([cr * cd, sr * cd, sd])
    return np.stack(
        [Bc @ uhat, Bc @ vhat, Bc @ what], axis=-1
    )


def rewrite_uvw(h5_path: str, positions_path: str, body: str = "moon",
                log=print, open_file=None) -> None:
    """Rewrite /u /v /w of a vis.h5 from body-fixed station positions
    (the uvwriter main loop: read station coords + times, write UVW);
    ``open_file`` opens the dataset (module doc)."""
    from sagecal_tpu_torch.io.dataset import _opener

    xyz = np.loadtxt(positions_path)
    with _opener(open_file)(h5_path, "r+") as f:
        ant_p = np.asarray(f["ant_p"])
        ant_q = np.asarray(f["ant_q"])
        ntime = f["u"].shape[0]
        jd0 = float(f.attrs.get("time_jd0", 2451545.0))
        dt = float(f.attrs.get("deltat", 1.0))
        ra0 = float(f.attrs["ra0"])
        dec0 = float(f.attrs["dec0"])
        jd = jd0 + np.arange(ntime) * dt / 86400.0
        if xyz.shape[0] < int(max(ant_p.max(), ant_q.max())) + 1:
            raise ValueError(
                f"{positions_path}: {xyz.shape[0]} stations < dataset needs"
            )
        uvw = uvw_from_positions(xyz, ant_p, ant_q, jd, ra0, dec0, body)
        f["u"][...] = uvw[..., 0]
        f["v"][...] = uvw[..., 1]
        f["w"][...] = uvw[..., 2]
    log(f"uvwriter: rewrote UVW of {h5_path} in the {body} frame")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.tools.uvwriter",
        description="recompute dataset UVW in the lunar (or earth) frame "
        "(reference src/uvwriter; IAU 2009 lunar orientation in place of "
        "CSPICE)",
    )
    ap.add_argument("-d", "--dataset", required=True, help="vis.h5 file")
    ap.add_argument("-p", "--positions", required=True,
                    help="station positions text file (N x 3, metres, "
                    "body-fixed)")
    ap.add_argument("-b", "--body", default="moon",
                    choices=("moon", "earth"))
    args = ap.parse_args(argv)
    rewrite_uvw(args.dataset, args.positions, args.body)
    return 0


if __name__ == "__main__":
    sys.exit(main())
