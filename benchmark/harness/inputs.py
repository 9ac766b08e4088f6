"""A deployment's observation, made from the seed: the one generator of
every cell's inputs.

The configuration file gives the array (station groups and their
extent, the site's latitude), the field, the band, the sky (clusters,
sources a cluster, the share of Gaussians, flux and spectral index
ranges), the gains' spread and the noise; the mix gives the tiles an
app run covers.

One observation a configuration: the station positions, the sky and
the true gains (one set a tile: the ionosphere decorrelates over a
solution interval) are drawn, in that order, from a generator seeded by
the configuration's ``observation_seed``.  ``--seed`` draws only each
tile's noise, from a second generator.  So runs of any seed do the same
work on the same sky in the same order, and numbers that depend on the
solve (its residual ratio) move only with the noise.

Each tile's visibilities are the true gains applied to the sky's
coherencies (:mod:`benchmark.reference.rime`, float64) plus complex
Gaussian noise.  They go to an in-memory ``vis.h5`` (the program's
``io/memh5.py::MemFile``, the container the app reads on a machine
without ``h5py``); the sky, the cluster file and, for a subtraction,
the true gains as a solutions file are text files.  The sky's numbers
are read back from the text as the program will read them, so the
reference uses exactly what the program is given.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from benchmark.reference import rime

SIDEREAL_RAD_PER_S = 7.2921150e-5


@dataclasses.dataclass
class Observation:
    path: str  # the in-memory vis.h5
    sky_path: str
    cluster_path: str
    truth_path: str  # the true gains as a solutions file
    nstations: int
    nbase: int
    ntime: int
    tilesz: int
    ntiles: int
    freqs: np.ndarray  # (F,) Hz
    chan_width: float
    ra0: float
    dec0: float
    u: np.ndarray  # (ntime * nbase,) metres, baseline fastest
    v: np.ndarray
    w: np.ndarray
    ant_p: np.ndarray  # (nbase,)
    ant_q: np.ndarray
    clusters: list  # per cluster: dict of source lists (rime.source_table)

    @property
    def nclusters(self) -> int:
        return len(self.clusters)

    @property
    def freq0(self) -> float:
        return float(np.mean(self.freqs))

    @property
    def bandwidth(self) -> float:
        return self.chan_width * len(self.freqs)

    def read(self, column: str, t0: int, t1: int) -> np.ndarray:
        """Timeslots [t0, t1) of a column of the in-memory file, (rows,
        F, 2, 2) with the baseline fastest."""
        from sagecal_tpu_torch.io.memh5 import MemFile

        a = MemFile(self.path, "r")[column][t0:t1]
        return a.reshape((-1,) + a.shape[2:])


def _uniform(g, n, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=dev,
                                       dtype=torch.float64)


def station_layout(groups: list, g, dev) -> torch.Tensor:
    """(N, 2) east, north in metres, group by group.  Kinds: ``disk``
    (uniform over a disk of ``radius_m``), ``log_ring`` (log-uniform
    radius in [rmin_m, rmax_m], uniform azimuth), ``spiral_arms``
    (``arms`` logarithmic spirals of ``pitch`` radians a radial e-fold
    from rmin_m to rmax_m, ``per_group`` stations a group scattered over
    a disk of ``group_radius_m`` around points spaced evenly in log
    radius along each arm)."""
    parts = []
    for grp in groups:
        n, kind = int(grp["count"]), grp["kind"]
        if kind == "disk":
            r = grp["radius_m"] * torch.sqrt(_uniform(g, n, 0, 1, dev))
            th = _uniform(g, n, 0, 2 * math.pi, dev)
        elif kind == "log_ring":
            r = torch.exp(_uniform(g, n, math.log(grp["rmin_m"]),
                                   math.log(grp["rmax_m"]), dev))
            th = _uniform(g, n, 0, 2 * math.pi, dev)
        elif kind == "spiral_arms":
            per, arms = int(grp["per_group"]), int(grp["arms"])
            ngroups = n // per
            if ngroups * per != n or ngroups % arms:
                raise ValueError(f"spiral_arms: {n} stations do not make "
                                 f"{arms} arms of groups of {per}")
            along = ngroups // arms
            lr = torch.linspace(math.log(grp["rmin_m"]),
                                math.log(grp["rmax_m"]), along,
                                dtype=torch.float64, device=dev)
            arm = torch.arange(arms, device=dev, dtype=torch.float64)
            ang = (arm[:, None] * 2 * math.pi / arms
                   + grp["pitch"] * (lr[None, :] - lr[0]))
            cx = (torch.exp(lr)[None, :] * torch.cos(ang)).reshape(-1)
            cy = (torch.exp(lr)[None, :] * torch.sin(ang)).reshape(-1)
            rr = grp["group_radius_m"] * torch.sqrt(_uniform(g, n, 0, 1, dev))
            tt = _uniform(g, n, 0, 2 * math.pi, dev)
            x = cx.repeat_interleave(per) + rr * torch.cos(tt)
            y = cy.repeat_interleave(per) + rr * torch.sin(tt)
            parts.append(torch.stack([x, y], dim=1))
            continue
        else:
            raise ValueError(f"unknown station group kind {kind!r}")
        parts.append(torch.stack([r * torch.cos(th), r * torch.sin(th)], 1))
    return torch.cat(parts)


def uvw_track(en, ant_p, ant_q, ntime: int, deltat: float, lat: float,
              dec0: float):
    """u, v, w (ntime * nbase,) metres of baselines q - p over ``ntime``
    slots of ``deltat`` s centred on transit, for a planar array at
    latitude ``lat`` observing declination ``dec0`` (radians)."""
    dev = en.device
    east, north = en[:, 0], en[:, 1]
    X = -math.sin(lat) * north
    Y = east
    Z = math.cos(lat) * north
    Lx, Ly, Lz = (X[ant_q] - X[ant_p], Y[ant_q] - Y[ant_p],
                  Z[ant_q] - Z[ant_p])
    t = torch.arange(ntime, dtype=torch.float64, device=dev)
    H = SIDEREAL_RAD_PER_S * deltat * (t - (ntime - 1) / 2.0)
    sH, cH = torch.sin(H)[:, None], torch.cos(H)[:, None]
    sd, cd = math.sin(dec0), math.cos(dec0)
    u = sH * Lx + cH * Ly
    v = -sd * cH * Lx + sd * sH * Ly + cd * Lz
    w = cd * cH * Lx - cd * sH * Ly + sd * Lz
    return u.reshape(-1), v.reshape(-1), w.reshape(-1)


def _hms(ra: float) -> tuple:
    """ra (rad, >= 0) -> ("h", "m", "s") text, seconds to 1e-9."""
    h = (ra % (2 * math.pi)) * 12.0 / math.pi
    hh = int(h)
    mm = int((h - hh) * 60.0)
    ss = (h - hh - mm / 60.0) * 3600.0
    return str(hh), str(mm), f"{ss:.9f}"


def _dms(dec: float) -> tuple:
    """dec (rad) -> ("[-]d", "m", "s") text, seconds to 1e-9."""
    sign = "-" if dec < 0 else ""
    d = abs(dec) * 180.0 / math.pi
    dd = int(d)
    mm = int((d - dd) * 60.0)
    ss = (d - dd - mm / 60.0) * 3600.0
    return sign + str(dd), str(mm), f"{ss:.9f}"


def _from_text(hms: tuple, dms: tuple) -> tuple:
    """The angles (rad) that the LSM text says."""
    ra = (float(hms[0]) + float(hms[1]) / 60.0
          + float(hms[2]) / 3600.0) * math.pi / 12.0
    neg = dms[0].startswith("-")
    dec = (abs(float(dms[0])) + float(dms[1]) / 60.0
           + float(dms[2]) / 3600.0) * math.pi / 180.0
    return ra, (-dec if neg else dec)


def make_sky(cfg: dict, g, dev, ra0: float, dec0: float, sky_path: str,
             cluster_path: str) -> list:
    """The sky (module doc), drawn from ``g``: writes the LSM and cluster
    files and returns each cluster's sources as plain lists, read back
    from the text."""
    M, S = int(cfg["nclusters"]), int(cfg["sources_per_cluster"])
    ngauss = int(round(cfg["gaussian_share"] * S))
    fov = math.radians(cfg["field_radius_deg"])
    crad = math.radians(cfg["cluster_radius_deg"])

    def disk(n, radius):
        r = radius * torch.sqrt(_uniform(g, n, 0, 1, dev))
        th = _uniform(g, n, 0, 2 * math.pi, dev)
        return r * torch.cos(th), r * torch.sin(th)

    cl, cm = disk(M, fov)
    dl, dm = disk(M * S, crad)
    l = cl.repeat_interleave(S) + dl
    m = cm.repeat_interleave(S) + dm
    lo, hi = cfg["flux_jy"]
    flux = torch.exp(_uniform(g, M * S, math.log(lo), math.log(hi), dev))
    alpha = _uniform(g, M * S, *cfg["spectral_index"], dev)
    elo, ehi = cfg["gaussian_fwhm_arcmin"]
    ex = _uniform(g, M * S, elo, ehi, dev) * math.pi / 10800.0
    ey = ex * _uniform(g, M * S, 0.3, 1.0, dev)
    ep = _uniform(g, M * S, 0.0, math.pi, dev)
    n = torch.sqrt(1.0 - l * l - m * m)
    dec = torch.asin(m * math.cos(dec0) + n * math.sin(dec0))
    ra = ra0 + torch.atan2(l, n * math.cos(dec0) - m * math.sin(dec0))
    cols = [x.cpu().numpy() for x in (ra, dec, flux, alpha, ex, ey, ep)]
    f0 = float(cfg["freq0_hz"])
    clusters, sky_lines, cl_lines = [], [], []
    for k in range(M):
        src = {key: [] for key in ("ra", "dec", "sI", "sQ", "sU", "sV",
                                   "alpha", "f0", "gauss", "eX", "eY",
                                   "eP")}
        names = []
        for s in range(S):
            i = k * S + s
            gauss = s < ngauss
            name = f"{'G' if gauss else 'P'}{k}_{s}"
            hms, dms = _hms(float(cols[0][i])), _dms(float(cols[1][i]))
            sI = f"{float(cols[2][i]):.9g}"
            al = f"{float(cols[3][i]):.9g}"
            ex_, ey_, ep_ = ((f"{float(cols[4][i]):.9g}",
                              f"{float(cols[5][i]):.9g}",
                              f"{float(cols[6][i]):.9g}") if gauss
                             else ("0", "0", "0"))
            sky_lines.append(" ".join([name, *hms, *dms, sI, "0", "0", "0",
                                       al, "0", ex_, ey_, ep_, f"{f0:.9g}"]))
            r, d = _from_text(hms, dms)
            for key, val in (("ra", r), ("dec", d), ("sI", float(sI)),
                             ("sQ", 0.0), ("sU", 0.0), ("sV", 0.0),
                             ("alpha", float(al)), ("f0", f0),
                             ("gauss", gauss), ("eX", float(ex_)),
                             ("eY", float(ey_)), ("eP", float(ep_))):
                src[key].append(val)
            names.append(name)
        clusters.append(src)
        cl_lines.append(f"{k} 1 " + " ".join(names))
    with open(sky_path, "w") as f:
        f.write("## name h m s d m s I Q U V si RM eX eY eP f0\n")
        f.write("\n".join(sky_lines) + "\n")
    with open(cluster_path, "w") as f:
        f.write("\n".join(cl_lines) + "\n")
    return clusters


def write_solutions(path: str, jones: np.ndarray, freq0: float,
                    bandwidth: float, tint_min: float) -> None:
    """Gains (T, K, N, 2, 2) as a SAGECal solutions file: a header, then
    per interval 8N rows of a counter and K columns, station s's rows
    8s..8s+7 = Re, Im of J00, J10, J01, J11."""
    T, K, N = jones.shape[:3]
    with open(path, "w") as f:
        f.write("# freq(MHz) bandwidth(MHz) time_interval(min) stations "
                "clusters effective_clusters\n")
        f.write(f"{freq0 * 1e-6:f} {bandwidth * 1e-6:f} {tint_min:f} "
                f"{N} {K} {K}\n")
        for t in range(T):
            j = jones[t]
            z = np.stack([j[..., 0, 0].real, j[..., 0, 0].imag,
                          j[..., 1, 0].real, j[..., 1, 0].imag,
                          j[..., 0, 1].real, j[..., 0, 1].imag,
                          j[..., 1, 1].real, j[..., 1, 1].imag], axis=-1)
            cols = z.reshape(K, 8 * N).T
            f.write("".join(f"{r} " + " ".join(repr(float(x)) for x in row)
                            + "\n" for r, row in enumerate(cols)))


def read_solutions(path: str, nstations: int) -> np.ndarray:
    """A solutions file's gains, (T, K, N, 2, 2) complex128."""
    rows, header = [], False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if not header:
                header = True
                continue
            rows.append([float(x) for x in line.split()[1:]])
    a = np.asarray(rows, np.float64)
    K, N = a.shape[1], nstations
    a = a.reshape(-1, N, 8, K).transpose(0, 3, 1, 2)
    J = np.empty(a.shape[:3] + (2, 2), np.complex128)
    J[..., 0, 0] = a[..., 0] + 1j * a[..., 1]
    J[..., 1, 0] = a[..., 2] + 1j * a[..., 3]
    J[..., 0, 1] = a[..., 4] + 1j * a[..., 5]
    J[..., 1, 1] = a[..., 6] + 1j * a[..., 7]
    return J


def make_observation(cfg: dict, ntiles: int, seed: int, device,
                     workdir: str) -> Observation:
    """The observation of ``ntiles`` tiles (module doc) on ``device``;
    files under ``workdir``."""
    from sagecal_tpu_torch.io.memh5 import MemFile

    dev = torch.device(device)
    fixed = torch.Generator(device=dev).manual_seed(
        int(cfg["observation_seed"]))
    g = torch.Generator(device=dev).manual_seed(int(seed))
    N, T = int(cfg["nstations"]), int(cfg["tilesz"])
    M = int(cfg["nclusters"])
    ntime = T * ntiles
    ra0 = math.radians(cfg["ra0_deg"])
    dec0 = math.radians(cfg["dec0_deg"])
    lat = math.radians(cfg["latitude_deg"])
    nchan, width = int(cfg["nchan"]), float(cfg["chan_width_hz"])
    freqs = cfg["freq0_hz"] + width * (np.arange(nchan) - (nchan - 1) / 2.0)

    en = station_layout(cfg["layout"], fixed, dev)
    if en.shape[0] != N:
        raise ValueError(f"layout gives {en.shape[0]} stations, not {N}")
    pq = torch.triu_indices(N, N, 1, device=dev)
    ant_p, ant_q = pq[0], pq[1]
    nbase = ant_p.shape[0]
    u, v, w = uvw_track(en, ant_p, ant_q, ntime, cfg["deltat_s"], lat, dec0)

    sky_path = os.path.join(workdir, "sky.txt")
    cluster_path = os.path.join(workdir, "sky.txt.cluster")
    clusters = make_sky(cfg, fixed, dev, ra0, dec0, sky_path, cluster_path)
    eye = torch.eye(2, dtype=torch.complex128, device=dev)
    spread = float(cfg["gain_spread"])
    draw = torch.randn((ntiles, M, N, 2, 2, 2), generator=fixed, device=dev,
                       dtype=torch.float64)
    truth = eye + spread * torch.complex(draw[..., 0],
                                         draw[..., 1]) / math.sqrt(2.0)
    truth_path = os.path.join(workdir, "truth.solutions")
    write_solutions(truth_path, truth.cpu().numpy(), float(np.mean(freqs)),
                    width * nchan, T * cfg["deltat_s"] / 60.0)

    path = os.path.join(workdir, "vis.h5")
    f = MemFile(path, "w")
    for name, arr in (("u", u), ("v", v), ("w", w)):
        f.create_dataset(name, data=arr.reshape(ntime, nbase).cpu().numpy())
    f.create_dataset("ant_p", data=ant_p.cpu().numpy().astype(np.int32))
    f.create_dataset("ant_q", data=ant_q.cpu().numpy().astype(np.int32))
    f.create_dataset("freqs", data=freqs)
    f.create_dataset("flag", shape=(ntime, nbase, nchan), dtype=bool)
    vis = f.create_dataset("vis", shape=(ntime, nbase, nchan, 2, 2),
                           dtype=np.complex64)
    for key, val in (("nstations", N), ("freq0", float(np.mean(freqs))),
                     ("deltaf", width * nchan),
                     ("deltat", float(cfg["deltat_s"])), ("ra0", ra0),
                     ("dec0", dec0), ("time_jd0", 2460000.5)):
        f.attrs[key] = val

    tables = [rime.source_table(c, ra0, dec0, dev) for c in clusters]
    fr = torch.as_tensor(freqs, dtype=torch.float64, device=dev)
    sigma = float(cfg["noise_jy"])
    ap = ant_p.repeat(T)
    aq = ant_q.repeat(T)
    for t in range(ntiles):
        sl = slice(t * T * nbase, (t + 1) * T * nbase)
        coh = rime.tile_coherencies(tables, u[sl] / rime.C_LIGHT,
                                    v[sl] / rime.C_LIGHT,
                                    w[sl] / rime.C_LIGHT, fr, width)
        model = rime.model(coh, truth[t], ap, aq)
        del coh
        nz = torch.randn(model.shape + (2,), generator=g, device=dev,
                         dtype=torch.float64)
        model += sigma * torch.complex(nz[..., 0], nz[..., 1])
        block = model.permute(2, 0, 1).reshape(T, nbase, nchan, 2, 2)
        vis[t * T:(t + 1) * T] = block.to(torch.complex64).cpu().numpy()
        del model, nz, block
    f.close()
    return Observation(
        path=path, sky_path=sky_path, cluster_path=cluster_path,
        truth_path=truth_path, nstations=N, nbase=nbase, ntime=ntime,
        tilesz=T, ntiles=ntiles, freqs=freqs, chan_width=width, ra0=ra0,
        dec0=dec0, u=u.cpu().numpy(), v=v.cpu().numpy(), w=w.cpu().numpy(),
        ant_p=ant_p.cpu().numpy(), ant_q=ant_q.cpu().numpy(),
        clusters=clusters)
