"""``buildsky``: extract a sky model + cluster file from a FITS image
(counterpart of ``sagecal_tpu/tools/buildsky.py``; host numpy and scipy,
with the port's native core ``tools/_native.py``).

Redesign of the reference's buildsky tool
(the C SAGECal's ``src/buildsky/`` — island detection ``buildsky.c``,
multi-component LM fitting ``fitpixels.c``/``clmfit_nocuda.c``, model
selection by AIC/BIC/MDL ``main.c`` -a flag, weighted k-means sky
clustering ``scluster.c:675-941`` on the embedded C Clustering
Library): threshold the image against a robust noise estimate, label
islands (native 8-connected flood fill, ``native/clusterlib.cpp``),
fit 1..maxP elliptical-Gaussian components per island with
``scipy.optimize.least_squares``, pick the order by an information
criterion, and emit the LSM sky file plus a k-means cluster file.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import List, Tuple

import numpy as np

from sagecal_tpu_torch.io.fits import read_fits_image
from sagecal_tpu_torch.tools._native import kmeans_weighted, label_islands

_SIGMA_TO_FWHM = 2.0 * math.sqrt(2.0 * math.log(2.0))


def robust_noise(img: np.ndarray) -> float:
    """MAD-based noise sigma (buildsky's background estimate role)."""
    med = np.median(img)
    return 1.4826 * float(np.median(np.abs(img - med))) + 1e-30


def _gauss_model(params, px, py, ncomp):
    out = np.zeros_like(px, float)
    for c in range(ncomp):
        amp, x0, y0, sx, sy, pa = params[6 * c:6 * c + 6]
        ct, st = math.cos(pa), math.sin(pa)
        dx = px - x0
        dy = py - y0
        u = ct * dx + st * dy
        v = -st * dx + ct * dy
        out = out + amp * np.exp(
            -0.5 * ((u / max(abs(sx), 0.3)) ** 2
                    + (v / max(abs(sy), 0.3)) ** 2)
        )
    return out


def fit_island(
    px: np.ndarray, py: np.ndarray, flux: np.ndarray, maxP: int,
    criterion: str = "aic",
) -> Tuple[np.ndarray, int]:
    """Fit 1..maxP Gaussian components; return (params, ncomp) chosen by
    the information criterion (main.c -a: aic/bic/mdl/gtr)."""
    from scipy.optimize import least_squares

    n = flux.size
    best = None
    for ncomp in range(1, max(1, maxP) + 1):
        if 6 * ncomp >= n:
            break
        # init: brightest remaining pixels
        order = np.argsort(flux)[::-1]
        p0 = []
        for c in range(ncomp):
            i = order[min(c * max(1, n // ncomp // 2), n - 1)]
            p0 += [flux[i], px[i], py[i], 1.5, 1.5, 0.0]

        def resid(p):
            return _gauss_model(p, px, py, ncomp) - flux

        sol = least_squares(resid, np.asarray(p0), method="lm",
                            max_nfev=400 * ncomp)
        rss = float(np.sum(sol.fun ** 2)) + 1e-30
        k = 6 * ncomp
        if criterion == "bic":
            score = n * math.log(rss / n) + k * math.log(n)
        elif criterion == "mdl":
            score = 0.5 * n * math.log(rss / n) + 0.5 * k * math.log(n)
        else:  # aic (default) / gtr approximated by aic
            score = n * math.log(rss / n) + 2.0 * k
        if best is None or score < best[0]:
            best = (score, sol.x, ncomp)
    if best is None:
        # degenerate tiny island: single point at the peak
        i = int(np.argmax(flux))
        return np.asarray([flux[i], px[i], py[i], 0.5, 0.5, 0.0]), 1
    return best[1], best[2]


def _rad_to_hms(ra: float):
    h = ra * 12.0 / math.pi
    h = h % 24.0
    hh = int(h)
    mm = int((h - hh) * 60)
    ss = ((h - hh) * 60 - mm) * 60
    return hh, mm, ss


def _rad_to_dms(dec: float):
    s = -1 if dec < 0 else 1
    d = abs(dec) * 180.0 / math.pi
    dd = int(d)
    mm = int((d - dd) * 60)
    ss = ((d - dd) * 60 - mm) * 60
    return s * dd, mm, ss



def _name_sources(sources: List[dict]) -> None:
    """P = point, G = gaussian (the LSM type-from-name convention)."""
    for i, s in enumerate(sources):
        s["name"] = f"{'P' if s['point'] else 'G'}{s['island']}C{i}"


def hierarchical_cluster(l, m, ncut: int) -> np.ndarray:
    """Agglomerative centroid-linkage clustering of (l, m) positions,
    cut at ``ncut`` clusters — the reference's negative ``-k`` path
    (``hierarchical_clustering``, scluster.c:709-740: ``treecluster``
    with Euclidean metric + pairwise centroid linkage, then
    ``cuttree``).  scipy's linkage/fcluster replaces the embedded C
    Clustering Library.  Returns 0-based int assignments."""
    from scipy.cluster.hierarchy import fcluster, linkage

    pts = np.stack([np.asarray(l, float), np.asarray(m, float)], axis=1)
    n = len(pts)
    ncut = max(1, min(ncut, n))
    if n == 1:
        return np.zeros(1, np.int64)
    Z = linkage(pts, method="centroid", metric="euclidean")
    return np.asarray(fcluster(Z, t=ncut, criterion="maxclust")) - 1


def _write_cluster_file(sources: List[dict], out_cluster: str,
                        nclusters: int) -> None:
    """Cluster file: ``nclusters`` > 0 -> weighted k-means;
    < 0 -> hierarchical centroid-linkage cut at ``|nclusters|``
    (the reference's -k sign convention, buildsky main.c:43);
    0 -> one cluster per source."""
    assign = None
    if nclusters < 0 and len(sources) > 1:
        assign = hierarchical_cluster(
            [s["l"] for s in sources], [s["m"] for s in sources],
            min(-nclusters, len(sources)),
        )
    elif nclusters and len(sources) > 1:
        assign, _ = kmeans_weighted(
            [s["l"] for s in sources], [s["m"] for s in sources],
            [abs(s["flux"]) for s in sources],
            min(nclusters, len(sources)),
        )
    with open(out_cluster, "w") as fh:
        fh.write("# cluster_id hybrid source_names...\n")
        if assign is not None and len(assign):
            for cid in range(int(assign.max()) + 1):
                names = [s["name"] for s, a in zip(sources, assign)
                         if a == cid]
                if names:
                    fh.write(f"{cid + 1} 1 {' '.join(names)}\n")
        else:
            for i, s in enumerate(sources):
                fh.write(f"{i + 1} 1 {s['name']}\n")


def buildsky(
    fits_path: str,
    out_sky: str,
    out_cluster: str = None,
    threshold_sigma: float = 5.0,
    maxP: int = 3,
    nclusters: int = 0,
    criterion: str = "aic",
    min_pixels: int = 4,
    freq0: float = None,
    out_regions: str = None,
    log=print,
) -> List[dict]:
    """Extract sources; write the LSM sky + cluster files.

    ``nclusters``: 0 = one cluster per source (the reference's
    create_clusters default), > 0 = weighted k-means into that many
    clusters, < 0 = hierarchical centroid-linkage cut at ``|nclusters|``
    (the reference's -k sign convention, scluster.c / main.c:43).
    Returns the source dicts.
    """
    img, wcs, hdr = read_fits_image(fits_path)
    if freq0 is None:
        freq0 = hdr.get("CRVAL3", 150e6) or 150e6
    sigma = robust_noise(img)
    mask = img > threshold_sigma * sigma
    labels, nisl = label_islands(mask)
    log(f"buildsky: noise {sigma:.3e}, {nisl} islands above "
        f"{threshold_sigma} sigma")
    ny, nx = img.shape
    pixscale = abs(wcs.cdelt1) * math.pi / 180.0  # rad/pixel

    sources = []
    hulls = []
    for isl in range(1, nisl + 1):
        ys, xs = np.nonzero(labels == isl)
        if ys.size < min_pixels:
            continue
        hulls.append((isl, convex_hull(np.stack([xs, ys], axis=1))))
        flux = img[ys, xs]
        params, ncomp = fit_island(
            xs.astype(float), ys.astype(float), flux, maxP, criterion
        )
        for c in range(ncomp):
            amp, x0, y0, sx, sy, pa = params[6 * c:6 * c + 6]
            if amp <= 0:
                continue
            ra, dec = wcs.pixel_to_radec(x0, y0)
            l, m = wcs.pixel_to_lm(x0, y0)
            # point if the fitted extent is ~1 pixel
            is_point = max(abs(sx), abs(sy)) < 1.0
            sources.append(dict(
                ra=float(ra), dec=float(dec), l=float(l), m=float(m),
                flux=float(amp), island=isl,
                eX=0.0 if is_point else abs(sx) * pixscale * _SIGMA_TO_FWHM,
                eY=0.0 if is_point else abs(sy) * pixscale * _SIGMA_TO_FWHM,
                eP=0.0 if is_point else float(pa),
                point=is_point,
            ))
    _name_sources(sources)

    with open(out_sky, "w") as fh:
        fh.write("# name h m s d m s I Q U V spectral_index RM extent_X(rad)"
                 " extent_Y(rad) pos_angle(rad) freq0\n")
        fh.write("# generated by sagecal-tpu buildsky\n")
        for s in sources:
            hh, hm, hs = _rad_to_hms(s["ra"])
            dd, dm, ds2 = _rad_to_dms(s["dec"])
            fh.write(
                f"{s['name']} {hh} {hm} {hs:.3f} {dd} {dm} {ds2:.3f} "
                f"{s['flux']:.6f} 0 0 0 0 0 {s['eX']:.6e} {s['eY']:.6e} "
                f"{s['eP']:.6e} {freq0:.1f}\n"
            )

    out_cluster = out_cluster or out_sky + ".cluster"
    _write_cluster_file(sources, out_cluster, nclusters)
    if out_regions:
        write_ds9_regions(out_regions, sources, hulls, wcs)
    log(f"buildsky: {len(sources)} sources -> {out_sky}, {out_cluster}")
    return sources




def convex_hull(points: np.ndarray) -> np.ndarray:
    """Convex hull (Andrew monotone chain) of (N, 2) points -> hull
    vertices in counter-clockwise order.  The role of the reference's
    island boundary hulls (``hull.c:1-521``) without the embedded
    incremental C implementation."""
    pts = np.unique(np.asarray(points, float), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(seq):
        h = []
        for q in seq:
            while len(h) >= 2 and cross2(h[-2], h[-1], q) <= 0:
                h.pop()
            h.append(q)
        return h

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def write_ds9_regions(path: str, sources: List[dict], hulls, wcs) -> None:
    """DS9 region file: one point/ellipse per fitted source plus the
    convex-hull polygon of each island (the reference emits DS9 region
    output alongside the sky model, ``hull.c`` + buildsky README)."""
    deg = 180.0 / math.pi
    with open(path, "w") as fh:
        fh.write("# Region file format: DS9 (sagecal-tpu buildsky)\n")
        fh.write("global color=green\nfk5\n")
        for s in sources:
            ra, dec = s["ra"] * deg, s["dec"] * deg
            if s.get("point", True):
                fh.write(f'point({ra:.6f},{dec:.6f}) # point=cross '
                         f'text={{{s["name"]}}}\n')
            else:
                fh.write(
                    f'ellipse({ra:.6f},{dec:.6f},'
                    f'{s["eX"] * deg:.6f},{s["eY"] * deg:.6f},'
                    f'{s["eP"] * deg:.2f}) # text={{{s["name"]}}}\n'
                )
        for isl, hull in hulls:
            if len(hull) < 3:
                continue
            coords = []
            for (x, y) in hull:
                ra, dec = wcs.pixel_to_radec(float(x), float(y))
                coords += [f"{ra * deg:.6f}", f"{dec * deg:.6f}"]
            fh.write(f'polygon({",".join(coords)}) # color=yellow '
                     f'text={{island {isl}}}\n')


def fit_spectral_index(amps: np.ndarray, freqs: np.ndarray,
                       ref_freq: float, max_order: int = 3):
    """Log-polynomial spectrum fit: ln I(f) = ln I0 + si1 r + si2 r^2 +
    si3 r^3 with r = ln(f/ref_freq) — the reference's multi-frequency
    flux model (``fitmultipixels.c:441-447`` ``exp(log(p0) + p1 r +
    p2 r^2 + p3 r^3)``), fitted by least squares on the per-channel
    matched-filter amplitudes instead of the reference's nonlinear LM
    over raw pixels.  Returns (I0, [si1, si2, si3]) with the order
    clamped to the available channel count."""
    good = amps > 0
    if good.sum() < 2:
        I0 = float(amps[good][0]) if good.any() else float(np.max(amps))
        return I0, [0.0, 0.0, 0.0]
    r = np.log(freqs[good] / ref_freq)
    order = int(min(max_order, good.sum() - 1))
    A = np.vander(r, order + 1, increasing=True)  # 1, r, r^2, ...
    coef, *_ = np.linalg.lstsq(A, np.log(amps[good]), rcond=None)
    si = [0.0, 0.0, 0.0]
    for k in range(1, order + 1):
        si[k - 1] = float(coef[k])
    return float(math.exp(coef[0])), si


def buildmultisky(
    fits_paths: List[str],
    out_sky: str,
    out_cluster: str = None,
    out_regions: str = None,
    threshold_sigma: float = 5.0,
    maxP: int = 3,
    nclusters: int = 0,
    criterion: str = "aic",
    min_pixels: int = 4,
    log=print,
) -> List[dict]:
    """Multi-frequency source extraction with spectral-index fitting
    (the ``buildmultisky`` tool, ``buildmultisky.c:1-1899`` +
    ``fitmultipixels.c``): detect islands on the channel-mean image,
    fit the spatial shape there, recover each component's per-channel
    amplitude by matched filtering, fit the 3-term log-polynomial
    spectrum, and emit a 19-token (three-term-spectra, ``-F 1``) sky
    file, cluster file, and DS9 regions."""
    imgs, freqs = [], []
    wcs = None
    for path in fits_paths:
        img, w, hdr = read_fits_image(path)
        imgs.append(img)
        f = float(hdr.get("CRVAL3", 0.0))
        if f <= 0.0:
            raise ValueError(
                f"{path}: no CRVAL3 frequency in header — every channel "
                "image needs its frequency for the spectral fit"
            )
        freqs.append(f)
        wcs = wcs or w
    if len(set(freqs)) < len(freqs):
        raise ValueError(
            f"duplicate channel frequencies {sorted(freqs)} — the "
            "spectral-index fit is degenerate"
        )
    order = np.argsort(freqs)
    freqs = np.asarray(freqs)[order]
    imgs = [imgs[i] for i in order]
    cube = np.stack(imgs)  # (Nf, ny, nx)
    ref_freq = float(np.mean(freqs))
    mean_img = cube.mean(axis=0)

    sigma = robust_noise(mean_img)
    mask = mean_img > threshold_sigma * sigma
    labels, nisl = label_islands(mask)
    log(f"buildmultisky: {len(freqs)} channels "
        f"[{freqs[0]/1e6:.1f}..{freqs[-1]/1e6:.1f} MHz], noise "
        f"{sigma:.3e}, {nisl} islands")
    pixscale = abs(wcs.cdelt1) * math.pi / 180.0

    sources, hulls = [], []
    for isl in range(1, nisl + 1):
        ys, xs = np.nonzero(labels == isl)
        if ys.size < min_pixels:
            continue
        hulls.append((isl, convex_hull(np.stack([xs, ys], axis=1))))
        flux = mean_img[ys, xs]
        params, ncomp = fit_island(
            xs.astype(float), ys.astype(float), flux, maxP, criterion
        )
        for c in range(ncomp):
            amp, x0, y0, sx, sy, pa = params[6 * c:6 * c + 6]
            if amp <= 0:
                continue
            # matched-filter amplitude per channel with the mean-image
            # shape held fixed: amp_f = <img_f, g>/<g, g>
            g = _gauss_model(
                np.asarray([1.0, x0, y0, sx, sy, pa]),
                xs.astype(float), ys.astype(float), 1,
            )
            gg = float(np.dot(g, g)) + 1e-30
            amps_f = np.asarray(
                [float(np.dot(cube[f][ys, xs], g)) / gg
                 for f in range(len(freqs))]
            )
            I0, si = fit_spectral_index(amps_f, freqs, ref_freq)
            ra, dec = wcs.pixel_to_radec(x0, y0)
            l, m = wcs.pixel_to_lm(x0, y0)
            is_point = max(abs(sx), abs(sy)) < 1.0
            sources.append(dict(
                ra=float(ra), dec=float(dec), l=float(l), m=float(m),
                flux=float(I0), si=si, island=isl,
                eX=0.0 if is_point else abs(sx) * pixscale * _SIGMA_TO_FWHM,
                eY=0.0 if is_point else abs(sy) * pixscale * _SIGMA_TO_FWHM,
                eP=0.0 if is_point else float(pa),
                point=is_point,
            ))
    _name_sources(sources)

    with open(out_sky, "w") as fh:
        fh.write("# name h m s d m s I Q U V si0 si1 si2 RM eX eY eP f0\n")
        fh.write("# generated by sagecal-tpu buildmultisky (-F 1 format)\n")
        for s in sources:
            hh, hm, hs = _rad_to_hms(s["ra"])
            dd, dm, ds2 = _rad_to_dms(s["dec"])
            si = s["si"]
            fh.write(
                f"{s['name']} {hh} {hm} {hs:.3f} {dd} {dm} {ds2:.3f} "
                f"{s['flux']:.6f} 0 0 0 {si[0]:.6f} {si[1]:.6f} "
                f"{si[2]:.6f} 0 {s['eX']:.6e} {s['eY']:.6e} "
                f"{s['eP']:.6e} {ref_freq:.1f}\n"
            )

    out_cluster = out_cluster or out_sky + ".cluster"
    _write_cluster_file(sources, out_cluster, nclusters)
    if out_regions:
        write_ds9_regions(out_regions, sources, hulls, wcs)
    log(f"buildmultisky: {len(sources)} sources -> {out_sky}")
    return sources


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m sagecal_tpu_torch.tools.buildsky",
        description="FITS image -> LSM sky model + cluster file "
        "(reference src/buildsky)",
    )
    ap.add_argument("-f", "--fits", required=True)
    ap.add_argument("-o", "--out", default=None,
                    help="output sky file (default <fits>.sky.txt)")
    ap.add_argument("-s", "--sigma", type=float, default=5.0,
                    help="detection threshold in noise sigmas")
    ap.add_argument("-m", "--maxfit", type=int, default=3,
                    help="max Gaussian components per island (ref -m)")
    ap.add_argument("-a", "--criterion", default="aic",
                    choices=("aic", "bic", "mdl"),
                    help="model-order criterion (ref -a)")
    ap.add_argument("-Q", "--nclusters", type=int, default=0,
                    help="cluster count: >0 weighted k-means, <0 "
                    "hierarchical centroid-linkage cut at |Q| (ref -k "
                    "sign convention), 0 = one per source")
    ap.add_argument("--multi", nargs="+", default=None, metavar="FITS",
                    help="additional per-frequency FITS images: fit "
                    "spectral indices across all of them "
                    "(buildmultisky.c role)")
    ap.add_argument("--regions", default=None,
                    help="write a DS9 region file (hull.c role)")
    args = ap.parse_args(argv)
    out = args.out or args.fits + ".sky.txt"
    if args.multi:
        buildmultisky([args.fits] + list(args.multi), out,
                      out_regions=args.regions,
                      threshold_sigma=args.sigma, maxP=args.maxfit,
                      nclusters=args.nclusters, criterion=args.criterion)
        return 0
    buildsky(args.fits, out, threshold_sigma=args.sigma,
             maxP=args.maxfit, nclusters=args.nclusters,
             criterion=args.criterion, out_regions=args.regions)
    return 0


if __name__ == "__main__":
    sys.exit(main())
