"""Coordinate and time transforms: ITRF, az/el, GMST, precession
(counterpart of ``sagecal_tpu/ops/transforms.py``, copied).

The reference's ``transforms.c`` formulas (NOVAS- and Vallado-derived)
as vectorized numpy in float64.  They run on the host during setup
(beam pointing, source precession), once per tile, as in the JAX
package; the beam path turns their output into tensors.
"""

from __future__ import annotations

import numpy as np

ASEC2RAD = 4.848136811095359935899141e-6  # arcsec -> rad (NOVAS constant)


def xyz2llh(x, y, z):
    """ITRF2000 (m) -> (longitude, latitude [rad], height [m]).

    WGS84 ellipsoid, single-iteration Bowring approximation
    (transforms.c:35-88).
    """
    a = 6378137.0
    f = 1.0 / 298.257223563
    b = (1.0 - f) * a
    e2 = 2 * f - f * f
    ep2 = (a * a - b * b) / (b * b)
    p = np.sqrt(x * x + y * y)
    lon = np.arctan2(y, x)
    theta = np.arctan(z * a / (p * b))
    st, ct = np.sin(theta), np.cos(theta)
    lat = np.arctan((z + ep2 * b * st**3) / (p - e2 * a * ct**3))
    sl, cl = np.sin(lat), np.cos(lat)
    r = a / np.sqrt(1.0 - e2 * sl * sl)
    h = p / cl - r
    return lon, lat, h


def jd2gmst(time_jd):
    """JD (days) -> Greenwich Mean Sidereal Time angle (degrees)
    (transforms.c:138-147, Vallado eq; Horner form)."""
    t = (np.asarray(time_jd) - 2451545.0) / 36525.0
    theta = 67310.54841 + t * (
        (876600.0 * 3600.0 + 8640184.812866) + t * (0.093104 - (6.2e-5) * t)
    )
    # reference: fmod(theta, 86400*sign(theta))/240 then fmod 360
    theta = np.fmod(theta, 86400.0 * np.sign(theta)) / 240.0
    return np.fmod(theta, 360.0)


def radec2azel_gmst(ra, dec, longitude, latitude, thetaGMST):
    """(ra, dec) [rad] -> (az, el) [rad] given GMST angle in degrees
    (transforms.c:156-180).  Vectorized over any broadcastable shapes."""
    thetaLST = thetaGMST + np.degrees(longitude)
    LHA = np.fmod(thetaLST - np.degrees(ra), 360.0)
    sl, cl = np.sin(latitude), np.cos(latitude)
    sd, cd = np.sin(dec), np.cos(dec)
    sh, ch = np.sin(np.radians(LHA)), np.cos(np.radians(LHA))
    tmp = sl * sd + cl * cd * ch
    el = np.arcsin(tmp)
    se, ce = np.sin(el), np.cos(el)
    az = np.fmod(np.arctan2(-sh * cd / ce, (sd - se * sl) / (ce * cl)), 2.0 * np.pi)
    az = np.where(az < 0, az + 2.0 * np.pi, az)
    return az, el


def radec2azel(ra, dec, longitude, latitude, time_jd):
    """(ra, dec) [rad] at JD -> (az, el) [rad] (transforms.c:100-130)."""
    return radec2azel_gmst(ra, dec, longitude, latitude, jd2gmst(time_jd))


def get_precession_params(jd_tdb2):
    """Precession rotation matrix J2000 -> epoch jd_tdb2: (3, 3).

    Capitaine et al. (2003) 4-angle formulation
    (transforms.c:186-266; column-major Tr in the reference — here a
    standard row-major matrix, applied as Tr @ pos).
    """
    eps0 = 84381.406
    t = (jd_tdb2 - 2451545.0) / 36525.0
    psia = ((((-0.0000000951 * t + 0.000132851) * t - 0.00114045) * t - 1.0790069) * t
            + 5038.481507) * t
    omegaa = ((((0.0000003337 * t - 0.000000467) * t - 0.00772503) * t + 0.0512623) * t
              - 0.025754) * t + eps0
    chia = ((((-0.0000000560 * t + 0.000170663) * t - 0.00121197) * t - 2.3814292) * t
            + 10.556403) * t
    eps0 = eps0 * ASEC2RAD
    psia = psia * ASEC2RAD
    omegaa = omegaa * ASEC2RAD
    chia = chia * ASEC2RAD
    sa, ca = np.sin(eps0), np.cos(eps0)
    sb, cb = np.sin(-psia), np.cos(-psia)
    sc, cc = np.sin(-omegaa), np.cos(-omegaa)
    sd, cd = np.sin(chia), np.cos(chia)
    # R3(chi) R1(-omega) R3(-psi) R1(eps0); rows match transforms.c Tr
    # layout read column-major (Tr[0],Tr[3],Tr[6] = first row).
    return np.array(
        [
            [cd * cb - sb * sd * cc,
             cd * sb * ca + sd * cc * cb * ca - sa * sd * sc,
             cd * sb * sa + sd * cc * cb * sa + ca * sd * sc],
            [-sd * cb - sb * cd * cc,
             -sd * sb * ca + cd * cc * cb * ca - sa * cd * sc,
             -sd * sb * sa + cd * cc * cb * sa + ca * cd * sc],
            [sb * sc,
             -sc * cb * ca - sa * cc,
             -sc * cb * sa + cc * ca],
        ]
    )


def precess_radec(ra0, dec0, Tr):
    """Precess J2000 (ra0, dec0) [rad] by matrix Tr (transforms.c:268-291).

    NOTE the reference's unconventional spherical convention: position
    vector (cos(ra) sin(dec), sin(ra) sin(dec), cos(dec)) — dec measured
    from the pole — and dec from arctan(rho/z); reproduced verbatim so
    precessed sky models match the reference's byte-for-byte.
    """
    ra0 = np.asarray(ra0)
    dec0 = np.asarray(dec0)
    pos1 = np.stack(
        [np.cos(ra0) * np.sin(dec0), np.sin(ra0) * np.sin(dec0),
         np.broadcast_to(np.cos(dec0), ra0.shape)], axis=-1
    )
    pos2 = pos1 @ np.asarray(Tr).T
    ra = np.arctan2(pos2[..., 1], pos2[..., 0])
    dec = np.arctan(
        np.sqrt(pos2[..., 0] ** 2 + pos2[..., 1] ** 2) / pos2[..., 2]
    )
    return ra, dec


def radec_to_lmn(ra, dec, ra0, dec0):
    """Direction cosines (l, m, n-1) of (ra, dec) about phase center
    (ra0, dec0) — the conversion at readsky.c:343-346."""
    sd, cd = np.sin(dec), np.cos(dec)
    sd0, cd0 = np.sin(dec0), np.cos(dec0)
    dra = ra - ra0
    l = cd * np.sin(dra)
    m = sd * cd0 - cd * sd0 * np.cos(dra)
    n = sd * sd0 + cd * cd0 * np.cos(dra)
    return l, m, n - 1.0


def lmn_to_radec(ll, mm, ra0, dec0):
    """Inverse of :func:`radec_to_lmn`: sky coordinates of direction
    cosines (l, m) about phase center (ra0, dec0).  Needed by the
    beam-aware predict path, which evaluates az/el per source from
    (ra, dec) while the source batches carry only lmn."""
    ll = np.asarray(ll)
    mm = np.asarray(mm)
    n = np.sqrt(np.maximum(1.0 - ll * ll - mm * mm, 0.0))
    sd0, cd0 = np.sin(dec0), np.cos(dec0)
    dec = np.arcsin(np.clip(mm * cd0 + n * sd0, -1.0, 1.0))
    ra = ra0 + np.arctan2(ll, n * cd0 - mm * sd0)
    return ra, dec


def precess_radec_equatorial(ra, dec, Tr):
    """Precess J2000 (ra, dec) [rad] with the STANDARD equatorial
    spherical convention — the application path's source/pointing
    precession (``Data::precess_source_locations``,
    src/MS/data.cpp:1616-1645, casacore IAU2000).  The casacore
    version composes precession with nutation; the nutation term
    (<= ~9 arcsec) is omitted here, small against the ~20 arcmin/26 yr
    precession it corrects.  Contrast :func:`precess_radec`, which
    reproduces transforms.c:268's pole-referenced convention
    byte-for-byte for the sky-model path."""
    ra = np.asarray(ra, np.float64)
    dec = np.asarray(dec, np.float64)
    pos = np.stack(
        [np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
         np.broadcast_to(np.sin(dec), np.shape(ra))], axis=-1
    )
    p2 = pos @ np.asarray(Tr).T
    ra2 = np.arctan2(p2[..., 1], p2[..., 0])
    dec2 = np.arcsin(np.clip(p2[..., 2], -1.0, 1.0))
    return ra2, dec2
