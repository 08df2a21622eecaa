"""Geodesic helpers (WGS84 Vincenty inverse), obspy-free.

The reference computes station back-azimuths with obspy's
`gps2dist_azimuth` (reference `volpick/data/convert.py:330-340`), which is
the standard Vincenty inverse on the WGS84 ellipsoid. Re-implemented here
from the published algorithm so converters can fill `path_back_azimuth_deg`
without obspy.

A copy of ``volpick_tpu/core/geo.py``.
"""

from __future__ import annotations

import math
from typing import Tuple

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563


def gps2dist_azimuth(
    lat1: float, lon1: float, lat2: float, lon2: float
) -> Tuple[float, float, float]:
    """(distance_m, azimuth 1→2 deg, back-azimuth 2→1 deg), WGS84 Vincenty.

    Matches obspy's gps2dist_azimuth to sub-millimeter / micro-degree for
    non-antipodal points; falls back to a spherical formula if the iteration
    fails to converge (near-antipodal pathologies).
    """
    a, f = _WGS84_A, _WGS84_F
    b = (1.0 - f) * a
    if abs(lat1 - lat2) < 1e-12 and abs(lon1 - lon2) < 1e-12:
        return 0.0, 0.0, 0.0

    u1 = math.atan((1 - f) * math.tan(math.radians(lat1)))
    u2 = math.atan((1 - f) * math.tan(math.radians(lat2)))
    ell = math.radians(lon2 - lon1)

    sin_u1, cos_u1 = math.sin(u1), math.cos(u1)
    sin_u2, cos_u2 = math.sin(u2), math.cos(u2)

    lam = ell
    for _ in range(200):
        sin_lam, cos_lam = math.sin(lam), math.cos(lam)
        sin_sigma = math.sqrt(
            (cos_u2 * sin_lam) ** 2 + (cos_u1 * sin_u2 - sin_u1 * cos_u2 * cos_lam) ** 2
        )
        if sin_sigma == 0:
            return 0.0, 0.0, 0.0
        cos_sigma = sin_u1 * sin_u2 + cos_u1 * cos_u2 * cos_lam
        sigma = math.atan2(sin_sigma, cos_sigma)
        sin_alpha = cos_u1 * cos_u2 * sin_lam / sin_sigma
        cos2_alpha = 1.0 - sin_alpha**2
        if cos2_alpha == 0:  # equatorial line
            cos_2sigma_m = 0.0
        else:
            cos_2sigma_m = cos_sigma - 2.0 * sin_u1 * sin_u2 / cos2_alpha
        c = f / 16.0 * cos2_alpha * (4.0 + f * (4.0 - 3.0 * cos2_alpha))
        lam_prev = lam
        lam = ell + (1.0 - c) * f * sin_alpha * (
            sigma
            + c * sin_sigma * (cos_2sigma_m + c * cos_sigma * (-1.0 + 2.0 * cos_2sigma_m**2))
        )
        if abs(lam - lam_prev) < 1e-12:
            break
    else:  # no convergence: spherical fallback
        return _spherical(lat1, lon1, lat2, lon2)

    u_sq = cos2_alpha * (a**2 - b**2) / b**2
    big_a = 1.0 + u_sq / 16384.0 * (4096.0 + u_sq * (-768.0 + u_sq * (320.0 - 175.0 * u_sq)))
    big_b = u_sq / 1024.0 * (256.0 + u_sq * (-128.0 + u_sq * (74.0 - 47.0 * u_sq)))
    delta_sigma = (
        big_b
        * sin_sigma
        * (
            cos_2sigma_m
            + big_b
            / 4.0
            * (
                cos_sigma * (-1.0 + 2.0 * cos_2sigma_m**2)
                - big_b
                / 6.0
                * cos_2sigma_m
                * (-3.0 + 4.0 * sin_sigma**2)
                * (-3.0 + 4.0 * cos_2sigma_m**2)
            )
        )
    )
    dist = b * big_a * (sigma - delta_sigma)

    az12 = math.degrees(
        math.atan2(cos_u2 * math.sin(lam), cos_u1 * sin_u2 - sin_u1 * cos_u2 * math.cos(lam))
    )
    az21 = math.degrees(
        math.atan2(cos_u1 * math.sin(lam), -sin_u1 * cos_u2 + cos_u1 * sin_u2 * math.cos(lam))
    ) + 180.0
    return dist, az12 % 360.0, az21 % 360.0


def _spherical(lat1, lon1, lat2, lon2) -> Tuple[float, float, float]:
    r = 6371009.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dl = math.radians(lon2 - lon1)
    d = math.acos(
        max(-1.0, min(1.0, math.sin(p1) * math.sin(p2) + math.cos(p1) * math.cos(p2) * math.cos(dl)))
    )
    az12 = math.degrees(
        math.atan2(math.sin(dl) * math.cos(p2),
                   math.cos(p1) * math.sin(p2) - math.sin(p1) * math.cos(p2) * math.cos(dl))
    )
    az21 = math.degrees(
        math.atan2(-math.sin(dl) * math.cos(p1),
                   math.cos(p2) * math.sin(p1) - math.sin(p2) * math.cos(p1) * math.cos(dl))
    )
    return r * d, az12 % 360.0, az21 % 360.0
