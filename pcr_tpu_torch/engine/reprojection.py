"""
CRS reprojection — host-side f64 point transforms.

The port's copy of pcr_tpu/engine/reprojection.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

The reference declares `target_crs` / `auto_reproject` in PipelineConfig
(pipeline.h:63-65) but ships an EMPTY stub (src/engine/reprojection.cpp:1-11)
and never reads the fields (SURVEY.md §2.3). This build implements the
common conformal projections natively (no PROJ):

  * EPSG:4326  (WGS 84 geographic, lon/lat degrees)
  * EPSG:3857  (Web / spherical Mercator)
  * EPSG:326xx / 327xx (WGS 84 UTM north/south)

UTM uses the 6th-order Krüger series in n (Karney, "Transverse Mercator
with an accuracy of a few nanometers", 2011) — round-trip error is below
1e-9 degrees within a zone's usable extent. Transforms are vectorized
f64 numpy on the host: reprojection is per-point math that composes with
the existing assign pass, so the device path is unchanged. Unsupported
CRS pairs still return a typed NotImplemented status.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.types import CRS, Status, StatusCode

__all__ = ["reproject_points", "supported_epsg"]

# WGS 84 ellipsoid
_A = 6378137.0
_F = 1.0 / 298.257223563
_N = _F / (2.0 - _F)
_E = math.sqrt(_F * (2.0 - _F))          # eccentricity
_K0 = 0.9996
# rectifying radius A = a/(1+n) * (1 + n^2/4 + n^4/64 + n^6/256)
_AR = _A / (1 + _N) * (1 + _N**2 / 4 + _N**4 / 64 + _N**6 / 256)

# Krüger series coefficients (Karney 2011, eqs. 35/36), order n^6
_ALPHA = (
    _N / 2 - 2 * _N**2 / 3 + 5 * _N**3 / 16 + 41 * _N**4 / 180
    - 127 * _N**5 / 288 + 7891 * _N**6 / 37800,
    13 * _N**2 / 48 - 3 * _N**3 / 5 + 557 * _N**4 / 1440
    + 281 * _N**5 / 630 - 1983433 * _N**6 / 1935360,
    61 * _N**3 / 240 - 103 * _N**4 / 140 + 15061 * _N**5 / 26880
    + 167603 * _N**6 / 181440,
    49561 * _N**4 / 161280 - 179 * _N**5 / 168 + 6601661 * _N**6 / 7257600,
    34729 * _N**5 / 80640 - 3418889 * _N**6 / 1995840,
    212378941 * _N**6 / 319334400,
)
_BETA = (
    _N / 2 - 2 * _N**2 / 3 + 37 * _N**3 / 96 - _N**4 / 360
    - 81 * _N**5 / 512 + 96199 * _N**6 / 604800,
    _N**2 / 48 + _N**3 / 15 - 437 * _N**4 / 1440 + 46 * _N**5 / 105
    - 1118711 * _N**6 / 3870720,
    17 * _N**3 / 480 - 37 * _N**4 / 840 - 209 * _N**5 / 4480
    + 5569 * _N**6 / 90720,
    4397 * _N**4 / 161280 - 11 * _N**5 / 504 - 830251 * _N**6 / 7257600,
    4583 * _N**5 / 161280 - 108847 * _N**6 / 3991680,
    20648693 * _N**6 / 638668800,
)


def _utm_params(epsg: int):
    """(lon0_deg, false_northing) for a UTM EPSG, or None."""
    if 32601 <= epsg <= 32660:
        return -183.0 + 6.0 * (epsg - 32600), 0.0
    if 32701 <= epsg <= 32760:
        return -183.0 + 6.0 * (epsg - 32700), 10000000.0
    return None


def _tm_forward(lon_deg, lat_deg, lon0_deg, fn):
    """Geographic (deg) -> transverse Mercator easting/northing (m)."""
    lam = np.radians(lon_deg - lon0_deg)
    phi = np.radians(lat_deg)
    s = np.sin(phi)
    # conformal latitude tau' (Karney eq. 7-9)
    t = np.sinh(np.arctanh(s) - _E * np.arctanh(_E * s))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))
    xi = xi_p.copy()
    eta = eta_p.copy()
    for j, a in enumerate(_ALPHA, start=1):
        xi += a * np.sin(2 * j * xi_p) * np.cosh(2 * j * eta_p)
        eta += a * np.cos(2 * j * xi_p) * np.sinh(2 * j * eta_p)
    x = _K0 * _AR * eta + 500000.0
    y = _K0 * _AR * xi + fn
    return x, y


def _tm_inverse(x, y, lon0_deg, fn):
    """Transverse Mercator easting/northing (m) -> geographic (deg)."""
    xi = (np.asarray(y, np.float64) - fn) / (_K0 * _AR)
    eta = (np.asarray(x, np.float64) - 500000.0) / (_K0 * _AR)
    xi_p = xi.copy()
    eta_p = eta.copy()
    for j, b in enumerate(_BETA, start=1):
        xi_p -= b * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p -= b * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    # conformal tau' -> tau by Newton (Karney eq. 19-21)
    tau_p = np.sin(xi_p) / np.hypot(np.sinh(eta_p), np.cos(xi_p))
    tau = tau_p / math.sqrt(1.0 - _E * _E)      # first guess
    for _ in range(3):
        sig = np.sinh(_E * np.arctanh(_E * tau / np.hypot(1.0, tau)))
        f = tau * np.hypot(1.0, sig) - sig * np.hypot(1.0, tau) - tau_p
        df = ((np.hypot(1.0, sig) * np.hypot(1.0, tau)
               - sig * tau) * (1.0 - _E * _E)
              * np.hypot(1.0, tau) / (1.0 + (1.0 - _E * _E) * tau * tau))
        tau = tau - f / df
    lat = np.degrees(np.arctan(tau))
    lon = lon0_deg + np.degrees(lam)
    return lon, lat


def _merc_forward(lon_deg, lat_deg):
    x = _A * np.radians(lon_deg)
    y = _A * np.log(np.tan(np.pi / 4 + np.radians(lat_deg) / 2))
    return x, y


def _merc_inverse(x, y):
    lon = np.degrees(np.asarray(x, np.float64) / _A)
    lat = np.degrees(2 * np.arctan(np.exp(np.asarray(y, np.float64) / _A))
                     - np.pi / 2)
    return lon, lat


def _to_geographic(x, y, epsg: int):
    """Any supported CRS -> (lon, lat) degrees, or None."""
    if epsg == 4326:
        return np.asarray(x, np.float64), np.asarray(y, np.float64)
    if epsg == 3857:
        return _merc_inverse(x, y)
    utm = _utm_params(epsg)
    if utm is not None:
        return _tm_inverse(x, y, utm[0], utm[1])
    return None


def _from_geographic(lon, lat, epsg: int):
    if epsg == 4326:
        return lon, lat
    if epsg == 3857:
        return _merc_forward(lon, lat)
    utm = _utm_params(epsg)
    if utm is not None:
        return _tm_forward(lon, lat, utm[0], utm[1])
    return None


def supported_epsg(epsg) -> bool:
    return (epsg in (4326, 3857)) or _utm_params(int(epsg or 0)) is not None


def reproject_points(x, y, src: CRS, dst: CRS):
    """Returns (x', y', Status). Identity when the CRSs are equivalent;
    native transform for 4326/3857/UTM pairs; typed NotImplemented for
    anything else (the reference's reprojection.cpp is an empty stub)."""
    if src.equivalent_to(dst):
        return x, y, Status.success()
    se, de = getattr(src, "epsg", None), getattr(dst, "epsg", None)
    if se and de and supported_epsg(se) and supported_epsg(de):
        geo = _to_geographic(x, y, int(se))
        out = _from_geographic(geo[0], geo[1], int(de))
        return out[0], out[1], Status.success()
    return None, None, Status.error(
        StatusCode.NotImplemented,
        f"reprojection {se or src!r} -> {de or dst!r} is not supported "
        "(native transforms cover EPSG:4326, EPSG:3857, and WGS84 UTM "
        "zones); pre-transform coordinates before ingest")
