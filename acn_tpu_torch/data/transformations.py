"""Geodetic and basis transformations (self-contained WGS84 — no pymap3d).

The port's own copy of ``acn_tpu/data/transformations.py`` (numpy only).

Counterpart of the reference's ``data/transformations.py``. Conventions:

* COLMAP camera basis is RDF (Right, Down, Forward);
* target world basis is DRB (Down, Right, Back);
* stored camera rotations are RUB→DRB (see scripts/prepare_dataset).

The geodetic↔ECEF↔ENU math is the textbook WGS84 formulation (the reference
delegates it to pymap3d, which is absent here).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Basis transforms (reference transformations.py:8-28)
RDF_TO_DRB = np.array(
    [
        [0.0, 1.0, 0.0],  # Down  <- RDF_y
        [1.0, 0.0, 0.0],  # Right <- RDF_x
        [0.0, 0.0, -1.0],  # Back  <- -RDF_z
    ],
    dtype=np.float64,
)

ENU_TO_DRB = np.array(
    [
        [0.0, 0.0, -1.0],  # Down  <- -Up
        [1.0, 0.0, 0.0],  # Right <- East
        [0.0, -1.0, 0.0],  # Back  <- -North
    ],
    dtype=np.float64,
)

RDF_TO_RUB = np.diag([1.0, -1.0, -1.0]).astype(np.float64)

# WGS84 ellipsoid
WGS84_A = 6378137.0
WGS84_B = 6356752.314245179
WGS84_E2 = 1.0 - (WGS84_B**2) / (WGS84_A**2)  # first eccentricity squared


def geodetic_to_ecef(lat_deg, lon_deg, alt_m) -> Tuple[np.ndarray, ...]:
    """(lat°, lon°, h m) → ECEF (x, y, z) meters. Vectorized."""
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    h = np.asarray(alt_m, np.float64)
    sB, cB = np.sin(lat), np.cos(lat)
    N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sB**2)  # prime vertical radius
    x = (N + h) * cB * np.cos(lon)
    y = (N + h) * cB * np.sin(lon)
    z = (N * (1.0 - WGS84_E2) + h) * sB
    return x, y, z


def ecef_to_geodetic(x, y, z) -> Tuple[np.ndarray, ...]:
    """ECEF → geodetic via Bowring's method (one iteration of the reduced
    latitude; sub-mm accurate for terrestrial points)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    # Bowring
    ep2 = (WGS84_A**2 - WGS84_B**2) / WGS84_B**2
    theta = np.arctan2(z * WGS84_A, p * WGS84_B)
    st, ct = np.sin(theta), np.cos(theta)
    lat = np.arctan2(z + ep2 * WGS84_B * st**3, p - WGS84_E2 * WGS84_A * ct**3)
    sB = np.sin(lat)
    N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sB**2)
    alt = p / np.cos(lat) - N
    return np.rad2deg(lat), np.rad2deg(lon), alt


def ecef_to_enu_rot(lat_deg: float, lon_deg: float) -> np.ndarray:
    """Rotation mapping ECEF vectors to ENU components at (lat, lon)
    (reference transformations.py:112-127). v_enu = Q @ v_ecef."""
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    sL, cL = np.sin(lon), np.cos(lon)
    sB, cB = np.sin(lat), np.cos(lat)
    return np.array(
        [
            [-sL, cL, 0.0],  # East
            [-sB * cL, -sB * sL, cB],  # North
            [cB * cL, cB * sL, sB],  # Up
        ],
        dtype=np.float64,
    )


def ecef_to_enu(x, y, z, lat0, lon0, h0) -> Tuple[np.ndarray, ...]:
    """ECEF → local ENU around a geodetic origin."""
    x0, y0, z0 = geodetic_to_ecef(lat0, lon0, h0)
    Q = ecef_to_enu_rot(lat0, lon0)
    d = np.stack(
        [np.asarray(x) - x0, np.asarray(y) - y0, np.asarray(z) - z0], axis=-1
    )
    enu = d @ Q.T
    return enu[..., 0], enu[..., 1], enu[..., 2]


def enu_to_ecef(e, n, u, lat0, lon0, h0) -> Tuple[np.ndarray, ...]:
    x0, y0, z0 = geodetic_to_ecef(lat0, lon0, h0)
    Q = ecef_to_enu_rot(lat0, lon0)
    d = np.stack([np.asarray(e), np.asarray(n), np.asarray(u)], axis=-1) @ Q
    return d[..., 0] + x0, d[..., 1] + y0, d[..., 2] + z0


def geodetic_to_enu(lat, lon, h, lat0, lon0, h0) -> Tuple[np.ndarray, ...]:
    return ecef_to_enu(*geodetic_to_ecef(lat, lon, h), lat0, lon0, h0)


def enu_to_geodetic(e, n, u, lat0, lon0, h0) -> Tuple[np.ndarray, ...]:
    return ecef_to_geodetic(*enu_to_ecef(e, n, u, lat0, lon0, h0))


def enu_span_meters(lat_min, lat_max, lon_min, lon_max, lat_ref, lon_ref, h_ref):
    """N/E span in meters of a lat/lon box around a reference ENU origin
    (reference transformations.py:38-69)."""
    _, n1, _ = geodetic_to_enu(lat_min, lon_ref, h_ref, lat_ref, lon_ref, h_ref)
    _, n2, _ = geodetic_to_enu(lat_max, lon_ref, h_ref, lat_ref, lon_ref, h_ref)
    e1, _, _ = geodetic_to_enu(lat_ref, lon_min, h_ref, lat_ref, lon_ref, h_ref)
    e2, _, _ = geodetic_to_enu(lat_ref, lon_max, h_ref, lat_ref, lon_ref, h_ref)
    return abs(float(n2) - float(n1)), abs(float(e2) - float(e1))


def choose_enu_origin(policy: str, lats, lons, alts, ordered_indices, hparams):
    """ENU origin policies: first / mean / median / custom
    (reference transformations.py:72-109)."""
    policy = policy.lower()
    if policy == "first":
        idx0 = ordered_indices[0]
        return float(lats[idx0]), float(lons[idx0]), float(alts[idx0]), (
            "first camera (id-sorted)"
        )
    if policy == "mean":
        return float(np.mean(lats)), float(np.mean(lons)), float(np.mean(alts)), (
            "mean of all cameras"
        )
    if policy == "median":
        return (
            float(np.median(lats)),
            float(np.median(lons)),
            float(np.median(alts)),
            "median of all cameras",
        )
    if policy == "custom":
        if None in (hparams.enu_ref_lat, hparams.enu_ref_lon, hparams.enu_ref_alt):
            raise ValueError(
                "--enu_ref=custom requires --enu_ref_lat, --enu_ref_lon, --enu_ref_alt"
            )
        return (
            float(hparams.enu_ref_lat),
            float(hparams.enu_ref_lon),
            float(hparams.enu_ref_alt),
            "custom user-provided coordinates",
        )
    raise ValueError(f"Unknown --enu_ref: {policy}")


def is_likely_ecef(C: np.ndarray) -> bool:
    """Earth-centered heuristic (reference transformations.py:130-133)."""
    r = np.linalg.norm(C, axis=1)
    return bool(r.mean() > 1e6 and r.std() < 5e5)
