"""Host-side vector math (numpy float32) for scene builders.

Spherical conventions follow the reference (ref: icon_rt/ICONGrid.h:36-54):
spherical = (r, lat, lon) with lat = asin(z/r), lon = atan2(y, x).
"""
from __future__ import annotations

import numpy as np


def np_to_cartesian(s):
    """Spherical (..., 3) = (r, lat, lon) -> Cartesian (..., 3), float32."""
    s = np.asarray(s, np.float32)
    r, lat, lon = s[..., 0], s[..., 1], s[..., 2]
    cl = np.cos(lat, dtype=np.float32)
    out = np.stack([r * cl * np.cos(lon, dtype=np.float32),
                    r * cl * np.sin(lon, dtype=np.float32),
                    r * np.sin(lat, dtype=np.float32)], axis=-1)
    return out.astype(np.float32)


def np_to_spherical(p):
    """Cartesian (..., 3) -> spherical (..., 3) = (r, lat, lon), float32."""
    p = np.asarray(p, np.float32)
    r = np.sqrt(np.sum(p * p, axis=-1, dtype=np.float32)).astype(np.float32)
    lat = np.arcsin(p[..., 2] / r).astype(np.float32)
    lon = np.arctan2(p[..., 1], p[..., 0]).astype(np.float32)
    return np.stack([r, lat, lon], axis=-1)
