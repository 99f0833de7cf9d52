"""Vector math: host-side numpy float32 for scene builders, and the
ray/box slab test on tensors.

Spherical conventions follow the reference (ref: icon_rt/ICONGrid.h:36-54):
spherical = (r, lat, lon) with lat = asin(z/r), lon = atan2(y, x).
"""
from __future__ import annotations

import numpy as np
import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of an f32 tensor, as CUDA's sqrtf
    and numpy's.  PyTorch's vectorized CPU sqrt is not (1 ULP off on
    ~0.8% of f32 inputs with the AVX512 kernels); the square root in f64
    rounded once to f32 is exact for every f32 input."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def box_test(org, direction, tmin, tmax, box_lo, box_hi):
    """Ray/box slab test (ref: common/vecmath.h:1926-1937), batched over
    leading axes of (..., 3) tensors; returns (hit, t0, t1).  No
    zero-direction guard, exactly like the reference: ray directions are
    clamped away from zero at generation time."""
    t_lo = (box_lo - org) / direction
    t_hi = (box_hi - org) / direction
    t_nr = torch.minimum(t_lo, t_hi)
    t_fr = torch.maximum(t_lo, t_hi)
    t0 = torch.clamp(t_nr.amax(dim=-1), min=tmin)
    t1 = torch.clamp(t_fr.amin(dim=-1), max=tmax)
    return t0 < t1, t0, t1


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
