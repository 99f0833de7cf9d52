"""ICON cell columns as a structure of tensors.

The reference's core data element is one triangular prism column of the
icosahedral grid with up to 32 stacked layers (ref: icon_rt/ICONGrid.h:59-77).
The three side planes of every column are precomputed on the host at load
time, so a point query is a handful of dense ops:

    inside = (h_bot <= r <= h_top) AND (dot(pos, n_k) - w_k <= 0 for k=1..3)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.icfile import ICDataset, MAX_LAYERS
from ..utils.vecmath import np_to_cartesian


class Cells(NamedTuple):
    """Per-cell tensors (all leading dim N), on one device."""
    lat: torch.Tensor           # (N, 3) f32 radians
    lon: torch.Tensor           # (N, 3) f32 radians
    num_layers: torch.Tensor    # (N,)   i32
    height: torch.Tensor        # (N, 32) f32 radii
    value: torch.Tensor         # (N, 32) f32 scalars
    planes: torch.Tensor        # (N, 3, 4) f32 precomputed side planes
    h_bot: torch.Tensor         # (N,) f32 = height[:, 0]
    h_top: torch.Tensor         # (N,) f32 = height[num_layers]

    @property
    def num_cells(self) -> int:
        return self.lat.shape[0]


class CellStats(NamedTuple):
    """Host-side aggregates computed at load time (ref: hostCode.cu:760-808)."""
    world_bounds_lo: np.ndarray    # (3,) f32 Cartesian AABB
    world_bounds_hi: np.ndarray    # (3,) f32
    spherical_bounds_lo: np.ndarray  # (3,) f32 (r, lat, lon)
    spherical_bounds_hi: np.ndarray  # (3,) f32
    data_range: np.ndarray         # (2,) f32 (min, max scalar)


def _corner_xyz(ds: ICDataset, radii: np.ndarray) -> np.ndarray:
    """(N,) radii + per-corner lat/lon -> (N, 3, 3) Cartesian corners."""
    sph = np.stack([np.broadcast_to(radii[:, None], ds.lat.shape),
                    ds.lat, ds.lon], axis=-1)
    return np_to_cartesian(sph)


def _np_plane(a, b, c):
    n = np.cross(b - a, c - a).astype(np.float32)
    w = np.sum(a * n, axis=-1, dtype=np.float32)
    return np.concatenate([n, w[..., None]], axis=-1)


def build_cells(ds: ICDataset, device="cpu") -> Cells:
    n = ds.num_cells
    idx = np.arange(n)
    h_bot = ds.height[:, 0].astype(np.float32)
    h_top = ds.height[idx, ds.num_layers].astype(np.float32)

    bv = _corner_xyz(ds, h_bot)   # (N, 3, 3) bottom corners
    tv = _corner_xyz(ds, h_top)   # (N, 3, 3) top corners

    # Side planes through (bv_i, bv_j, tv_j), CCW (ref: ICONGrid.h:197-199)
    p1 = _np_plane(bv[:, 0], bv[:, 1], tv[:, 1])
    p2 = _np_plane(bv[:, 1], bv[:, 2], tv[:, 2])
    p3 = _np_plane(bv[:, 2], bv[:, 0], tv[:, 0])
    planes = np.stack([p1, p2, p3], axis=1)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Cells(lat=t(ds.lat), lon=t(ds.lon), num_layers=t(ds.num_layers),
                 height=t(ds.height), value=t(ds.value), planes=t(planes),
                 h_bot=t(h_bot), h_top=t(h_top))


def cell_bounds(ds: ICDataset) -> tuple[np.ndarray, np.ndarray]:
    """Per-cell Cartesian AABBs with the outward bulge correction for the
    curved top face (ref: icon_rt/ICONGrid.h:78-115)."""
    idx = np.arange(ds.num_cells)
    h_bot = ds.height[:, 0].astype(np.float32)
    h_top = ds.height[idx, ds.num_layers].astype(np.float32)
    bv = _corner_xyz(ds, h_bot)
    tv = _corner_xyz(ds, h_top)
    bary = tv.mean(axis=1, dtype=np.float32).astype(np.float32)
    r = h_top
    d = r - np.sqrt(np.sum(bary * bary, axis=-1, dtype=np.float32))
    off = (d / r).astype(np.float32)
    tv = tv + tv * off[:, None, None]
    pts = np.concatenate([bv, tv], axis=1)  # (N, 6, 3)
    return pts.min(axis=1), pts.max(axis=1)


def compute_stats(ds: ICDataset) -> CellStats:
    lo, hi = cell_bounds(ds)
    idx = np.arange(ds.num_cells)
    h_top = ds.height[idx, ds.num_layers]
    layer_mask = np.arange(MAX_LAYERS)[None, :] < ds.num_layers[:, None]
    vals = ds.value[layer_mask]
    return CellStats(
        world_bounds_lo=lo.min(axis=0).astype(np.float32),
        world_bounds_hi=hi.max(axis=0).astype(np.float32),
        spherical_bounds_lo=np.array([ds.height[:, 0].min(), ds.lat.min(),
                                      ds.lon.min()], np.float32),
        spherical_bounds_hi=np.array([h_top.max(), ds.lat.max(),
                                      ds.lon.max()], np.float32),
        data_range=np.array([vals.min(), vals.max()], np.float32) if vals.size
        else np.array([np.inf, -np.inf], np.float32),
    )
