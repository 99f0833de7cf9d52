"""Synthetic ICON-like datasets for tests and benchmarks.

The reference carries one hard-coded synthetic cell behind '#if 0'
(ref: icon_rt/hostCode.cu:768-790) and otherwise relies on converted DWD
data.  We generate ICON-shaped data on demand: triangulated sections of a
sphere (lat/lon quads split into triangles) and true icosphere subdivisions
matching ICON RnBk cell counts (ncell = 20 * n^2 * 4^k).

Corner ordering is CCW as seen from outside the sphere — the orientation
the point-in-prism side-plane tests assume (ref: icon_rt/ICONGrid.h:197-203).
"""
from __future__ import annotations

import numpy as np

from .icfile import ICDataset, MAX_LAYERS
from ..utils.vecmath import np_to_cartesian

EARTH_RADIUS = np.float32(6.371229e6)  # ref: tools/convert_icon.cpp:359


def single_cell() -> ICDataset:
    """The reference's hidden synthetic sanity-check cell
    (ref: icon_rt/hostCode.cu:768-790)."""
    lat = np.deg2rad(np.array([[0.0, 90.0, 0.0]], np.float32)).astype(np.float32)
    lon = np.deg2rad(np.array([[30.0, 0.0, -30.0]], np.float32)).astype(np.float32)
    num_layers = np.array([2], np.int32)
    height = np.zeros((1, MAX_LAYERS), np.float32)
    height[0, :3] = [100.0, 110.0, 120.0]
    value = np.zeros((1, MAX_LAYERS), np.float32)
    value[0, :2] = [0.1, 1.0]
    return ICDataset(lat, lon, num_layers, height, value)


def _default_field(lat, lon, h_rel):
    """Smooth scalar in [0, 1]: banded waves over the sphere, decaying with height."""
    v = 0.5 + 0.35 * np.sin(3.0 * lon) * np.cos(2.0 * lat) + 0.15 * np.cos(7.0 * lat)
    return np.clip(v * (1.0 - 0.5 * h_rel), 0.0, 1.0).astype(np.float32)


def _fill_layers(lat, lon, num_layers: int, radius: float, thickness: float,
                 field_fn) -> ICDataset:
    """Assemble an ICDataset from per-cell corner (lat, lon) arrays."""
    n = lat.shape[0]
    assert 1 <= num_layers <= MAX_LAYERS - 1
    height = np.zeros((n, MAX_LAYERS), np.float32)
    value = np.zeros((n, MAX_LAYERS), np.float32)
    layer_h = np.float32(thickness / num_layers)
    for j in range(num_layers + 1):
        height[:, j] = np.float32(radius) + np.float32(j) * layer_h
    clat = lat.mean(axis=1)
    clon = np.arctan2(np.sin(lon).mean(axis=1), np.cos(lon).mean(axis=1))
    for j in range(num_layers):
        h_rel = (j + 0.5) / num_layers
        value[:, j] = field_fn(clat, clon, np.float32(h_rel))
    return ICDataset(lat.astype(np.float32), lon.astype(np.float32),
                     np.full(n, num_layers, np.int32), height, value)


def _orient_ccw(lat, lon, radius):
    """Swap corners 1<->2 wherever the triangle is clockwise seen from outside."""
    p = np_to_cartesian(np.stack([np.full_like(lat, radius, dtype=np.float32),
                                  lat, lon], axis=-1))  # (N, 3, 3)
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    centroid = p.mean(axis=1)
    cw = np.sum(n * centroid, axis=-1) < 0.0
    lat[cw, 1], lat[cw, 2] = lat[cw, 2], lat[cw, 1].copy()
    lon[cw, 1], lon[cw, 2] = lon[cw, 2], lon[cw, 1].copy()
    return lat, lon


def latlon_section(n_lat: int = 8, n_lon: int = 16,
                   lat_range=(-45.0, 45.0), lon_range=(-90.0, 90.0),
                   num_layers: int = 4,
                   radius: float = float(EARTH_RADIUS),
                   thickness: float = 3.0e4,
                   field_fn=_default_field) -> ICDataset:
    """Triangulated lat/lon patch: each quad split into two CCW triangles."""
    lat_e = np.deg2rad(np.linspace(lat_range[0], lat_range[1], n_lat + 1)).astype(np.float32)
    lon_e = np.deg2rad(np.linspace(lon_range[0], lon_range[1], n_lon + 1)).astype(np.float32)
    tris_lat, tris_lon = [], []
    for i in range(n_lat):
        for j in range(n_lon):
            la0, la1 = lat_e[i], lat_e[i + 1]
            lo0, lo1 = lon_e[j], lon_e[j + 1]
            # CCW from outside = counterclockwise in the (east, north) frame
            tris_lat.append([la0, la0, la1]); tris_lon.append([lo0, lo1, lo1])
            tris_lat.append([la0, la1, la1]); tris_lon.append([lo0, lo1, lo0])
    lat = np.array(tris_lat, np.float32)
    lon = np.array(tris_lon, np.float32)
    lat, lon = _orient_ccw(lat, lon, radius)
    return _fill_layers(lat, lon, num_layers, radius, thickness, field_fn)


def icosphere(subdivisions: int = 2, num_layers: int = 4,
              radius: float = float(EARTH_RADIUS),
              thickness: float = 3.0e4,
              field_fn=_default_field) -> ICDataset:
    """Subdivided icosahedron: 20 * 4^subdivisions triangular columns.

    subdivisions=5 gives 20480 cells ~ ICON R2B4; each +1 is one R2B level.
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    tri = verts[faces]  # (F, 3, 3)
    for _ in range(subdivisions):
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        tri = np.concatenate([
            np.stack([a, ab, ca], axis=1),
            np.stack([ab, b, bc], axis=1),
            np.stack([ca, bc, c], axis=1),
            np.stack([ab, bc, ca], axis=1),
        ], axis=0)
        tri /= np.linalg.norm(tri, axis=2, keepdims=True)
    lat = np.arcsin(np.clip(tri[..., 2], -1.0, 1.0)).astype(np.float32)
    lon = np.arctan2(tri[..., 1], tri[..., 0]).astype(np.float32)
    lat, lon = _orient_ccw(lat, lon, radius)
    return _fill_layers(lat, lon, num_layers, radius, thickness, field_fn)
