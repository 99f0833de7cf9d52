"""ICON cell columns as a structure of tensors.

The reference's core data element is one triangular prism column of the
icosahedral grid with up to 32 stacked layers (ref: icon_rt/ICONGrid.h:59-77).
The three side planes of every column are precomputed on the host at load
time, so a point query is a handful of dense ops:

    inside = (h_bot <= r <= h_top) AND (dot(pos, n_k) - w_k <= 0 for k=1..3)

The point samplers at the end (`find_layer`, `sample_one_cell`,
`sample_brute_force`) are batched over lanes: a position is an (L, 3)
tensor.  They are the plain versions of the samplers inside kernel K8
(csrc/parity.cu).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.icfile import ICDataset, MAX_LAYERS
from ..utils.vecmath import np_to_cartesian, sqrt_rn


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
    shell: torch.Tensor         # (4,) f32 radial shell (`shell_range`)

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


def check_ceilings(height, num_layers):
    """Raise ValueError naming the first column whose layer ceilings
    height[1..num_layers] do not ascend (ties allowed).  height (N, 32)
    and num_layers (N,) numpy, compared in f32 as the K5a bake stores them:
    the f32 tracker K1 finds the layer #(h < r) of a radius by binary
    search over a column's ceilings and keeps its bracket
    (csrc/tier_f32.cuh), which equals the count only over ascending
    ceilings (the reference's binary search assumes them too,
    ICONGrid.h:117-145)."""
    h = np.asarray(height, np.float32)
    k = np.arange(2, h.shape[1])
    bad = ~(h[:, 2:] >= h[:, 1:-1]) \
        & (k[None, :] <= np.asarray(num_layers)[:, None])
    cols = np.flatnonzero(bad.any(1))
    if cols.size:
        raise ValueError(f"column {cols[0]}: its layer ceilings do not "
                         f"ascend ({cols.size} such columns)")


def square_bounds(lo, hi):
    """(s_lo, s_hi), f32: the least s with sqrt(s) >= lo and the greatest
    with sqrt(s) <= hi, for the correctly rounded f32 square root (CUDA's
    sqrtf, utils/vecmath.py `sqrt_rn`), which is monotone: so lo <=
    sqrt(s) <= hi exactly when s_lo <= s <= s_hi, and a NaN s passes
    neither.  Stepped from lo * lo and hi * hi an ULP at a time."""
    f, inf = np.float32, np.float32(np.inf)
    sq = lambda x: np.float32(np.sqrt(np.float64(x)))
    lo, hi = f(lo), f(hi)
    if not lo > 0:
        s_lo = -inf                   # every radius is >= lo
    else:
        a = f(lo * lo)
        while a > 0 and sq(np.nextafter(a, f(0))) >= lo:
            a = np.nextafter(a, f(0))
        while sq(a) < lo:
            a = np.nextafter(a, inf)
        s_lo = a
    if not hi >= 0:
        s_hi = -inf                   # no radius is <= hi
    else:
        b = f(hi * hi)
        while sq(b) > hi:
            b = np.nextafter(b, f(0))
        while b < inf and sq(np.nextafter(b, inf)) <= hi:
            b = np.nextafter(b, inf)
        s_hi = b
    return f(s_lo), f(s_hi)


def shell_range(h_bot, h_top) -> np.ndarray:
    """The cells' radial shell as (4,) f32: [min h_bot, max h_top] (NaNs
    ignored; [+inf, -inf] without cells), then the same bounds on the
    squared radius (`square_bounds`).  A point whose radius fails
    `in_shell` fails every cell's radial test h_bot <= r <= h_top, so the
    locator and brute samplers may reject it without a locate (K8's
    pre-test, csrc/parity.cu `sample`, on the squared radius)."""
    lo = np.fmin.reduce(np.asarray(h_bot, np.float32).reshape(-1),
                        initial=np.float32(np.inf))
    hi = np.fmax.reduce(np.asarray(h_top, np.float32).reshape(-1),
                        initial=np.float32(-np.inf))
    return np.array([lo, hi, *square_bounds(lo, hi)], np.float32)


def build_cells(ds: ICDataset, device="cpu") -> Cells:
    n = ds.num_cells
    check_ceilings(ds.height, ds.num_layers)
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
                 h_bot=t(h_bot), h_top=t(h_top),
                 shell=t(shell_range(h_bot, h_top)))


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


def layer_bounds(ds: ICDataset, layer_lo: np.ndarray, layer_hi: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Cartesian AABBs of one layer slab per cell, with bulge correction on
    the top face (ref: icon_rt/hostCode.cu:256-290). layer_lo/hi are (N,)
    radii of the slab's bottom/top."""
    bv = _corner_xyz(ds, layer_lo.astype(np.float32))
    tv = _corner_xyz(ds, layer_hi.astype(np.float32))
    bary = tv.mean(axis=1, dtype=np.float32).astype(np.float32)
    r = layer_hi.astype(np.float32)
    d = r - np.sqrt(np.sum(bary * bary, axis=-1, dtype=np.float32))
    off = (d / r).astype(np.float32)
    tv = tv + tv * off[:, None, None]
    pts = np.concatenate([bv, tv], axis=1)
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


# ---------------------------------------------------------------------------
# Point sampling, batched over lanes
# ---------------------------------------------------------------------------

#: lanes x cells of one brute-force chunk (bounds its (M, N) temporaries)
_BRUTE_CHUNK = 1 << 22


def find_layer(height_rows, num_layers, hpos):
    """Index i of the layer containing radius hpos: smallest i with
    hpos <= height[i+1], as the masked count over the 31 ceilings (ref:
    icon_rt/ICONGrid.h:117-145 is a branchless binary search with the same
    result).  height_rows (L, 32), num_layers (L,), hpos (L,) -> (L,) i64."""
    k = torch.arange(1, MAX_LAYERS, device=height_rows.device)
    mask = (k[None, :] <= num_layers[:, None]) \
        & (height_rows[:, 1:] < hpos[:, None])
    return mask.sum(dim=1)


def _eval_planes(planes, pos):
    """planes (..., 3, 4), pos (..., 3) -> (..., 3) plane evaluations
    dot(pos, n) - w, summed x, y, z in order."""
    p = pos[..., None, :]
    return (planes[..., 0] * p[..., 0] + planes[..., 1] * p[..., 1]
            + planes[..., 2] * p[..., 2]) - planes[..., 3]


def _radius(pos):
    return sqrt_rn(pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1]
                   + pos[:, 2] * pos[:, 2])


def in_shell(cells: Cells, r):
    """The whole-shell radial test of radii r (L,): shell[0] <= r <=
    shell[1], False for NaN.  A point that fails it lies in no cell (K8
    tests its squared radius against shell[2:], which rejects the same
    points)."""
    return (r >= cells.shell[0]) & (r <= cells.shell[1])


def candidate_tests(cells: Cells, idx, pos, r):
    """The two parts of the point-in-prism test of candidate cells idx
    (L, K) (None: every cell, K = N) at pos (L, 3) with radius r (L,):
    (radial (L, K), planes (L, K, 3)) pass masks; a candidate contains the
    point where all pass."""
    h_bot, h_top, planes = ((cells.h_bot, cells.h_top, cells.planes)
                            if idx is None else (cells.h_bot[idx],
                                                 cells.h_top[idx],
                                                 cells.planes[idx]))
    radial = (r[:, None] >= h_bot) & (r[:, None] <= h_top)
    return radial, _eval_planes(planes, pos[:, None, :]) <= 0.0


def sample_one_cell(cells: Cells, cell_idx, pos, r):
    """Point-in-prism test and layer value of one cell per lane
    (ref: icon_rt/ICONGrid.h:181-208).  cell_idx (L,), pos (L, 3), r (L,)
    its radius.  Returns (inside (L,) bool, value (L,) f32, 0 outside)."""
    cell_idx = cell_idx.long()
    inside_r = (r >= cells.h_bot[cell_idx]) & (r <= cells.h_top[cell_idx])
    ev = _eval_planes(cells.planes[cell_idx], pos)
    inside = inside_r & (ev <= 0.0).all(dim=-1)
    layer = find_layer(cells.height[cell_idx], cells.num_layers[cell_idx], r)
    val = cells.value[cell_idx, layer]
    return inside, torch.where(inside, val, 0.0)


def sample_brute_force(cells: Cells, pos):
    """Linear scan over all cells; the reference's no-RT fallback
    (ref: icon_rt/deviceCode.cu:116-123).  The first (lowest-index)
    containing cell wins.  pos (L, 3) -> (hit (L,) bool, value (L,) f32)."""
    n, L = cells.num_cells, pos.shape[0]
    r = _radius(pos)
    idx = torch.zeros(L, dtype=torch.int64, device=pos.device)
    hit = torch.zeros(L, dtype=torch.bool, device=pos.device)
    step = max(1, _BRUTE_CHUNK // max(n, 1))
    for a in range(0, L, step):
        radial, planes = candidate_tests(cells, None, pos[a:a + step],
                                         r[a:a + step])
        inside = radial & planes.all(dim=-1)                 # (M, N)
        hit[a:a + step] = inside.any(dim=1)
        idx[a:a + step] = inside.to(torch.uint8).argmax(dim=1)
    layer = find_layer(cells.height[idx], cells.num_layers[idx], r)
    return hit, torch.where(hit, cells.value[idx, layer], 0.0)
