"""Level-of-detail mip tiers for icosphere scenes (host numpy).

At R2B9 on a 1080p frame seen whole, the cells are far below a pixel, so
the full-resolution walk pays locator traffic for detail the image cannot
resolve.  A value-space mip chain renders the level whose cell size
matches the pixel footprint instead.

Index rule.  Cell i of a subdivision-s icosphere decomposes as
`base = i % 20`, child path = base-4 digits of i // 20 with the LSB the
FIRST subdivision (data/device_scene.py).  The digit added by the LAST
subdivision is therefore the most significant, with place value
20 * 4^(s-1) = n/4, so

    parent(i)   = i mod (n / 4)
    children(p) = { p + d * (n / 4) : d in 0..3 }
    descendants of p after l more levels = { p + m * n_coarse : m < 4^l }

The geometry of mip level l IS the subdivision-(s-l) icosphere, so only the
field is derived: per-layer mean pooling in value space, classification
staying at sample time.  `device_scene.synth_quantized_device(s - l, ...,
field_lod=l)` builds the tier on the device (kernel K7-scene); its locator
and fine map are plain subdivision-(s-l) artifacts (geometry only).

`build_lod_dataset` is the geometric tier of an arbitrary dataset, and
`frame_lod` picks the level of a framing from the analytic synthetic
bounds before any table is built.  The counterparts are the JAX package's
icon_rt_tpu/data/lod.py and bench.py `_auto_lod`/`_camera`.
"""
from __future__ import annotations

import numpy as np

from ..models.cells import build_cells
from ..models.locator import build_locator_csr
from ..ops.camera import Camera
from ..utils.vecmath import np_to_cartesian
from .icfile import ICDataset, MAX_LAYERS
from .synthetic import EARTH_RADIUS, icosphere

#: central angle of an icosahedron edge: arccos(1/sqrt(5)) ~ 63.435deg
_ICO_EDGE_RAD = float(np.arccos(1.0 / np.sqrt(5.0)))

#: the synthetic scenes' shell thickness (data/device_scene.py's default)
SCENE_THICKNESS = 3.0e4


def parent_index(i, n: int):
    """Level-(s-1) parent of cell i in a subdivision-s icosphere of n
    cells (array-friendly)."""
    return i % (n // 4)


def children_indices(p, n_coarse: int) -> list:
    """The 4 subdivision-(s+1) children of coarse cell p (n_coarse =
    coarse-level cell count; children live at index p + d * n_coarse of
    the 4 * n_coarse fine cells)."""
    return [p + d * n_coarse for d in range(4)]


def cell_edge_m(subdivisions: int, radius: float) -> float:
    """Arc length of a cell edge at the given subdivision (meters):
    midpoint subdivision halves edge angles per level."""
    return radius * _ICO_EDGE_RAD / (2.0 ** subdivisions)


def equivalent_subdiv(n_cells: int) -> int:
    """Icosphere subdivision equivalent of an N-column grid (20 * 4^s = N),
    for datasets whose cell count is not exactly icosahedral."""
    return max(0, int(round(np.log(max(n_cells, 20) / 20.0) / np.log(4.0))))


def build_lod_dataset(ds: ICDataset, level: int,
                      num_layers: int | None = None):
    """Geometric mip tier of an arbitrary dataset: (coarse ICDataset, (N,)
    int64 coarse row of every fine column).

      * coarse geometry: a plain icosphere at subdivision
        equivalent_subdiv(N) - level;
      * every fine column goes to the coarse column whose side planes
        contain its centroid direction (coarse locator bins, then the
        candidates' plane tests; the nearest coarse centroid for the rare
        orphan on a shared plane);
      * per coarse column: the radial span [min member h_bot, max member
        h_top] in uniform layers, and each layer's value the mean over the
        members of the member's value at the layer's midpoint radius.

    Empty coarse columns (regional datasets) are dropped.  The member's
    layer at a radius counts only its own ceilings: the reference compares
    against all 31 ceiling slots, and the zero padding past num_layers then
    puts every column of fewer than 31 layers in its top layer (ROADMAP
    Queue 3, fault F1).  Here the padded ceilings are +inf."""
    n = ds.num_cells
    s_c = max(0, equivalent_subdiv(n) - max(level, 0))
    idx = np.arange(n)
    h_bot_f = ds.height[:, 0].astype(np.float64)
    h_top_f = ds.height[idx, ds.num_layers].astype(np.float64)
    r_lo, r_hi = float(h_bot_f.min()), float(h_top_f.max())

    # coarse geometry spanning the full radial range
    coarse = icosphere(subdivisions=s_c, num_layers=1, radius=r_lo,
                       thickness=max(r_hi - r_lo, 1.0))
    nc = coarse.num_cells

    # fine centroid directions (cartesian mean of corners: robust at the
    # poles and across the lon wrap)
    sph = np.stack([np.ones_like(ds.lat), ds.lat, ds.lon], axis=-1)
    u = np_to_cartesian(sph).mean(axis=1)
    u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-30)
    r_mid = 0.5 * (r_lo + r_hi)
    pts = (u * r_mid).astype(np.float64)
    clat = np.arcsin(np.clip(u[:, 2], -1.0, 1.0))
    clon = np.arctan2(u[:, 1], u[:, 0])

    planes = build_cells(coarse).planes.numpy().astype(np.float64)

    # locator-binned candidate assignment: O(N * k_cap), not O(N * Nc)
    csr, k_cap = build_locator_csr(coarse)
    starts, counts, items = csr.starts, csr.counts, csr.items
    n_lat, n_lon = csr.dims
    bl = np.clip(((clat - float(np.float32(csr.lat_lo)))
                  / (float(np.float32(csr.lat_hi))
                     - float(np.float32(csr.lat_lo))) * n_lat
                  ).astype(np.int64), 0, n_lat - 1)
    bo = np.clip(((clon - float(np.float32(csr.lon_lo)))
                  / (float(np.float32(csr.lon_hi))
                     - float(np.float32(csr.lon_lo))) * n_lon
                  ).astype(np.int64), 0, n_lon - 1)
    bid = bl * n_lon + bo
    assign = np.full(n, -1, np.int64)
    for kslot in range(k_cap):
        rows = starts[bid] + kslot
        ok = (kslot < counts[bid]) & (assign < 0)
        cand = np.where(ok, items[np.minimum(rows, len(items) - 1)], 0)
        ev = np.einsum("nkj,nj->nk", planes[cand, :, :3], pts) \
            - planes[cand, :, 3]
        inside = ok & (ev <= 1e-6 * r_mid).all(axis=1)
        assign = np.where(inside & (assign < 0), cand, assign)
    if (assign < 0).any():
        cu = np_to_cartesian(np.stack([np.ones_like(coarse.lat),
                                       coarse.lat, coarse.lon],
                                      axis=-1)).mean(axis=1)
        cu /= np.maximum(np.linalg.norm(cu, axis=1, keepdims=True), 1e-30)
        orphans = np.where(assign < 0)[0]
        assign[orphans] = np.argmax(u[orphans] @ cu.T, axis=1)

    # pooled radial spans
    members = np.bincount(assign, minlength=nc)
    hb = np.full(nc, np.inf)
    ht = np.full(nc, -np.inf)
    np.minimum.at(hb, assign, h_bot_f)
    np.maximum.at(ht, assign, h_top_f)
    keep = members > 0
    lc = int(num_layers if num_layers is not None
             else min(MAX_LAYERS - 1, int(ds.num_layers.max())))

    height_c = np.zeros((nc, MAX_LAYERS), np.float32)
    value_c = np.zeros((nc, MAX_LAYERS), np.float32)
    hb_s = np.where(keep, hb, r_lo)
    ht_s = np.where(keep, ht, r_hi)
    for j in range(lc + 1):
        height_c[:, j] = hb_s + (ht_s - hb_s) * (j / lc)
    # each fine column's own layer ceilings; the padding past them never
    # counts (fault F1 of the reference)
    own = np.arange(1, MAX_LAYERS)[None, :] <= ds.num_layers[:, None]
    ceil_f = np.where(own, ds.height[:, 1:MAX_LAYERS], np.float32(np.inf))
    for k in range(lc):
        mid = 0.5 * (height_c[:, k] + height_c[:, k + 1])
        mid_f = mid[assign]
        lay = (mid_f[:, None] > ceil_f).sum(axis=1)
        lay = np.minimum(lay, np.maximum(ds.num_layers - 1, 0))
        vf = ds.value[idx, lay]
        acc = np.zeros(nc)
        np.add.at(acc, assign, vf)
        value_c[:, k] = np.where(keep, acc / np.maximum(members, 1),
                                 0.0).astype(np.float32)

    out = ICDataset(
        lat=coarse.lat[keep], lon=coarse.lon[keep],
        num_layers=np.full(int(keep.sum()), lc, np.int32),
        height=height_c[keep], value=value_c[keep])
    remap = np.cumsum(keep) - 1
    return out, remap[assign]


def select_lod(cam_org, r_out: float, fovy: float, height: int,
               subdivisions: int, max_lod: int = 4) -> int:
    """Nearest-mip level for a whole frame: round(log2(pixel footprint at
    the globe's near point / cell edge)), clipped to [0, max_lod]."""
    d = float(np.linalg.norm(np.asarray(cam_org, np.float64)))
    d_near = max(d - r_out, 1e-6 * r_out)
    pixel_rad = fovy / height
    footprint = pixel_rad * d_near
    lam = np.log2(max(footprint, 1e-30)
                  / cell_edge_m(subdivisions, r_out))
    return int(np.clip(np.round(lam), 0, max_lod))


def frame_camera(stats, framing: str, width: int, height: int) -> Camera:
    """The bench's camera of a framing (bench.py `_camera`): "viewall" is
    the reference's default framing (Camera.view_all of the world box),
    "closeup" puts the camera where the globe slightly overfills the frame
    vertically."""
    cam = Camera()
    cam.set_aspect(width / height)
    if framing == "viewall":
        cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
        return cam
    if framing != "closeup":
        raise ValueError(f"frame_camera: unknown framing {framing!r}")
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    r_out = float(stats.spherical_bounds_hi[0])
    theta = np.arctan(1.15 * np.tan(0.5 * cam.fovy))
    d = r_out / np.sin(theta)
    direction = np.array([2.2, 0.4, 0.9], np.float32)
    direction /= np.linalg.norm(direction)
    cam.set_orientation(center + direction * d, center,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    return cam


class _AnalyticBounds:
    """The synthetic scene's bounds before any table exists: the outer
    radius EARTH_RADIUS + the shell, the box 2% past it."""
    r_out = float(EARTH_RADIUS) + SCENE_THICKNESS
    world_bounds_lo = np.full(3, -r_out * 1.02, np.float32)
    world_bounds_hi = np.full(3, r_out * 1.02, np.float32)
    spherical_bounds_lo = np.array([r_out - SCENE_THICKNESS, 0, 0],
                                   np.float32)
    spherical_bounds_hi = np.array([r_out, 0, 0], np.float32)


def frame_lod(subdiv: int, framing: str, width: int, height: int) -> int:
    """The mip level of a synthetic subdivision-`subdiv` scene seen with a
    framing at width x height (bench.py `_auto_lod`), clamped to
    subdiv - 1 so at least the 20 base faces remain."""
    st = _AnalyticBounds
    cam = frame_camera(st, framing, width, height)
    lod = select_lod(cam.position, st.r_out, float(cam.fovy), height, subdiv)
    return min(lod, subdiv - 1)
