"""North-star scenes: the direct-to-quantized synthesizer, its device
twin's assembly (`build_q_scene`), and the on-disk caches of the locator
and the fine map (models/finemap.py), keyed by scene.

`synth_quantized` is the host (numpy) synthesizer: a subdivided icosahedron
with the banded-wave field and uniform layer spacing, straight into the
quantized representation (f32 triangle-soup subdivision; the per-layer
field evaluated at column centroids and quantized to u8; one broadcast
h_frac row; radial-band value ranges per layer).  At R2B9 it is minutes of
numpy, so north-star builds go through data/device_scene.py on the card;
the host synthesizer is the oracle the tests hold the device one against.

A viewer run or a batch of renders of one dataset bins its locator and
builds its fine map once: both are functions of the scene's geometry
alone, so (scene key, locator scale) names the locator and (scene key,
factor) the fine map.  The caches hold
this package's unpacked tables, so they are not shared with the JAX
package's caches of packed ones.

`CACHE_DIR` is a module attribute: point it elsewhere (chip_smoke.py uses an
empty directory, so the builds really run) before the first call.
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..models.cells import CellStats
from .synthetic import EARTH_RADIUS, _default_field

F = np.float32

#: npz cache directory (inside the package's gitignored build directory)
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "scenes")

_ICO_T = (1.0 + np.sqrt(5.0)) / 2.0
_ICO_VERTS = np.array([
    [-1, _ICO_T, 0], [1, _ICO_T, 0], [-1, -_ICO_T, 0], [1, -_ICO_T, 0],
    [0, -1, _ICO_T], [0, 1, _ICO_T], [0, -1, -_ICO_T], [0, 1, -_ICO_T],
    [_ICO_T, 0, -1], [_ICO_T, 0, 1], [-_ICO_T, 0, -1], [-_ICO_T, 0, 1],
], np.float64)
_ICO_FACES = np.array([
    [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
    [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
    [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
    [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
], np.int64)


def _subdivide_f32(subdivisions: int) -> np.ndarray:
    """(20 * 4^s, 3, 3) f32 unit-vector triangle soup, block face order
    (same order as synthetic.icosphere, computed in f32)."""
    verts = _ICO_VERTS / np.linalg.norm(_ICO_VERTS, axis=1, keepdims=True)
    tri = verts[_ICO_FACES].astype(F)
    for _ in range(subdivisions):
        f = tri.shape[0]
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        ab, bc, ca = a + b, b + c, c + a   # normalization absorbs the 1/2
        out = np.empty((4 * f, 3, 3), F)
        out[:f, 0], out[:f, 1], out[:f, 2] = a, ab, ca
        out[f:2 * f, 0], out[f:2 * f, 1], out[f:2 * f, 2] = ab, b, bc
        out[2 * f:3 * f, 0], out[2 * f:3 * f, 1], out[2 * f:3 * f, 2] = ca, bc, c
        out[3 * f:, 0], out[3 * f:, 1], out[3 * f:, 2] = ab, bc, ca
        out /= np.sqrt(np.einsum("fij,fij->fi", out, out))[:, :, None]
        tri = out
    return tri


class QuantScene(NamedTuple):
    """Host-side arrays of a quantized scene (move with to_device)."""
    test12: np.ndarray       # (N, 12) f32
    h_frac: np.ndarray       # (N, Lm) u16
    value_q: np.ndarray      # (N, Lm) u8
    value_lo: float
    value_hi: float
    lat: np.ndarray          # (N, 3) f32 corner latitudes (locator build)
    lon: np.ndarray          # (N, 3) f32
    band_edges: np.ndarray   # (B+1,) f32
    band_ranges: np.ndarray  # (B, 2) f32
    stats: CellStats

    @property
    def num_cells(self) -> int:
        return self.test12.shape[0]


def synth_quantized(subdivisions: int, num_layers: int,
                    radius: float = float(EARTH_RADIUS),
                    thickness: float = 3.0e4,
                    num_bands: int = 64,
                    field_fn=_default_field) -> QuantScene:
    t0 = time.time()
    tri = _subdivide_f32(subdivisions)             # (N, 3, 3) unit vectors
    n = tri.shape[0]
    lat = np.arcsin(np.clip(tri[..., 2], -1.0, 1.0)).astype(F)
    lon = np.arctan2(tri[..., 1], tri[..., 0]).astype(F)
    # CCW orientation seen from outside (swap corners 1<->2 where clockwise;
    # same predicate as synthetic._orient_ccw, reusing the unit vectors)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    cw = np.einsum("fi,fi->f", nrm, tri.mean(axis=1)) < 0.0
    tri[cw, 1], tri[cw, 2] = tri[cw, 2], tri[cw, 1].copy()
    lat[cw, 1], lat[cw, 2] = lat[cw, 2], lat[cw, 1].copy()
    lon[cw, 1], lon[cw, 2] = lon[cw, 2], lon[cw, 1].copy()

    h_bot = F(radius)
    h_top = F(radius + thickness)
    lm = max(8, -(-num_layers // 8) * 8)

    # side planes through (bv_i, bv_j, tv_j) = (c_i h_bot, c_j h_bot,
    # c_j h_top) (ref: icon_rt/ICONGrid.h:197-199); w == 0 (radial edges)
    test12 = np.empty((n, 12), F)
    for k, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
        a = tri[:, i] * h_bot
        b = tri[:, j] * h_bot
        c = tri[:, j] * h_top
        test12[:, 3 * k:3 * k + 3] = np.cross(b - a, c - a)
    test12[:, 9] = h_bot
    test12[:, 10] = h_top
    test12[:, 11] = F(num_layers)

    # uniform layer spacing -> one broadcast h_frac row
    k1 = np.arange(1, lm + 1)
    row = np.where(k1 <= num_layers,
                   np.clip(np.rint(k1 / num_layers * 65535.0), 0, 65535),
                   65535).astype(np.uint16)
    h_frac = np.broadcast_to(row, (n, lm))

    # field at column centroids, per layer (matches synthetic._fill_layers)
    clat = lat.mean(axis=1)
    clon = np.arctan2(np.sin(lon).mean(axis=1), np.cos(lon).mean(axis=1))
    layer_vals = [field_fn(clat, clon, F((j + 0.5) / num_layers))
                  for j in range(num_layers)]
    lo = float(min(v.min() for v in layer_vals))
    hi = float(max(v.max() for v in layer_vals))
    if not hi > lo:
        hi = lo + 1.0
    value_q = np.zeros((n, lm), np.uint8)
    scale = F(255.0) / F(hi - lo)
    band_ranges_lo = np.full(num_bands, np.finfo(F).max, F)
    band_ranges_hi = np.full(num_bands, -np.finfo(F).max, F)
    edges = np.linspace(h_bot, h_top, num_bands + 1).astype(F)
    layer_h = thickness / num_layers
    for j, v in enumerate(layer_vals):
        q = np.clip(np.rint((v - F(lo)) * scale), 0, 255).astype(np.uint8)
        value_q[:, j] = q
        # dequantized layer range -> the radial bands this layer overlaps
        v_lo = lo + float(q.min()) * (hi - lo) / 255.0
        v_hi = lo + float(q.max()) * (hi - lo) / 255.0
        b0 = min(int((j * layer_h) / thickness * num_bands), num_bands - 1)
        b1 = min(int(((j + 1) * layer_h) / thickness * num_bands), num_bands - 1)
        band_ranges_lo[b0:b1 + 1] = np.minimum(band_ranges_lo[b0:b1 + 1], v_lo)
        band_ranges_hi[b0:b1 + 1] = np.maximum(band_ranges_hi[b0:b1 + 1], v_hi)

    # world bounds: sphere AABB inflated by the reference's outward bulge
    # correction (ref: icon_rt/ICONGrid.h:78-115 scales top vertices by
    # 1 + (r - |barycenter|)/r, i.e. by (2 - |mean corner unit vector|))
    m_min = float(np.sqrt(np.einsum(
        "fi,fi->f", tri.mean(axis=1), tri.mean(axis=1))).min())
    r_box = h_top * (2.0 - m_min)
    stats = CellStats(
        world_bounds_lo=np.array([-r_box, -r_box, -r_box], F),
        world_bounds_hi=np.array([r_box, r_box, r_box], F),
        spherical_bounds_lo=np.array([h_bot, lat.min(), lon.min()], F),
        spherical_bounds_hi=np.array([h_top, lat.max(), lon.max()], F),
        data_range=np.array([lo + 0.0, lo + (hi - lo)], F),
    )
    print(f"# bigscene: {n} cells built in {time.time() - t0:.1f}s",
          flush=True)
    return QuantScene(test12=test12, h_frac=np.ascontiguousarray(h_frac),
                      value_q=value_q, value_lo=lo, value_hi=hi,
                      lat=lat, lon=lon, band_edges=edges,
                      band_ranges=np.stack([band_ranges_lo, band_ranges_hi],
                                           axis=1), stats=stats)


def to_device(sc: QuantScene, device="cuda"):
    """(QuantizedCells, RadialBands) of a host scene on `device`: unpacked
    tables, one shared h_frac row where the layer spacing is uniform, and
    alpha_q all zero (bake it with models/qcells.bake_alpha_q)."""
    from ..models.qcells import QuantizedCells, check_q_ceilings
    from ..models.shells import RadialBands
    hf = sc.h_frac
    if hf.shape[0] and bool((hf == hf[0]).all()):
        hf = hf[:1]   # uniform layer spacing: one shared row
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    f32 = lambda v: torch.tensor(float(np.float32(v)), dtype=torch.float32,
                                 device=device)
    value_q = t(sc.value_q)
    q = QuantizedCells(test12=t(sc.test12[:, :12]),
                       h_frac=t(hf.astype(np.float32)), value_q=value_q,
                       alpha_q=torch.zeros_like(value_q),
                       value_lo=f32(sc.value_lo), value_hi=f32(sc.value_hi),
                       alpha_max=f32(1.0))
    check_q_ceilings(q.h_frac, q.test12)
    bands = RadialBands(edges=t(sc.band_edges), value_ranges=t(sc.band_ranges),
                        max_opacities=torch.zeros(sc.band_ranges.shape[0],
                                                  dtype=torch.float32,
                                                  device=device))
    return q, bands


def locator_cache_path(cache_key: str, dims_scale: float = 1.0) -> str:
    """npz cache location of the dense locator bins."""
    suffix = "" if dims_scale == 1.0 else f"_x{dims_scale:g}"
    return os.path.join(CACHE_DIR, f"qloc_{cache_key}{suffix}.npz")


def finemap_cache_path(cache_key: str, factor: int) -> str:
    return os.path.join(CACHE_DIR, f"fmap_{cache_key}_f{factor}.npz")


def _save_npz(path: str, **arrays):
    """Write an npz atomically (a private file renamed into place)."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


_WINDOW = ("lat_lo", "lat_hi", "lon_lo", "lon_hi")


def build_finemap_cached(loc, test12, factor: int,
                         cache_key: str | None = None):
    """models/finemap.build_finemap through the npz cache: a hit loads the
    map onto the locator's device, a miss builds it (K7-fm on a CUDA
    locator) and stores it.  Without a cache_key it always builds."""
    from ..models.finemap import FineMap, build_finemap

    dev = loc.bins.device
    path = finemap_cache_path(cache_key, factor) if cache_key else None
    if path and os.path.exists(path):
        z = np.load(path)
        f32 = lambda k: torch.tensor(float(z[k]), dtype=torch.float32,
                                     device=dev)
        return FineMap(slots=torch.from_numpy(z["slots"]).to(dev),
                       **{k: f32(k) for k in _WINDOW},
                       dims=torch.from_numpy(z["dims"]).to(dev))
    fm = build_finemap(loc, test12, factor=factor)
    if path:
        _save_npz(path, slots=fm.slots.cpu().numpy(),
                  dims=fm.dims.cpu().numpy(),
                  **{k: float(getattr(fm, k)) for k in _WINDOW})
    return fm


def build_locator_csr_from_scene(sc, cache_key: str | None = None,
                                 dims_scale: float = 1.0):
    """Dense locator of a scene from its corner lat/lon (a QuantScene's
    numpy arrays, or a device_scene.DeviceScene's tensors); returns
    (Locator, k_cap).  The bins are those of models/locator.py
    `densify_csr(build_locator_csr(...))` at sqrt(N/2) bins per axis times
    dims_scale: K7-loc bins CUDA lat/lon on the card, the plain version
    bins CPU tensors and numpy arrays.  cache_key npz-caches the bins."""
    from ..models.locator import Locator, bin_locator

    path = locator_cache_path(cache_key, dims_scale) if cache_key else None
    lat, lon = sc.lat, sc.lon
    if isinstance(lat, np.ndarray):
        lat, lon = torch.from_numpy(lat), torch.from_numpy(lon)
    dev = lat.device
    if path and os.path.exists(path):
        z = np.load(path)
        f32 = lambda k: torch.tensor(float(z[k]), dtype=torch.float32,
                                     device=dev)
        loc = Locator(bins=torch.from_numpy(z["bins"]).to(dev),
                      **{k: f32(k) for k in _WINDOW},
                      dims=torch.from_numpy(z["dims"]).to(dev))
        return loc, int(z["k_cap"])
    loc, k_cap = bin_locator(lat.contiguous(), lon.contiguous(),
                             dims_scale=dims_scale)[:2]
    if path:
        _save_npz(path, bins=loc.bins.cpu().numpy(), k_cap=k_cap,
                  dims=loc.dims.cpu().numpy(),
                  **{k: float(getattr(loc, k)) for k in _WINDOW})
    return loc, k_cap


def build_q_scene(subdiv: int, num_layers: int, *, device="cuda",
                  finemap_factor: int = 2, field_lod: int = 0,
                  cache: bool = False, timings: dict | None = None):
    """The quantized north-star scene, built on `device` (the card unless
    the caller asks for the CPU): the device scene (K7-scene) -> alpha bake
    (K5c-q) -> band majorants (K5b) -> locator binned from the scene's own
    corners (K7-loc) -> fine map (K7-fm).  The counterpart of the JAX
    bench's `_build_q_scene`.  Returns (q, loc, k_cap, bands, tf, stats,
    fm, lod, eff).

    field_lod > 0 renders the scene's level-`field_lod` mip tier (the
    bench's auto-LOD, data/lod.py `frame_lod`): subdivision-eff geometry,
    eff = subdiv - lod, each column's field pooled over its 4**lod
    subdivision-`subdiv` descendants; the locator and the fine map are
    those of the subdivision-eff geometry.

    The pre-bake all-zero alpha_q is dropped before the locator is binned
    and the corners' lat/lon right after it, before the fine map is
    built.
    cache: the locator and the fine map go through the npz caches
    (build_*_cached) under the key f"s{eff}_l{num_layers}": both are
    functions of the geometry alone, so a mip tier shares the plain
    subdivision-eff scene's, as bench.py:422-424 does.
    timings: when a dict, each phase's seconds (the device synchronised at
    its end) and the device's peak memory after it are stored in it."""
    from ..models.qcells import bake_alpha_q
    from ..models.shells import update_band_majorants
    from ..models.transfunc import make_transfunc
    from .device_scene import synth_quantized_device

    dev = torch.device(device)
    t = [time.perf_counter()]

    def mark(name):
        if timings is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t.append(time.perf_counter())
        timings[name] = t[-1] - t[-2]
        if dev.type == "cuda":
            timings[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    if not 0 <= field_lod < subdiv:
        raise ValueError(f"build_q_scene: field_lod must be in [0, {subdiv})")
    eff = subdiv - field_lod
    cache_key = f"s{eff}_l{num_layers}" if cache else None
    dsc = synth_quantized_device(eff, num_layers, device=dev, latlon=True,
                                 field_lod=field_lod)
    mark("scene")
    stats = dsc.stats
    tf = make_transfunc(value_range=tuple(stats.data_range), device=dev)
    q = bake_alpha_q(dsc.cells, tf)
    bands = update_band_majorants(dsc.bands, tf.values, tf.value_range)
    mark("bake")
    corners = dsc._replace(cells=None, bands=None)
    del dsc          # the zero alpha_q (1.3 GB at R2B9)
    loc, k_cap = build_locator_csr_from_scene(corners, cache_key=cache_key)
    del corners      # the corners (2 GB at R2B9)
    mark("locator")
    fm = None
    if finemap_factor:
        fm = build_finemap_cached(loc, q.test12, factor=finemap_factor,
                                  cache_key=cache_key)
    mark("finemap")
    return q, loc, k_cap, bands, tf, stats, fm, field_lod, eff
