"""Device-side synthetic scene generation: the quantized scene built on the
card, with no host tables and no upload.

The synthetic scene is procedural: cell i of a subdivision-s icosphere is

    base face  = i % 20
    child path = base-4 digits of i // 20   (LSB = first subdivision)

so every cell's corner triangle is s steps of midpoint-subdivision
arithmetic from a 20-triangle constant.  This module evaluates the
construction of data/bigscene.synth_quantized (geometry, banded-wave field,
u8 quantization, radial band ranges) on the device, into this package's
unpacked tables: test12 (N, 12) f32 and value_q (N, Lm) u8.

Fidelity: the arithmetic mirrors bigscene.synth_quantized step for step
(the same subdivision recurrence with all rows renormalized, the same plane
construction, the same rint quantization).  Device transcendentals can
differ from numpy's by ~1 ULP, so single u8 levels may differ by +-1; every
derived aggregate (value range, band ranges, bounds) is computed from the
device tables themselves, so majorant conservativeness holds by
construction.

Kernel of this module:

  K7-scene `scene_pass1`, `scene_pass2` (CUDA C++, csrc/scene.cu), one
     thread per cell; they replace the XLA-fused
     icon_rt_tpu/data/device_scene.py `_cell_corners`, `_orient_ccw`,
     `_default_field_jnp` and the two passes of `synth_quantized_device`.
     Plain versions: `_scene_pass1_torch`, `_scene_pass2_torch`, which take
     any index window of the scene.  The TPU build's 128-lane table packing,
     its chunk arithmetic and its donated merge are not ported: the tables
     are unpacked and have no pad rows.

  With field_lod > 0 the same two passes build a value-space mip tier (the
  JAX `field_chunk` and `_field_of_tri` of `synth_quantized_device`):
  geometry stays the subdivision-s cell's, and each layer's value is the
  mean of the clipped field over the cell's 4**lod descendants at
  subdivision s + lod, { p + m * n : m < 4**lod } (data/lod.py).  The
  descendant corners are not oriented (the reference's `field_chunk` skips
  `_orient_ccw`; the corner order moves the f32 centroid by an ULP), the
  sum runs over m in order and is then multiplied by f32(1 / 4**lod).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..models.cells import CellStats
from ..models.qcells import QuantizedCells
from ..models.shells import RadialBands
from ..utils import cuda_build
from .bigscene import _ICO_FACES, _ICO_VERTS
from .synthetic import EARTH_RADIUS

F32 = torch.float32

#: K7-scene kernel launches (the wrappers count only CUDA launches)
launches = {"scene_pass1": 0, "scene_pass2": 0, "scene_lod_pass1": 0,
            "scene_lod_pass2": 0}

#: cells per chunk of the plain versions
_CHUNK = 1 << 21

#: the pass-1 aggregates, in order
AGG = ("v_min", "v_max", "m_min", "lat_min", "lat_max", "lon_min", "lon_max")


def _base_triangles() -> np.ndarray:
    verts = _ICO_VERTS / np.linalg.norm(_ICO_VERTS, axis=1, keepdims=True)
    return verts[_ICO_FACES].astype(np.float32)     # (20, 3, 3)


def _default_field(lat, lon, h_factor):
    """Tensor twin of synthetic._default_field (banded waves, height decay),
    with the height term passed as its factor 1 - 0.5 * h_rel."""
    w = 0.5 + 0.35 * torch.sin(3.0 * lon) * torch.cos(2.0 * lat) \
        + 0.15 * torch.cos(7.0 * lat)
    return torch.clamp(w[:, None] * h_factor[None, :], 0.0, 1.0)


def _layer_factors(num_layers: int) -> np.ndarray:
    """(num_layers,) f32 height factors 1 - 0.5 * h_rel, h_rel the layer
    centre's relative height, computed in f32 as the reference's field."""
    return np.array([np.float32(1.0) - np.float32(0.5)
                     * np.float32((j + 0.5) / num_layers)
                     for j in range(num_layers)], np.float32)


def _cell_corners(idx, subdivisions: int, base_tri):
    """(M,) int64 cell indices -> three (M, 3) f32 unit corner vectors.

    Child digit d_k of i // 20 (LSB first) selects, at step k, one of
      0:(a, ab, ca)  1:(ab, b, bc)  2:(ca, bc, c)  3:(ab, bc, ca)
    with all three rows renormalized each step (the host code divides every
    vertex by its norm at every level, so this does too)."""
    tri = base_tri[idx % 20]
    rest = idx // 20
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    for k in range(subdivisions):
        d = ((rest >> (2 * k)) & 3)[:, None]
        ab, bc, ca = a + b, b + c, c + a
        v0 = torch.where(d == 0, a, torch.where(d == 2, ca, ab))
        v1 = torch.where(d == 0, ab, torch.where(d == 1, b, bc))
        v2 = torch.where(d == 2, c, torch.where(d == 1, bc, ca))
        a, b, c = (v / torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                                  + v[:, 2] * v[:, 2])[:, None]
                   for v in (v0, v1, v2))
    return a, b, c


def _mean3(a, b, c, three):
    """(a + b + c) / 3 in that order, divided by a tensor (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal)."""
    return (a + b + c) / three


def _cross(u, v):
    """u x v of (M, 3) rows, one rounded operation at a time."""
    return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                        u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                        u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)


def _orient_ccw(a, b, c, three):
    """Swap corners 1 <-> 2 where the triangle is clockwise seen from
    outside (the host synthesizer's predicate)."""
    n = _cross(b - a, c - a)
    m = _mean3(a, b, c, three)
    cw = (n[:, 0] * m[:, 0] + n[:, 1] * m[:, 1] + n[:, 2] * m[:, 2]
          < 0.0)[:, None]
    return a, torch.where(cw, c, b), torch.where(cw, b, c)


class _Consts:
    """The scene's constants on one device; `lod` > 0 pools each cell's
    field over its 4**lod descendants at subdivision `subdivisions + lod`."""

    def __init__(self, subdivisions, num_layers, radius, thickness, device,
                 lod: int = 0):
        self.subdivisions, self.num_layers = subdivisions, num_layers
        self.lod = lod
        self.n = 20 * 4 ** subdivisions
        self.lm = max(8, -(-num_layers // 8) * 8)
        self.base = _base_triangles()
        self.factors = _layer_factors(num_layers)
        self.h_bot = np.float32(radius)
        self.h_top = np.float32(radius + thickness)
        self.device = torch.device(device)

    def tensors(self):
        dev = self.device
        return (torch.from_numpy(self.base).to(dev),
                torch.from_numpy(self.factors).to(dev),
                torch.tensor(3.0, dtype=F32, device=dev))


def _centroid_field(tri, factors, three):
    """Corner lat/lon of (M, 3, 3) corners and the (M, nl) clipped field at
    their centroid (the reference's `_field_of_tri`)."""
    lat = torch.asin(torch.clamp(tri[..., 2], -1.0, 1.0))
    lon = torch.atan2(tri[..., 1], tri[..., 0])
    clat = _mean3(lat[:, 0], lat[:, 1], lat[:, 2], three)
    s, co = torch.sin(lon), torch.cos(lon)
    clon = torch.atan2(_mean3(s[:, 0], s[:, 1], s[:, 2], three),
                       _mean3(co[:, 0], co[:, 1], co[:, 2], three))
    return lat, lon, _default_field(clat, clon, factors)


def _window_cells(c: _Consts, start: int, stop: int, base, factors, three):
    """Oriented corners, corner lat/lon and the (M, nl) field of the cells
    [start, stop); with c.lod > 0 the field is the mean over each cell's
    4**lod descendants (unoriented corners, summed in order, then scaled)."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=c.device)
    a, b, cc = _orient_ccw(*_cell_corners(idx, c.subdivisions, base), three)
    tri = torch.stack([a, b, cc], dim=1)                        # (M, 3, 3)
    lat, lon, v = _centroid_field(tri, factors, three)
    if c.lod:
        # every descendant at once, (4**lod, M) in m-major order; the sum
        # then runs over m in order
        members = 4 ** c.lod
        m = torch.arange(members, dtype=torch.int64, device=c.device)
        fine = (idx[None, :] + m[:, None] * c.n).reshape(-1)
        tri_f = torch.stack(_cell_corners(fine, c.subdivisions + c.lod,
                                          base), dim=1)
        v_all = _centroid_field(tri_f, factors, three)[2].reshape(
            members, idx.shape[0], -1)
        v = v_all[0]
        for k in range(1, members):
            v = v + v_all[k]
        v = v * torch.tensor(1.0 / members, dtype=F32, device=c.device)
    return tri, lat, lon, v


def _chunk(c: _Consts) -> int:
    """Cells per chunk of the plain versions (a pooled cell walks 4**lod
    descendants)."""
    return max(1024, _CHUNK >> (2 * c.lod))


def _scene_pass1_torch(c: _Consts, start: int, count: int) -> torch.Tensor:
    """Plain K7-scene pass 1 over the cells [start, start + count): the (7,)
    f32 aggregates named by AGG."""
    base, factors, three = c.tensors()
    inf = float("inf")
    out = torch.tensor([inf, -inf, inf, inf, -inf, inf, -inf], dtype=F32,
                       device=c.device)
    step = _chunk(c)
    for s0 in range(start, start + count, step):
        s1 = min(s0 + step, start + count)
        tri, lat, lon, v = _window_cells(c, s0, s1, base, factors, three)
        m = _mean3(tri[:, 0], tri[:, 1], tri[:, 2], three)
        mag = torch.sqrt(m[:, 0] * m[:, 0] + m[:, 1] * m[:, 1]
                         + m[:, 2] * m[:, 2])
        part = torch.stack([v.min(), v.max(), mag.min(), lat.min(),
                            lat.max(), lon.min(), lon.max()])
        out = torch.where(torch.tensor([0, 1, 0, 0, 1, 0, 1], dtype=torch.bool,
                                       device=c.device),
                          torch.maximum(out, part), torch.minimum(out, part))
    return out


def _scene_pass2_torch(c: _Consts, start: int, count: int, lo: float,
                       scale: float, latlon: bool):
    """Plain K7-scene pass 2 over the cells [start, start + count): (test12
    (count, 12) f32, value_q (count, lm) u8, qmin (nl,) i32, qmax (nl,) i32,
    lat, lon (count, 3) f32 or None)."""
    base, factors, three = c.tensors()
    dev, nl = c.device, c.num_layers
    test12 = torch.empty((count, 12), dtype=F32, device=dev)
    value_q = torch.zeros((count, c.lm), dtype=torch.uint8, device=dev)
    lat_o = torch.empty((count, 3), dtype=F32, device=dev) if latlon else None
    lon_o = torch.empty((count, 3), dtype=F32, device=dev) if latlon else None
    qmin = torch.full((nl,), 255, dtype=torch.int32, device=dev)
    qmax = torch.zeros((nl,), dtype=torch.int32, device=dev)
    lo_t = torch.tensor(lo, dtype=F32, device=dev)
    scale_t = torch.tensor(scale, dtype=F32, device=dev)
    step = _chunk(c)
    for s0 in range(start, start + count, step):
        s1 = min(s0 + step, start + count)
        r = slice(s0 - start, s1 - start)
        tri, lat, lon, v = _window_cells(c, s0, s1, base, factors, three)
        for e, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
            a = tri[:, i] * float(c.h_bot)
            b = tri[:, j] * float(c.h_bot)
            cc = tri[:, j] * float(c.h_top)
            test12[r, 3 * e:3 * e + 3] = _cross(b - a, cc - a)
        test12[r, 9] = float(c.h_bot)
        test12[r, 10] = float(c.h_top)
        test12[r, 11] = float(nl)
        q = torch.clamp(torch.round((v - lo_t) * scale_t), 0, 255) \
            .to(torch.uint8)
        value_q[r, :nl] = q
        qmin = torch.minimum(qmin, q.amin(0).to(torch.int32))
        qmax = torch.maximum(qmax, q.amax(0).to(torch.int32))
        if latlon:
            lat_o[r] = lat
            lon_o[r] = lon
    return test12, value_q, qmin, qmax, lat_o, lon_o


# ---------------------------------------------------------------------------
# K7-scene: build, bind, launch
# ---------------------------------------------------------------------------

class _SceneParams(ctypes.Structure):
    """Mirror of `SceneParams` in csrc/scene.cu (same field order)."""
    _fields_ = [
        ("base", ctypes.c_float * 180), ("layer_f", ctypes.c_float * 32),
        ("test12", ctypes.c_void_p), ("value_q", ctypes.c_void_p),
        ("lat", ctypes.c_void_p), ("lon", ctypes.c_void_p),
        ("agg", ctypes.c_void_p),
        ("h_bot", ctypes.c_float), ("h_top", ctypes.c_float),
        ("nl_f", ctypes.c_float), ("lo", ctypes.c_float),
        ("scale", ctypes.c_float),
        ("start", ctypes.c_longlong), ("count", ctypes.c_longlong),
        ("n_cells", ctypes.c_longlong),
        ("subdivisions", ctypes.c_int), ("num_layers", ctypes.c_int),
        ("lm", ctypes.c_int), ("lod", ctypes.c_int),
    ]


def build_scene_kernel():
    """Compile csrc/scene.cu for sm_90a and bind its entry points."""
    lib = cuda_build.build("scene")
    for fn in (lib.scene_pass1_launch, lib.scene_pass2_launch):
        fn.argtypes = [ctypes.POINTER(_SceneParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _params(c: _Consts, start: int, count: int, **ptrs) -> _SceneParams:
    f = np.zeros(32, np.float32)
    f[:c.num_layers] = c.factors
    return _SceneParams(
        base=(ctypes.c_float * 180)(*c.base.ravel().tolist()),
        layer_f=(ctypes.c_float * 32)(*f.tolist()),
        h_bot=float(c.h_bot), h_top=float(c.h_top),
        nl_f=float(c.num_layers), start=start, count=count, n_cells=c.n,
        subdivisions=c.subdivisions, num_layers=c.num_layers, lm=c.lm,
        lod=c.lod, **ptrs)


def _check_window(fn, c: _Consts, start: int, count: int):
    if not 1 <= c.num_layers <= 32:
        raise ValueError(f"{fn}: num_layers must be 1..32")
    if start < 0 or count < 0 or start + count > c.n:
        raise ValueError(f"{fn}: cells [{start}, {start + count}) lie outside "
                         f"the scene's {c.n}")
    if c.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {c.device}")
    if c.lod < 0:
        raise ValueError(f"{fn}: field_lod must be >= 0")


def _count(name: str, c: _Consts):
    launches[f"scene_lod_{name}" if c.lod else f"scene_{name}"] += 1


def _decode(keys: torch.Tensor) -> torch.Tensor:
    """Order-preserving u32 keys (held in int64) -> f32 values."""
    bits = torch.where(keys >= 0x80000000, keys & 0x7FFFFFFF,
                       (~keys) & 0xFFFFFFFF)
    return bits.to(torch.int32).view(F32)


def scene_pass1(c: _Consts, start: int = 0, count: int | None = None):
    """K7-scene wrapper, pass 1: the (7,) f32 aggregates (AGG) of the cells
    [start, start + count), the field pooled when c.lod > 0.  A CUDA device
    launches csrc/scene.cu, the CPU runs `_scene_pass1_torch`."""
    count = c.n - start if count is None else count
    _check_window("scene_pass1", c, start, count)
    if c.device.type == "cpu":
        return _scene_pass1_torch(c, start, count)
    lib = build_scene_kernel()
    init = [0xFFFFFFFF, 0, 0xFFFFFFFF, 0xFFFFFFFF, 0, 0xFFFFFFFF, 0]
    agg = torch.tensor(init, dtype=torch.int64).to(torch.int32) \
        .to(c.device)
    p = _params(c, start, count, agg=agg.data_ptr())
    cuda_build.check("scene_pass1", lib.scene_pass1_launch(
        ctypes.byref(p), torch.cuda.current_stream(c.device).cuda_stream))
    _count("pass1", c)
    return _decode(agg.to(torch.int64) & 0xFFFFFFFF)


def scene_pass2(c: _Consts, lo: float, scale: float, start: int = 0,
                count: int | None = None, latlon: bool = False):
    """K7-scene wrapper, pass 2: (test12 (count, 12) f32, value_q (count,
    lm) u8, qmin (nl,) i32, qmax (nl,) i32, lat, lon (count, 3) f32 or
    None) of the cells [start, start + count), quantized as clip(rint((v -
    lo) * scale), 0, 255), v pooled when c.lod > 0.  A CUDA device launches
    csrc/scene.cu, the CPU runs `_scene_pass2_torch`."""
    count = c.n - start if count is None else count
    _check_window("scene_pass2", c, start, count)
    if c.device.type == "cpu":
        return _scene_pass2_torch(c, start, count, lo, scale, latlon)
    lib = build_scene_kernel()
    dev, nl = c.device, c.num_layers
    test12 = torch.empty((count, 12), dtype=F32, device=dev)
    value_q = torch.zeros((count, c.lm), dtype=torch.uint8, device=dev)
    lat = torch.empty((count, 3), dtype=F32, device=dev) if latlon else None
    lon = torch.empty((count, 3), dtype=F32, device=dev) if latlon else None
    agg = torch.cat([torch.full((nl,), 255, dtype=torch.int32),
                     torch.zeros(nl, dtype=torch.int32)]).to(dev)
    p = _params(c, start, count, test12=test12.data_ptr(),
                value_q=value_q.data_ptr(),
                lat=lat.data_ptr() if latlon else None,
                lon=lon.data_ptr() if latlon else None,
                agg=agg.data_ptr(), lo=lo, scale=scale)
    cuda_build.check("scene_pass2", lib.scene_pass2_launch(
        ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream))
    _count("pass2", c)
    return test12, value_q, agg[:nl], agg[nl:], lat, lon


# ---------------------------------------------------------------------------
# The scene
# ---------------------------------------------------------------------------

class DeviceScene(NamedTuple):
    """The device twin of bigscene.QuantScene: unpacked tables on one
    device.  lat/lon are the oriented corners' (N, 3) f32 latitudes and
    longitudes, written only when a locator is to be binned from them."""
    cells: QuantizedCells
    bands: RadialBands       # majorants zeroed
    stats: CellStats
    lat: torch.Tensor | None = None
    lon: torch.Tensor | None = None


def quant_scale(lo: float, hi: float) -> np.float32:
    """255 / (hi - lo), computed in f32 as the reference's pass 2."""
    return np.float32(255.0) / (np.float32(hi) - np.float32(lo))


def synth_quantized_device(subdivisions: int, num_layers: int,
                           radius: float = float(EARTH_RADIUS),
                           thickness: float = 3.0e4,
                           num_bands: int = 64,
                           field_lod: int = 0,
                           device="cuda",
                           latlon: bool = False) -> DeviceScene:
    """Build the quantized scene on `device` (the card unless the caller
    asks for the CPU): pass 1 for the value range and bounds, pass 2 for the
    tables and the per-layer u8 ranges the radial bands come from.  With
    `latlon` the corners' lat/lon are kept for a locator binning.

    field_lod > 0 builds the value-space mip tier (data/lod.py): the
    geometry of the subdivision-`subdivisions` icosphere, each cell's value
    the mean of the field over its 4**field_lod descendants at subdivision
    subdivisions + field_lod.  The value range, value_q and the per-layer
    u8 ranges behind the radial bands all take the pooled field."""
    if field_lod < 0:
        raise ValueError("synth_quantized_device: field_lod must be >= 0")
    c = _Consts(subdivisions, num_layers, radius, thickness, device,
                lod=field_lod)
    agg = dict(zip(AGG, scene_pass1(c).tolist()))
    lo, hi = agg["v_min"], agg["v_max"]
    if not hi > lo:
        hi = lo + 1.0
    test12, value_q, qmin, qmax, lat, lon = scene_pass2(
        c, lo, float(quant_scale(lo, hi)), latlon=latlon)

    # uniform layer spacing -> one shared h_frac row (host arithmetic, as
    # bigscene.synth_quantized)
    lm = c.lm
    k1 = np.arange(1, lm + 1)
    row = np.where(k1 <= num_layers,
                   np.clip(np.rint(k1 / num_layers * 65535.0), 0, 65535),
                   65535).astype(np.uint16)
    f32 = lambda v: torch.tensor(float(np.float32(v)), dtype=F32,
                                 device=device)
    q = QuantizedCells(
        test12=test12,
        h_frac=torch.from_numpy(row.astype(np.float32)[None, :]).to(device),
        value_q=value_q,
        alpha_q=torch.zeros_like(value_q),
        value_lo=f32(lo), value_hi=f32(hi), alpha_max=f32(1.0))

    # radial band ranges from the tables' own per-layer u8 extrema
    # (conservative for exactly the field the renderer samples)
    qmin_h = qmin.cpu().numpy().astype(np.float64)
    qmax_h = qmax.cpu().numpy().astype(np.float64)
    h_bot, h_top = c.h_bot, c.h_top
    edges = np.linspace(h_bot, h_top, num_bands + 1).astype(np.float32)
    br_lo = np.full(num_bands, np.finfo(np.float32).max, np.float32)
    br_hi = np.full(num_bands, -np.finfo(np.float32).max, np.float32)
    layer_h = thickness / num_layers
    for j in range(num_layers):
        v_lo = lo + float(qmin_h[j]) * (hi - lo) / 255.0
        v_hi = lo + float(qmax_h[j]) * (hi - lo) / 255.0
        b0 = min(int((j * layer_h) / thickness * num_bands), num_bands - 1)
        b1 = min(int(((j + 1) * layer_h) / thickness * num_bands),
                 num_bands - 1)
        br_lo[b0:b1 + 1] = np.minimum(br_lo[b0:b1 + 1], np.float32(v_lo))
        br_hi[b0:b1 + 1] = np.maximum(br_hi[b0:b1 + 1], np.float32(v_hi))
    bands = RadialBands(
        edges=torch.from_numpy(edges).to(device),
        value_ranges=torch.from_numpy(np.stack([br_lo, br_hi], axis=1)
                                      ).to(device),
        max_opacities=torch.zeros(num_bands, dtype=F32, device=device))

    r_box = float(h_top) * (2.0 - agg["m_min"])
    stats = CellStats(
        world_bounds_lo=np.array([-r_box, -r_box, -r_box], np.float32),
        world_bounds_hi=np.array([r_box, r_box, r_box], np.float32),
        spherical_bounds_lo=np.array([h_bot, agg["lat_min"], agg["lon_min"]],
                                     np.float32),
        spherical_bounds_hi=np.array([h_top, agg["lat_max"], agg["lon_max"]],
                                     np.float32),
        data_range=np.array([lo, hi], np.float32))
    return DeviceScene(cells=q, bands=bands, stats=stats, lat=lat, lon=lon)
