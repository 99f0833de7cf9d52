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

  K7-scene `scene_ancestors`, `scene_pass1`, `scene_pass2` (CUDA C++,
     csrc/scene.cu), one thread per cell; they replace the XLA-fused
     icon_rt_tpu/data/device_scene.py `_cell_corners`, `_orient_ccw`,
     `_default_field_jnp` and the two passes of `synth_quantized_device`.
     Pass 1 walks each cell once, from its stored depth-d ancestor (d =
     subdivisions - ANCESTOR_STEPS), and writes the geometry and the
     cell's field; pass 2 only quantizes, once pass 1's value range is
     known.  Plain versions: `_scene_ancestors_torch`,
     `_scene_pass1_torch`, `_scene_pass2_torch`, which take any index
     window of the scene.  The TPU build's 128-lane table packing, its
     chunk arithmetic and its donated merge are not ported: the tables are
     unpacked and have no pad rows.

  With field_lod > 0 the same passes build a value-space mip tier (the
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
from ..models.qcells import QuantizedCells, check_q_ceilings
from ..models.shells import RadialBands
from ..utils import cuda_build
from .bigscene import _ICO_FACES, _ICO_VERTS
from .synthetic import EARTH_RADIUS

F32 = torch.float32

#: K7-scene kernel launches (the wrappers count only CUDA launches)
launches = {"scene_ancestors": 0, "scene_pass1": 0, "scene_pass2": 0,
            "scene_lod_ancestors": 0, "scene_lod_pass1": 0,
            "scene_lod_pass2": 0}

#: cells per chunk of the plain versions
_CHUNK = 1 << 21

#: subdivision steps each cell walks from its stored ancestor: the ancestors
#: are the cells of depth max(subdivisions - ANCESTOR_STEPS, 0)
ANCESTOR_STEPS = 3

#: the pass-1 aggregates, in order
AGG = ("v_min", "v_max", "m_min", "lat_min", "lat_max", "lon_min", "lon_max")


def _base_triangles() -> np.ndarray:
    verts = _ICO_VERTS / np.linalg.norm(_ICO_VERTS, axis=1, keepdims=True)
    return verts[_ICO_FACES].astype(np.float32)     # (20, 3, 3)


def _field_term(lat, lon):
    """The banded-wave field before the height factor (synthetic.py
    `_default_field`): 0.5 + 0.35 sin(3 lon) cos(2 lat) + 0.15 cos(7 lat)."""
    return 0.5 + 0.35 * torch.sin(3.0 * lon) * torch.cos(2.0 * lat) \
        + 0.15 * torch.cos(7.0 * lat)


def _layer_values(w, h_factor):
    """(M, nl) clip(w * h_factor, 0, 1): the field's layers, the height
    term passed as its factor 1 - 0.5 * h_rel."""
    return torch.clamp(w[:, None] * h_factor[None, :], 0.0, 1.0)


def _layer_factors(num_layers: int) -> np.ndarray:
    """(num_layers,) f32 height factors 1 - 0.5 * h_rel, h_rel the layer
    centre's relative height, computed in f32 as the reference's field."""
    return np.array([np.float32(1.0) - np.float32(0.5)
                     * np.float32((j + 0.5) / num_layers)
                     for j in range(num_layers)], np.float32)


def _walk(a, b, c, digits, steps):
    """Corners (a, b, c), each (M, 3) f32, refined along the base-4 digits
    `digits` ((M,) int64, least significant first) at the steps `steps`.

    Child digit d of a step selects one of
      0:(a, ab, ca)  1:(ab, b, bc)  2:(ca, bc, c)  3:(ab, bc, ca)
    with all three rows renormalized each step (the host code divides every
    vertex by its norm at every level, so this does too)."""
    for k in steps:
        d = ((digits >> (2 * k)) & 3)[:, None]
        ab, bc, ca = a + b, b + c, c + a
        v0 = torch.where(d == 0, a, torch.where(d == 2, ca, ab))
        v1 = torch.where(d == 0, ab, torch.where(d == 1, b, bc))
        v2 = torch.where(d == 2, c, torch.where(d == 1, bc, ca))
        a, b, c = (v / torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                                  + v[:, 2] * v[:, 2])[:, None]
                   for v in (v0, v1, v2))
    return a, b, c


def _cell_corners(idx, subdivisions: int, base_tri):
    """(M,) int64 cell indices -> three (M, 3) f32 unit corner vectors: the
    base face idx % 20 walked along the digits of idx // 20."""
    tri = base_tri[idx % 20]
    return _walk(tri[:, 0], tri[:, 1], tri[:, 2], idx // 20,
                 range(subdivisions))


def _cell_corners_from(anc, idx, depth: int, subdivisions: int):
    """`_cell_corners` resumed from the stored ancestors: anc (20 * 4**depth,
    3, 3) are the walked corners of the depth-`depth` cells, and cell idx's
    ancestor is idx % (20 * 4**depth) -- the same face and the first depth
    digits -- so the walk goes on along the remaining digits only."""
    tri = anc[idx % anc.shape[0]]
    return _walk(tri[:, 0], tri[:, 1], tri[:, 2], idx // 20,
                 range(depth, subdivisions))


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
    field over its 4**lod descendants at subdivision `subdivisions + lod`.
    Cells walk from their ancestors of depth `anc_depth`."""

    def __init__(self, subdivisions, num_layers, radius, thickness, device,
                 lod: int = 0):
        self.subdivisions, self.num_layers = subdivisions, num_layers
        self.lod = lod
        self.n = 20 * 4 ** subdivisions
        self.lm = max(8, -(-num_layers // 8) * 8)
        self.anc_depth = max(subdivisions - ANCESTOR_STEPS, 0)
        self.n_anc = 20 * 4 ** self.anc_depth
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


class Pass1(NamedTuple):
    """K7-scene pass 1 of the cells [start, start + count): the 7
    aggregates (AGG), the geometry and each cell's field.  At lod 0 the
    first 4 bytes of each value_q row hold the cell's field term w (f32)
    until pass 2 quantizes the row over it; with lod > 0 `field` holds the
    pooled per-layer values."""
    agg: torch.Tensor                 # (7,) f32
    test12: torch.Tensor              # (count, 12) f32
    value_q: torch.Tensor             # (count, lm) u8
    field: torch.Tensor | None        # (count, nl) f32 (lod > 0)
    lat: torch.Tensor | None          # (count, 3) f32 (latlon)
    lon: torch.Tensor | None

    def field_term(self) -> torch.Tensor:
        """(count,) f32 view of the w stash (lod 0, before pass 2)."""
        return self.value_q.view(F32)[:, 0]


def _centroid_field(tri, factors, three):
    """Corner lat/lon of (M, 3, 3) corners, the field term w (M,) at their
    centroid and its (M, nl) clipped layers (the reference's
    `_field_of_tri`)."""
    lat = torch.asin(torch.clamp(tri[..., 2], -1.0, 1.0))
    lon = torch.atan2(tri[..., 1], tri[..., 0])
    clat = _mean3(lat[:, 0], lat[:, 1], lat[:, 2], three)
    s, co = torch.sin(lon), torch.cos(lon)
    clon = torch.atan2(_mean3(s[:, 0], s[:, 1], s[:, 2], three),
                       _mean3(co[:, 0], co[:, 1], co[:, 2], three))
    w = _field_term(clat, clon)
    return lat, lon, w, _layer_values(w, factors)


def _pooled_values(c: "_Consts", idx, base, factors, three):
    """(M, nl) mean of the clipped field over each cell's 4**lod
    descendants (unoriented corners, every descendant walked from its base
    face, summed over m in order, then scaled)."""
    members = 4 ** c.lod
    m = torch.arange(members, dtype=torch.int64, device=c.device)
    fine = (idx[None, :] + m[:, None] * c.n).reshape(-1)
    tri_f = torch.stack(_cell_corners(fine, c.subdivisions + c.lod, base),
                        dim=1)
    v_all = _centroid_field(tri_f, factors, three)[3].reshape(
        members, idx.shape[0], -1)
    v = v_all[0]
    for k in range(1, members):
        v = v + v_all[k]
    return v * torch.tensor(1.0 / members, dtype=F32, device=c.device)


def _chunk(c: _Consts) -> int:
    """Cells per chunk of the plain versions (a pooled cell walks 4**lod
    descendants)."""
    return max(1024, _CHUNK >> (2 * c.lod))


def _scene_ancestors_torch(c: _Consts, base) -> torch.Tensor:
    """Plain K7-scene `scene_ancestors`: (20 * 4**anc_depth, 3, 3) walked
    corners of the depth-anc_depth cells."""
    idx = torch.arange(c.n_anc, dtype=torch.int64, device=c.device)
    return torch.stack(_cell_corners(idx, c.anc_depth, base), dim=1)


def _scene_pass1_torch(c: _Consts, start: int, count: int,
                       latlon: bool = False) -> Pass1:
    """Plain K7-scene pass 1 over the cells [start, start + count): the
    aggregates, test12, the field (the w stash in value_q at lod 0, the
    pooled values otherwise) and, with `latlon`, the corners' lat/lon."""
    base, factors, three = c.tensors()
    dev, nl = c.device, c.num_layers
    inf = float("inf")
    agg = torch.tensor([inf, -inf, inf, inf, -inf, inf, -inf], dtype=F32,
                       device=dev)
    is_max = torch.tensor([0, 1, 0, 0, 1, 0, 1], dtype=torch.bool,
                          device=dev)
    test12 = torch.empty((count, 12), dtype=F32, device=dev)
    value_q = torch.zeros((count, c.lm), dtype=torch.uint8, device=dev)
    field = torch.empty((count, nl), dtype=F32, device=dev) if c.lod \
        else None
    lat_o = torch.empty((count, 3), dtype=F32, device=dev) if latlon else None
    lon_o = torch.empty((count, 3), dtype=F32, device=dev) if latlon else None
    anc = _scene_ancestors_torch(c, base)
    step = _chunk(c)
    for s0 in range(start, start + count, step):
        s1 = min(s0 + step, start + count)
        r = slice(s0 - start, s1 - start)
        idx = torch.arange(s0, s1, dtype=torch.int64, device=dev)
        a, b, cc = _orient_ccw(*_cell_corners_from(
            anc, idx, c.anc_depth, c.subdivisions), three)
        tri = torch.stack([a, b, cc], dim=1)                    # (M, 3, 3)
        lat, lon, w, v = _centroid_field(tri, factors, three)
        for e, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
            pa = tri[:, i] * float(c.h_bot)
            pb = tri[:, j] * float(c.h_bot)
            pc = tri[:, j] * float(c.h_top)
            test12[r, 3 * e:3 * e + 3] = _cross(pb - pa, pc - pa)
        test12[r, 9] = float(c.h_bot)
        test12[r, 10] = float(c.h_top)
        test12[r, 11] = float(nl)
        if c.lod:
            v = _pooled_values(c, idx, base, factors, three)
            field[r] = v
        else:
            value_q[r].view(F32)[:, 0] = w
        if latlon:
            lat_o[r] = lat
            lon_o[r] = lon
        m = _mean3(tri[:, 0], tri[:, 1], tri[:, 2], three)
        mag = torch.sqrt(m[:, 0] * m[:, 0] + m[:, 1] * m[:, 1]
                         + m[:, 2] * m[:, 2])
        part = torch.stack([v.min(), v.max(), mag.min(), lat.min(),
                            lat.max(), lon.min(), lon.max()])
        agg = torch.where(is_max, torch.maximum(agg, part),
                          torch.minimum(agg, part))
    return Pass1(agg, test12, value_q, field, lat_o, lon_o)


def _scene_pass2_torch(c: _Consts, p1: Pass1, lo: float, scale: float):
    """Plain K7-scene pass 2 over pass 1's cells: quantizes p1.value_q IN
    PLACE (over the w stash) as clip(rint((v - lo) * scale), 0, 255);
    returns (test12 (count, 12) f32, value_q (count, lm) u8, qmin (nl,)
    i32, qmax (nl,) i32, lat, lon (count, 3) f32 or None)."""
    _, factors, _ = c.tensors()
    dev, nl = c.device, c.num_layers
    count = p1.test12.shape[0]
    qmin = torch.full((nl,), 255, dtype=torch.int32, device=dev)
    qmax = torch.zeros((nl,), dtype=torch.int32, device=dev)
    lo_t = torch.tensor(lo, dtype=F32, device=dev)
    scale_t = torch.tensor(scale, dtype=F32, device=dev)
    step = _chunk(c)
    for s0 in range(0, count, step):
        r = slice(s0, min(s0 + step, count))
        v = p1.field[r] if c.lod else _layer_values(
            p1.value_q[r].view(F32)[:, 0].clone(), factors)
        q = torch.clamp(torch.round((v - lo_t) * scale_t), 0, 255) \
            .to(torch.uint8)
        p1.value_q[r] = 0
        p1.value_q[r, :nl] = q
        qmin = torch.minimum(qmin, q.amin(0).to(torch.int32))
        qmax = torch.maximum(qmax, q.amax(0).to(torch.int32))
    return p1.test12, p1.value_q, qmin, qmax, p1.lat, p1.lon


def _scene_window_torch(c: _Consts, start: int, count: int, lo: float,
                        scale: float, latlon: bool):
    """The plain passes over one index window: pass 2's tuple."""
    return _scene_pass2_torch(c, _scene_pass1_torch(c, start, count, latlon),
                              lo, scale)


# ---------------------------------------------------------------------------
# K7-scene: build, bind, launch
# ---------------------------------------------------------------------------

class _SceneParams(ctypes.Structure):
    """Mirror of `SceneParams` in csrc/scene.cu (same field order)."""
    _fields_ = [
        ("base", ctypes.c_float * 180), ("layer_f", ctypes.c_float * 32),
        ("anc", ctypes.c_void_p),
        ("test12", ctypes.c_void_p), ("value_q", ctypes.c_void_p),
        ("field", ctypes.c_void_p),
        ("lat", ctypes.c_void_p), ("lon", ctypes.c_void_p),
        ("agg", ctypes.c_void_p),
        ("h_bot", ctypes.c_float), ("h_top", ctypes.c_float),
        ("nl_f", ctypes.c_float), ("lo", ctypes.c_float),
        ("scale", ctypes.c_float),
        ("start", ctypes.c_longlong), ("count", ctypes.c_longlong),
        ("n_cells", ctypes.c_longlong), ("n_anc", ctypes.c_longlong),
        ("subdivisions", ctypes.c_int), ("num_layers", ctypes.c_int),
        ("lm", ctypes.c_int), ("lod", ctypes.c_int),
        ("anc_depth", ctypes.c_int),
    ]


def build_scene_kernel():
    """Compile csrc/scene.cu for sm_90a and bind its entry points."""
    lib = cuda_build.build("scene")
    for fn in (lib.scene_ancestors_launch, lib.scene_pass1_launch,
               lib.scene_pass2_launch):
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
        n_anc=c.n_anc, subdivisions=c.subdivisions,
        num_layers=c.num_layers, lm=c.lm, lod=c.lod,
        anc_depth=c.anc_depth, **ptrs)


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


def scene_pass1(c: _Consts, start: int = 0, count: int | None = None,
                latlon: bool = False) -> Pass1:
    """K7-scene wrapper, pass 1, over the cells [start, start + count): the
    ancestors' launch, then each cell walked once (see `Pass1`; the field
    pooled when c.lod > 0).  A CUDA device launches csrc/scene.cu, the CPU
    runs `_scene_pass1_torch`."""
    count = c.n - start if count is None else count
    _check_window("scene_pass1", c, start, count)
    if c.device.type == "cpu":
        return _scene_pass1_torch(c, start, count, latlon)
    lib = build_scene_kernel()
    dev, nl = c.device, c.num_layers
    stream = torch.cuda.current_stream(dev).cuda_stream
    anc = torch.empty((c.n_anc, 9), dtype=F32, device=dev)
    cuda_build.check("scene_ancestors", lib.scene_ancestors_launch(
        ctypes.byref(_params(c, start, count, anc=anc.data_ptr())), stream))
    _count("ancestors", c)
    test12 = torch.empty((count, 12), dtype=F32, device=dev)
    value_q = torch.empty((count, c.lm), dtype=torch.uint8, device=dev)
    field = torch.empty((count, nl), dtype=F32, device=dev) if c.lod \
        else None
    lat = torch.empty((count, 3), dtype=F32, device=dev) if latlon else None
    lon = torch.empty((count, 3), dtype=F32, device=dev) if latlon else None
    init = [0xFFFFFFFF, 0, 0xFFFFFFFF, 0xFFFFFFFF, 0, 0xFFFFFFFF, 0]
    agg = torch.tensor(init, dtype=torch.int64).to(torch.int32).to(dev)
    p = _params(c, start, count, anc=anc.data_ptr(),
                test12=test12.data_ptr(), value_q=value_q.data_ptr(),
                field=None if field is None else field.data_ptr(),
                lat=lat.data_ptr() if latlon else None,
                lon=lon.data_ptr() if latlon else None, agg=agg.data_ptr())
    cuda_build.check("scene_pass1", lib.scene_pass1_launch(
        ctypes.byref(p), stream))
    _count("pass1", c)
    return Pass1(_decode(agg.to(torch.int64) & 0xFFFFFFFF), test12, value_q,
                 field, lat, lon)


def scene_pass2(c: _Consts, p1: Pass1, lo: float, scale: float):
    """K7-scene wrapper, pass 2: quantizes pass 1's cells as clip(rint((v -
    lo) * scale), 0, 255) into p1.value_q IN PLACE (over the w stash);
    returns (test12 (count, 12) f32, value_q (count, lm) u8, qmin (nl,)
    i32, qmax (nl,) i32, lat, lon (count, 3) f32 or None).  A CUDA device
    launches csrc/scene.cu, the CPU runs `_scene_pass2_torch`."""
    if c.device.type == "cpu":
        return _scene_pass2_torch(c, p1, lo, scale)
    if c.device.type != "cuda":
        raise ValueError(f"scene_pass2: unsupported device {c.device}")
    lib = build_scene_kernel()
    dev, nl = c.device, c.num_layers
    count = p1.test12.shape[0]
    if tuple(p1.value_q.shape) != (count, c.lm) or (
            c.lod and tuple(p1.field.shape) != (count, nl)):
        raise ValueError("scene_pass2: pass 1's tables do not fit the scene")
    agg = torch.cat([torch.full((nl,), 255, dtype=torch.int32),
                     torch.zeros(nl, dtype=torch.int32)]).to(dev)
    p = _params(c, 0, count, value_q=p1.value_q.data_ptr(),
                field=None if p1.field is None else p1.field.data_ptr(),
                agg=agg.data_ptr(), lo=lo, scale=scale)
    cuda_build.check("scene_pass2", lib.scene_pass2_launch(
        ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream))
    _count("pass2", c)
    return p1.test12, p1.value_q, agg[:nl], agg[nl:], p1.lat, p1.lon


def scene_window(c: _Consts, start: int, count: int, lo: float,
                 scale: float, latlon: bool = False):
    """Both passes over one index window [start, start + count), quantized
    with the given range: pass 2's tuple (the kernels on a CUDA device)."""
    return scene_pass2(c, scene_pass1(c, start, count, latlon), lo, scale)


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
    asks for the CPU): pass 1 for the geometry, the field, the value range
    and the bounds, pass 2 for the u8 values and the per-layer u8 ranges
    the radial bands come from.  With `latlon` the corners' lat/lon are
    kept for a locator binning.

    field_lod > 0 builds the value-space mip tier (data/lod.py): the
    geometry of the subdivision-`subdivisions` icosphere, each cell's value
    the mean of the field over its 4**field_lod descendants at subdivision
    subdivisions + field_lod.  The value range, value_q and the per-layer
    u8 ranges behind the radial bands all take the pooled field."""
    if field_lod < 0:
        raise ValueError("synth_quantized_device: field_lod must be >= 0")
    c = _Consts(subdivisions, num_layers, radius, thickness, device,
                lod=field_lod)
    p1 = scene_pass1(c, latlon=latlon)
    agg = dict(zip(AGG, p1.agg.tolist()))
    lo, hi = agg["v_min"], agg["v_max"]
    if not hi > lo:
        hi = lo + 1.0
    test12, value_q, qmin, qmax, lat, lon = scene_pass2(
        c, p1, lo, float(quant_scale(lo, hi)))
    del p1          # the pooled field of a mip tier

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
    check_q_ceilings(q.h_frac, q.test12)

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
