"""Empty-space-skipping majorant grids and the TF-edit range-max pass
(kernel K5b).

Two majorant grids, as in the reference, back the parity raygen `accel`
(ops/render.py, kernel K8):
  * GridAccel  -- uniform Cartesian grid over the volume AABB, 256^3 bins
                  (ref: icon_rt/Params.h:44-49, hostCode.cu:245-297)
  * ShellAccel -- (r, lat, lon) spherical-shell grid, 1 x 1024 x 1024 bins
                  (ref: icon_rt/ShellAccel.h:22-27, hostCode.cu:299-336)
Each bin stores the value range of all cell layers touching it; the builds
run on the host in numpy and the shared C++ rasterizer.  Reference quirks
kept for image parity: the per-layer value range is (value[L-1], value[L])
unsorted (ref: hostCode.cu:291-293); ShellAccel's lower corner uses only
the bottom corners and its upper corner only the top corners (ref:
hostCode.cu:311-319); the spherical projection scales by dims-1 and is
unclamped (ref: ShellAccel.h:57-68), the Cartesian one clamps (ref:
DDA.h:24-31).  The radial bands of the fast path (models/shells.py) reuse
the rasterizer and K5b.

K5b `max_opacity` (CUDA C++, csrc/majorant.cu) maps per-bin value ranges
through the LUT's alpha channel to per-bin majorants -- the reference's
computeMaxOpacities (ref: hostCode.cu:362-434).  It replaces the XLA-fused
icon_rt_tpu/models/accel.py `compute_max_opacities` (a sparse-table
range-max) with the same algorithm and runs on every TF edit: each block
builds the LUT's sparse table in shared memory, then answers each bin with
one gather of two entries (O(1) a bin, whatever the LUT's size).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..data.icfile import ICDataset
from ..utils import cuda_build
from .cells import layer_bounds

F = np.float32
FLT_MAX = np.float32(np.finfo(np.float32).max)


class GridAccel(NamedTuple):
    dims: torch.Tensor            # (3,) i32
    world_lo: torch.Tensor        # (3,) f32
    world_hi: torch.Tensor        # (3,) f32
    value_ranges: torch.Tensor    # (M, 2) f32
    max_opacities: torch.Tensor   # (M,) f32


class ShellAccel(NamedTuple):
    dims: torch.Tensor            # (3,) i32
    sph_lo: torch.Tensor          # (3,) f32 (r, lat, lon)
    sph_hi: torch.Tensor          # (3,) f32
    value_ranges: torch.Tensor    # (M, 2) f32
    max_opacities: torch.Tensor   # (M,) f32

#: K5b launches (the wrapper adds one per kernel launch; plain-version runs
#: on the CPU do not count)
launches = 0


# ---------------------------------------------------------------------------
# Host-side builds (numpy scatter-min/max)
# ---------------------------------------------------------------------------

def _np_project_on_grid(v, dims, lo, hi):
    """Clamped Cartesian projection (ref: DDA.h:24-31); trunc toward zero."""
    v01 = ((v - lo) / (hi - lo)).astype(F)
    vs = (v01 * dims.astype(F)).astype(F)
    return np.clip(vs.astype(np.int64), 0, dims - 1)


def _np_project_spherical(sph, dims, slo, shi):
    """Unclamped spherical projection scaled by dims-1 (ref:
    ShellAccel.h:57-68)."""
    scaled = ((sph - slo) / (shi - slo) * (dims - 1).astype(F)).astype(F)
    return scaled.astype(np.int64)


def _layer_values(ds: ICDataset, L: int):
    """(value at layer bottom height, value at layer top height): the
    reference evaluates getValue(h[L]) / getValue(h[L+1]), which resolve to
    value[max(L-1, 0)] and value[L] (ref: hostCode.cu:291-293)."""
    return ds.value[:, max(L - 1, 0)], ds.value[:, L]


def _layer_subsets(ds: ICDataset):
    """(L, the cells with more than L layers) for every layer index."""
    max_l = int(ds.num_layers.max()) if ds.num_cells else 0
    for L in range(max_l):
        sel = ds.num_layers > L
        yield L, ICDataset(ds.lat[sel], ds.lon[sel], ds.num_layers[sel],
                           ds.height[sel], ds.value[sel])


def _accel_tensors(dims, lo, hi, vr_lo, vr_hi, device):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(dims.astype(np.int32)), t(lo), t(hi),
            t(np.stack([vr_lo, vr_hi], axis=1)),
            torch.zeros(vr_lo.shape[0], dtype=torch.float32, device=device))


def build_grid_accel(ds: ICDataset, world_lo, world_hi,
                     dims=(256, 256, 256), device="cpu") -> GridAccel:
    """Cartesian majorant grid (ref: hostCode.cu:245-297 buildGrid_ICON);
    majorants zero until `update_majorants`."""
    dims = np.asarray(dims, np.int64)
    world_lo = np.asarray(world_lo, F)
    world_hi = np.asarray(world_hi, F)
    m = int(np.prod(dims))
    vr_lo = np.full(m, FLT_MAX, F)
    vr_hi = np.full(m, -FLT_MAX, F)
    for L, sub in _layer_subsets(ds):
        blo, bhi = layer_bounds(sub, sub.height[:, L], sub.height[:, L + 1])
        lo_idx = _np_project_on_grid(blo, dims, world_lo, world_hi)
        up_idx = _np_project_on_grid(bhi, dims, world_lo, world_hi)
        vlo, vhi = _layer_values(sub, L)
        _rasterize(vr_lo, vr_hi, lo_idx, up_idx, vlo, vhi, dims)
    return GridAccel(*_accel_tensors(dims, world_lo, world_hi, vr_lo, vr_hi,
                                     device))


def build_shell_accel(ds: ICDataset, sph_lo, sph_hi, dims=(1, 1024, 1024),
                      device="cpu") -> ShellAccel:
    """Spherical-shell majorant grid (ref: hostCode.cu:299-336
    buildShell_ICON); majorants zero until `update_majorants`."""
    dims = np.asarray(dims, np.int64)
    sph_lo = np.asarray(sph_lo, F)
    sph_hi = np.asarray(sph_hi, F)
    m = int(np.prod(dims))
    vr_lo = np.full(m, FLT_MAX, F)
    vr_hi = np.full(m, -FLT_MAX, F)
    for L, sub in _layer_subsets(ds):
        n = sub.num_cells
        # bottom corners -> lower index, top corners -> upper (the quirk)
        sph_b = np.stack([np.broadcast_to(sub.height[:, L][:, None], (n, 3)),
                          sub.lat, sub.lon], axis=-1).astype(F)
        sph_t = np.stack([np.broadcast_to(sub.height[:, L + 1][:, None],
                                          (n, 3)),
                          sub.lat, sub.lon], axis=-1).astype(F)
        lo_idx = _np_project_spherical(sph_b, dims, sph_lo, sph_hi).min(1)
        up_idx = _np_project_spherical(sph_t, dims, sph_lo, sph_hi).max(1)
        # the traversal wraps shell bins; the build writes raw indices, which
        # the reference would write out of bounds: clamp them into the array
        lo_idx = np.clip(lo_idx, 0, dims - 1)
        up_idx = np.clip(up_idx, 0, dims - 1)
        vlo, vhi = _layer_values(sub, L)
        _rasterize(vr_lo, vr_hi, lo_idx, up_idx, vlo, vhi, dims)
    return ShellAccel(*_accel_tensors(dims, sph_lo, sph_hi, vr_lo, vr_hi,
                                      device))


def _rasterize(vr_lo, vr_hi, lo_idx, up_idx, val_lo, val_hi, dims):
    """Scatter (val_lo, val_hi) min/max into every bin of [lo_idx, up_idx]
    boxes.  Prefers the C++ host module; the numpy fallback uses a
    vectorized offset loop for small footprints and a per-item loop for
    the rare huge ones."""
    from ..utils.native import native_rasterize
    if native_rasterize(np.ascontiguousarray(lo_idx),
                        np.ascontiguousarray(up_idx),
                        val_lo, val_hi, dims, vr_lo, vr_hi):
        return
    ext = up_idx - lo_idx + 1
    small = np.all(ext <= 8, axis=1)
    sx, sy = dims[0], dims[1]

    def flat(ix, iy, iz):
        return iz * sx * sy + iy * sx + ix

    li, ui = lo_idx[small], up_idx[small]
    vl, vh = val_lo[small], val_hi[small]
    if li.shape[0]:
        me = ui - li + 1
        for dz in range(int(me[:, 2].max())):
            for dy in range(int(me[:, 1].max())):
                for dx in range(int(me[:, 0].max())):
                    m = (dx < me[:, 0]) & (dy < me[:, 1]) & (dz < me[:, 2])
                    ids = flat(li[m, 0] + dx, li[m, 1] + dy, li[m, 2] + dz)
                    np.minimum.at(vr_lo, ids, vl[m])
                    np.maximum.at(vr_hi, ids, vh[m])
    for j in np.nonzero(~small)[0]:
        zz, yy, xx = np.meshgrid(
            np.arange(lo_idx[j, 2], up_idx[j, 2] + 1),
            np.arange(lo_idx[j, 1], up_idx[j, 1] + 1),
            np.arange(lo_idx[j, 0], up_idx[j, 0] + 1), indexing="ij")
        ids = flat(xx.ravel(), yy.ravel(), zz.ravel())
        np.minimum.at(vr_lo, ids, val_lo[j])
        np.maximum.at(vr_hi, ids, val_hi[j])


# ---------------------------------------------------------------------------
# K5b: majorants from the transfer function
# ---------------------------------------------------------------------------

def _lut_index_range(value_ranges, size: int, tf_value_range):
    """(ilo, ihi) LUT index range of each value range, derived exactly as
    the reference: ilo = clamp(int(lo_n*(S-1))), ihi = clamp(int(hi_n*(S-1))+1)."""
    span = tf_value_range[1] - tf_value_range[0]
    lo_n = (value_ranges[:, 0] - tf_value_range[0]) / span
    hi_n = (value_ranges[:, 1] - tf_value_range[0]) / span
    ilo = torch.clamp((lo_n * float(size - 1)).to(torch.int32), 0, size - 1)
    ihi = torch.clamp((hi_n * float(size - 1)).to(torch.int32) + 1,
                      0, size - 1)
    return ilo.long(), ihi.long()


def compute_max_opacities_torch(value_ranges, lut, tf_value_range):
    """Plain-PyTorch K5b: range-max of LUT alpha over [ilo, ihi] through a
    sparse table (levels[k][i] = max(alpha[i : i + 2^k])), O(1) per row.
    Empty rows (upper < lower) get majorant 0."""
    size = lut.shape[0]
    ilo, ihi = _lut_index_range(value_ranges, size, tf_value_range)
    alpha = lut[:, 3]
    levels = [alpha]
    k = 1
    while (1 << k) <= size:
        prev = levels[-1]
        half = 1 << (k - 1)
        shifted = torch.cat([prev[half:], prev[-1:].repeat(half)])
        levels.append(torch.maximum(prev, shifted))
        k += 1
    length = ihi - ilo + 1
    kk = torch.zeros_like(length)
    for j in range(1, len(levels)):
        kk = torch.where(length >= (1 << j), j, kk)
    table = torch.stack(levels)                       # (K, S)
    a = table[kk, ilo]
    b = table[kk, torch.clamp(ihi - (1 << kk) + 1, min=0)]
    mo = torch.maximum(a, b)
    empty = value_ranges[:, 1] < value_ranges[:, 0]
    return torch.where(empty, 0.0, mo).to(torch.float32)


class _MajorantParams(ctypes.Structure):
    """Mirror of `MajorantParams` in csrc/majorant.cu (same field order)."""
    _fields_ = [
        ("ranges", ctypes.c_void_p), ("lut", ctypes.c_void_p),
        ("tf_range", ctypes.c_void_p), ("table", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("m", ctypes.c_longlong),
        ("s", ctypes.c_int), ("levels", ctypes.c_int),
    ]


def build_majorant_kernel():
    """Compile csrc/majorant.cu for sm_90a and bind its entry points."""
    lib = cuda_build.build("majorant")
    lib.max_opacity_launch.argtypes = [ctypes.POINTER(_MajorantParams),
                                       ctypes.c_void_p]
    lib.max_opacity_launch.restype = ctypes.c_int
    lib.majorant_shared_limit.restype = ctypes.c_int
    return lib


def max_opacity(value_ranges, lut, tf_value_range):
    """K5b wrapper: map per-bin value ranges through the LUT and the TF
    value range to majorants (ref: hostCode.cu:362-434); empty bins get 0.
    The CUDA kernel runs for CUDA tensors, the plain version for CPU
    tensors; anything else raises.  value_ranges (M, 2) f32, lut (S, 4)
    f32 with S >= 1, tf_value_range (2,) f32, all contiguous on one
    device.  Returns (M,) f32."""
    global launches
    for name, x, nd in (("value_ranges", value_ranges, 2), ("lut", lut, 2),
                        ("tf_value_range", tf_value_range, 1)):
        if x.dtype != torch.float32 or x.dim() != nd or not x.is_contiguous():
            raise ValueError(f"max_opacity: {name} must be a contiguous "
                             f"{nd}-D float32 tensor")
        if x.device != value_ranges.device:
            raise ValueError("max_opacity: tensors on different devices")
    if value_ranges.shape[1] != 2 or lut.shape[1] != 4 \
            or tf_value_range.shape[0] != 2 or lut.shape[0] < 1:
        raise ValueError("max_opacity: expected shapes (M, 2), (S >= 1, 4), "
                         "(2,)")
    dev = value_ranges.device
    if dev.type == "cpu":
        return compute_max_opacities_torch(value_ranges, lut, tf_value_range)
    if dev.type != "cuda":
        raise ValueError(f"max_opacity: unsupported device {dev}")
    lib = build_majorant_kernel()
    m, s = value_ranges.shape[0], lut.shape[0]
    levels = s.bit_length()        # floor(log2 S) + 1, as the plain table
    out = torch.empty(m, dtype=torch.float32, device=dev)
    if not m:
        return out
    table = None
    if 4 * s * levels > lib.majorant_shared_limit():
        table = torch.empty((levels, s), dtype=torch.float32, device=dev)
    p = _MajorantParams(ranges=value_ranges.data_ptr(), lut=lut.data_ptr(),
                        tf_range=tf_value_range.data_ptr(),
                        table=None if table is None else table.data_ptr(),
                        out=out.data_ptr(), m=m, s=s, levels=levels)
    cuda_build.check("max_opacity", lib.max_opacity_launch(
        ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream))
    launches += 1
    return out


def update_majorants(accel, lut, tf_value_range):
    """TF-edit handler of a GridAccel or ShellAccel (ref:
    hostCode.cu:878-909): its majorants through K5b `max_opacity`."""
    return accel._replace(max_opacities=max_opacity(
        accel.value_ranges, lut, tf_value_range))
