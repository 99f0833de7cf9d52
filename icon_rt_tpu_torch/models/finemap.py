"""Fine primary-candidate map: the first stage of the quantized tier's
two-stage locate, and K7-fm, its builder.

A lat/lon grid `factor` times finer per axis than the coarse locator holds,
per fine bin, FOUR candidate columns: the first 4 distinct of the
containers of the bin's 4 sub-quadrant centers and their nearest differing
neighbours (cells are triangles, so a fine bin near a mesh vertex overlaps
3+ cells).  The tracker tests those 4 columns first and falls back to the
full coarse query on a miss, so the map only ever short-cuts to a column
the full query would also return (up to f32 boundary ties).

Candidates are stored as u8 SLOT indices into the coarse locator row of
the fine bin's integer-divided parent bin (255 = empty): 4 bytes per fine
bin.  Lossless: a candidate that can contain a point of the fine bin
overlaps the parent bin, so conservative binning listed it in that row.

K7-fm `build_finemap` (CUDA C++, csrc/finemap.cu) replaces the XLA-fused
icon_rt_tpu/models/finemap.py `_centers_c0`, `_second_candidates`,
`_first_distinct4` and `build_finemap`; its plain version is
`_build_finemap_torch`.  The TPU build's latitude slabs, `gather_budget`
and `max_call_lanes` bounded TPU HBM temporaries; on the card one block
owns a `TILE` of fine bins and keeps its sub-center image with a one-center
halo in shared memory, so no sub-center image exists in device memory.
`_finemap_bins_torch` computes the slots of chosen fine bins only, for
exact checks of the kernel at scales where the whole plain image does not
fit beside the scene.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils import cuda_build

#: candidates per fine bin
K_CAND = 4

#: K7-fm kernel launches (the wrapper counts only CUDA launches)
launches = 0

#: sub-centers per chunk of the plain version's candidate gather
_CHUNK = 1 << 20

#: fine bins (lat, lon) a block of csrc/finemap.cu owns: 32 x 64 sub-centers
#: and a 128-byte run of slot words per tile row, 24 KB of shared memory at
#: factor 2 and k_cap 18 (the launcher halves the tile where it would pass
#: 48 KB).  Picked by timing at R2B9 (scripts/time_locator.py --tiles)
TILE = (16, 32)


class FineMap(NamedTuple):
    slots: torch.Tensor    # (f_lat * f_lon, 4) u8 slots into the parent row
    lat_lo: torch.Tensor   # () f32 — the coarse locator's window
    lat_hi: torch.Tensor
    lon_lo: torch.Tensor
    lon_hi: torch.Tensor
    dims: torch.Tensor     # (2,) i32 (f_lat, f_lon)


def _sub_grid(loc, factor: int):
    n_lat, n_lon = (int(d) for d in loc.dims.tolist())
    return n_lat, n_lon, 2 * factor * n_lat, 2 * factor * n_lon


def _centers_c0_torch(loc, test12, factor: int, ids):
    """Containing cell of each sub-bin center in `ids` (flat ids on the
    (2 F_lat, 2 F_lon) sub grid): the first candidate of its parent coarse
    bin whose side planes contain the unit-sphere point; -1 if none."""
    n_lat, n_lon, s_lat, s_lon = _sub_grid(loc, factor)
    F32 = torch.float32
    fl = torch.div(ids, s_lon, rounding_mode="floor")
    fo = ids - fl * s_lon
    # divided by tensors: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    dims = torch.tensor([s_lat, s_lon], dtype=F32, device=ids.device)
    lat = loc.lat_lo + (fl.to(F32) + 0.5) * ((loc.lat_hi - loc.lat_lo)
                                             / dims[0])
    lon = loc.lon_lo + (fo.to(F32) + 0.5) * ((loc.lon_hi - loc.lon_lo)
                                             / dims[1])
    cl = torch.cos(lat)
    px = cl * torch.cos(lon)
    py = cl * torch.sin(lon)
    pz = torch.sin(lat)
    fs = 2 * factor
    bid = torch.div(fl, fs, rounding_mode="floor") * n_lon \
        + torch.div(fo, fs, rounding_mode="floor")
    cand = loc.bins[bid]                                   # (M, K)
    safe = torch.clamp(cand, min=0).long()
    t = test12[safe]                                       # (M, K, 12)
    ev = [t[..., 3 * j] * px[:, None] + t[..., 3 * j + 1] * py[:, None]
          + t[..., 3 * j + 2] * pz[:, None] for j in range(3)]
    inside = (cand >= 0) & (ev[0] <= 0.0) & (ev[1] <= 0.0) & (ev[2] <= 0.0)
    slot = torch.argmax(inside.to(torch.int32), dim=1)
    cid = cand.gather(1, slot[:, None])[:, 0]
    return torch.where(inside.any(1), cid, -1)


def _second_candidates_torch(c0):
    """c1 per sub-bin of the (s_lat, s_lon) image: the first neighbour (E,
    W, S, N, then the diagonals) whose c0 differs and is >= 0; longitude
    wraps, latitude clamps at the edge rows."""
    s_lat = c0.shape[0]
    c1 = torch.full_like(c0, -1)
    rows = torch.arange(s_lat, device=c0.device)
    for dl, do in ((0, 1), (0, -1), (1, 0), (-1, 0),
                   (1, 1), (1, -1), (-1, 1), (-1, -1)):
        nb = torch.roll(c0, -do, dims=1) if do else c0
        nb = nb[torch.clamp(rows + dl, 0, s_lat - 1)]
        take = (c1 < 0) & (nb != c0) & (nb >= 0)
        c1 = torch.where(take, nb, c1)
    return c1


def _first_distinct4_torch(pool):
    """(..., 8) candidate pool -> (..., 4): the first 4 distinct
    non-negative entries, -1 padded."""
    shape = pool.shape[:-1]
    out = [torch.full(shape, -1, dtype=torch.int32, device=pool.device)
           for _ in range(K_CAND)]
    cnt = torch.zeros(shape, dtype=torch.int32, device=pool.device)
    for j in range(pool.shape[-1]):
        v = pool[..., j]
        dup = torch.zeros(shape, dtype=torch.bool, device=pool.device)
        for k in range(K_CAND):
            dup = dup | (out[k] == v)
        take = ~dup & (v >= 0) & (cnt < K_CAND)
        for k in range(K_CAND):
            out[k] = torch.where(take & (cnt == k), v, out[k])
        cnt = cnt + take.to(torch.int32)
    return torch.stack(out, dim=-1)


def _finemap_bins_torch(loc, test12, factor: int, fbids) -> torch.Tensor:
    """Plain K7-fm on chosen fine bins: the (M, 4) u8 slots of the fine
    bins `fbids` (flat ids on the (f_lat, f_lon) grid), equal to those rows
    of `_build_finemap_torch`.  Each bin's 4 x 4 patch of sub-centers (its
    2 x 2 and their 8-neighbourhood; latitude clamps, longitude wraps) takes
    `_centers_c0_torch`, then c1, the first 4 distinct and the slot search
    follow the whole-image rules."""
    n_lat, n_lon, s_lat, s_lon = _sub_grid(loc, factor)
    f_lon = s_lon // 2
    fbids = fbids.to(torch.int64)
    fl = torch.div(fbids, f_lon, rounding_mode="floor")
    fo = fbids - fl * f_lon
    d = torch.arange(-1, 3, device=fbids.device)
    rows = torch.clamp(2 * fl[:, None] + d, 0, s_lat - 1)
    cols = torch.remainder(2 * fo[:, None] + d, s_lon)
    ids = (rows[:, :, None] * s_lon + cols[:, None, :]).reshape(-1)
    c0 = torch.cat([_centers_c0_torch(loc, test12, factor, ids[i:i + _CHUNK])
                    for i in range(0, ids.numel(), _CHUNK)])
    c0 = c0.reshape(-1, 4, 4).to(torch.int32)
    pool = [c0[:, 1 + k // 2, 1 + k % 2] for k in range(4)]
    for k in range(4):
        i, j = 1 + k // 2, 1 + k % 2
        c1 = torch.full_like(pool[k], -1)
        for dl, do in ((0, 1), (0, -1), (1, 0), (-1, 0),
                       (1, 1), (1, -1), (-1, 1), (-1, -1)):
            nb = c0[:, i + dl, j + do]
            c1 = torch.where((c1 < 0) & (nb != pool[k]) & (nb >= 0), nb, c1)
        pool.append(c1)
    sel = _first_distinct4_torch(torch.stack(pool, dim=-1))
    bid = torch.div(fl, factor, rounding_mode="floor") * n_lon \
        + torch.div(fo, factor, rounding_mode="floor")
    row = loc.bins[bid]                                    # (M, K)
    eq = row[:, None, :] == sel[..., None]                 # (M, 4, K)
    found = eq.any(-1) & (sel >= 0)
    slot = torch.argmax(eq.to(torch.int32), dim=-1)
    return torch.where(found, slot, 255).to(torch.uint8)


def _build_finemap_torch(loc, test12, factor: int = 2) -> torch.Tensor:
    """Plain-PyTorch K7-fm: (f_lat * f_lon, 4) u8 slots."""
    n_lat, n_lon, s_lat, s_lon = _sub_grid(loc, factor)
    f_lat, f_lon = s_lat // 2, s_lon // 2
    dev = loc.bins.device
    ids = torch.arange(s_lat * s_lon, dtype=torch.int64, device=dev)
    c0 = torch.cat([_centers_c0_torch(loc, test12, factor, ids[i:i + _CHUNK])
                    for i in range(0, ids.numel(), _CHUNK)])
    c0 = c0.reshape(s_lat, s_lon).to(torch.int32)
    c1 = _second_candidates_torch(c0)

    def agg(img):   # (s_lat, s_lon) -> (f_lat, f_lon, 4) in (dl, do) order
        return img.reshape(f_lat, 2, f_lon, 2).permute(0, 2, 1, 3) \
                  .reshape(f_lat, f_lon, 4)

    sel = _first_distinct4_torch(torch.cat([agg(c0), agg(c1)], dim=-1))
    g = torch.arange(f_lat, device=dev)
    bid = torch.div(g, factor, rounding_mode="floor")[:, None] * n_lon \
        + torch.div(torch.arange(f_lon, device=dev), factor,
                    rounding_mode="floor")[None, :]
    rows = loc.bins[bid]                                   # (F_lat, F_lon, K)
    eq = rows[:, :, None, :] == sel[..., None]             # (.., 4, K)
    found = eq.any(-1) & (sel >= 0)
    slot = torch.argmax(eq.to(torch.int32), dim=-1)
    return torch.where(found, slot, 255).to(torch.uint8).reshape(-1, K_CAND)


class _FinemapParams(ctypes.Structure):
    """Mirror of `FinemapParams` in csrc/finemap.cu (same field order)."""
    _fields_ = [
        ("bins", ctypes.c_void_p), ("test12", ctypes.c_void_p),
        ("slots", ctypes.c_void_p),
        ("lat_lo", ctypes.c_float), ("lat_hi", ctypes.c_float),
        ("lon_lo", ctypes.c_float), ("lon_hi", ctypes.c_float),
        ("n_lat", ctypes.c_int), ("n_lon", ctypes.c_int),
        ("k_cap", ctypes.c_int), ("factor", ctypes.c_int),
        ("tile_lat", ctypes.c_int), ("tile_lon", ctypes.c_int),
    ]


def build_finemap_kernel():
    """Compile csrc/finemap.cu for sm_90a and bind its entry point."""
    lib = cuda_build.build("finemap")
    lib.finemap_launch.argtypes = [ctypes.POINTER(_FinemapParams),
                                   ctypes.c_void_p]
    lib.finemap_launch.restype = ctypes.c_int
    return lib


def finemap_slots(loc, test12, factor: int = 2) -> torch.Tensor:
    """K7-fm wrapper: the (f_lat * f_lon, 4) u8 slots of the fine map over
    the coarse locator `loc` ((n_bins, k_cap) i32 bins) and the quantized
    tier's (N, 12) test rows (normals read).  CUDA tensors launch
    csrc/finemap.cu; CPU tensors run `_build_finemap_torch`."""
    global launches
    dev = loc.bins.device
    k_cap = loc.bins.shape[1]
    if loc.bins.dtype != torch.int32 or loc.bins.dim() != 2 \
            or not loc.bins.is_contiguous():
        raise ValueError("build_finemap: loc.bins must be contiguous "
                         "(n_bins, k_cap) int32")
    if test12.dtype != torch.float32 or test12.dim() != 2 \
            or test12.shape[1] != 12 or not test12.is_contiguous() \
            or test12.device != dev:
        raise ValueError("build_finemap: test12 must be contiguous (N, 12) "
                         "float32 on the locator's device")
    if not 0 < k_cap < 255:
        raise ValueError(f"build_finemap: k_cap {k_cap} overflows the u8 "
                         f"slot encoding")
    n_lat, n_lon, s_lat, s_lon = _sub_grid(loc, factor)
    # csrc/finemap.cu indexes the slots in 64 bits, but the trackers' fine
    # bin id (csrc/tier_q.cuh `fbid`) is an int
    if (s_lat // 2) * (s_lon // 2) >= 2 ** 31:
        raise ValueError(f"build_finemap: {s_lat // 2} x {s_lon // 2} fine "
                         f"bins overflow the trackers' 32-bit fine bin ids")
    if loc.bins.shape[0] != n_lat * n_lon:
        raise ValueError("build_finemap: loc.bins rows != n_lat * n_lon")
    if dev.type == "cpu":
        return _build_finemap_torch(loc, test12, factor)
    if dev.type != "cuda":
        raise ValueError(f"build_finemap: unsupported device {dev}")
    if test12.data_ptr() % 16:
        raise ValueError("build_finemap: the kernel reads test12 rows as "
                         "16-byte vectors; its data must be 16-byte aligned")
    lib = build_finemap_kernel()
    slots = torch.empty((s_lat * s_lon // 4, K_CAND), dtype=torch.uint8,
                        device=dev)
    win = torch.stack([loc.lat_lo, loc.lat_hi, loc.lon_lo,
                       loc.lon_hi]).to(torch.float32).tolist()
    p = _FinemapParams(bins=loc.bins.data_ptr(), test12=test12.data_ptr(),
                       slots=slots.data_ptr(),
                       lat_lo=win[0], lat_hi=win[1], lon_lo=win[2],
                       lon_hi=win[3], n_lat=n_lat, n_lon=n_lon, k_cap=k_cap,
                       factor=factor, tile_lat=TILE[0], tile_lon=TILE[1])
    cuda_build.check("build_finemap", lib.finemap_launch(
        ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream))
    launches += 1
    return slots


def build_finemap(loc, test12, factor: int = 2) -> FineMap:
    """The fine map over the coarse locator `loc` (built by K7-fm on the
    locator's device)."""
    n_lat, n_lon = (int(d) for d in loc.dims.tolist())
    return FineMap(slots=finemap_slots(loc, test12, factor),
                   lat_lo=loc.lat_lo, lat_hi=loc.lat_hi,
                   lon_lo=loc.lon_lo, lon_hi=loc.lon_hi,
                   dims=torch.tensor([n_lat * factor, n_lon * factor],
                                     dtype=torch.int32,
                                     device=loc.bins.device))


def slots_to_cells(fm: FineMap, loc, fbid, slots):
    """Decode (M, 4) u8 slots of fine bins `fbid` into cell ids (-1 empty)
    through the coarse row of each fine bin's integer-divided parent bin,
    the mapping the build used."""
    f_lon = int(fm.dims[1])
    factor = int(fm.dims[0]) // int(loc.dims[0])
    n_lon = int(loc.dims[1])
    fl = torch.div(fbid, f_lon, rounding_mode="floor")
    bid = torch.div(fl, factor, rounding_mode="floor") * n_lon \
        + torch.div(fbid - fl * f_lon, factor, rounding_mode="floor")
    rows = loc.bins[bid.long()]                            # (M, K)
    s = slots.long()
    cid = rows.gather(1, torch.clamp(s, max=rows.shape[1] - 1))
    return torch.where(s == 255, -1, cid)


def unpack_candidates(fm: FineMap, loc) -> np.ndarray:
    """Host decode of the whole map to (n_fine, 4) i32 cell ids (-1 empty);
    a test and debug utility."""
    n_fine = fm.slots.shape[0]
    fbid = torch.arange(n_fine, device=fm.slots.device)
    return slots_to_cells(fm, loc, fbid, fm.slots).to(torch.int32) \
        .cpu().numpy()
