"""Grid-of-lists cell locator — a (lat, lon) binning for point queries.

The reference locates the column containing a sample point with OptiX
user-geometry BVH queries or cuBQL traversal (ref: icon_rt/deviceCode.cu:
58-125, hostCode.cu:489-525).  ICON columns span the full radial extent,
so a 2-D footprint grid suffices.  Each bin holds a fixed-width, -1-padded
candidate list; a point query is

    bin = floor((lat, lon) normalized * dims)      # 2 flops
    ids = bins[bin]                                # one (K,) row
    inside = radial check + 3 plane tests over K   # dense math
    first hit (lowest cell id) wins                # == brute-force order

Candidate lists are built conservatively from corner bounding boxes (with
great-circle edge bulges; dateline-crossing cells insert two wrapped lon
ranges), so a query returns exactly the brute-force result: the
lowest-indexed cell containing the point.  The build runs on the host in
numpy and the shared C++ host module; the table then moves to the device.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..data.icfile import ICDataset
from ..utils import cuda_build
from .cells import Cells, _radius, candidate_tests, find_layer

F = np.float32


class Locator(NamedTuple):
    bins: torch.Tensor     # (n_lat * n_lon, K) i32 cell ids, -1 padded
    lat_lo: torch.Tensor   # () f32
    lat_hi: torch.Tensor   # () f32
    lon_lo: torch.Tensor   # () f32
    lon_hi: torch.Tensor   # () f32
    dims: torch.Tensor     # (2,) i32 (n_lat, n_lon)

    @property
    def k(self) -> int:
        return self.bins.shape[1]


class LocatorCSR(NamedTuple):
    """Compressed grid-of-lists on the host (numpy): bin b's candidates are
    items[starts[b] : starts[b] + counts[b]], in cell-id order."""
    starts: np.ndarray     # (n_bins,) i32
    counts: np.ndarray     # (n_bins,) i32
    items: np.ndarray      # (M,) i32 cell ids
    lat_lo: float
    lat_hi: float
    lon_lo: float
    lon_hi: float
    dims: tuple            # (n_lat, n_lon)


def _edge_extrema(lat: np.ndarray, lon: np.ndarray,
                  chunk: int = 1 << 22, use_native: bool = True):
    """Per-cell (lat_min, lat_max, extra_lons, pole) accounting for
    great-circle EDGE BULGE: the latitude extremum of a minor arc can lie
    strictly between its endpoints (the arc's closest approach to a
    pole), and the cell's longitude hull widens at exactly that point.
    A vertex-only bounding box misses those slivers, and the locator
    would return "no candidate" for points a brute-force containment test
    puts INSIDE a cell.

    Returns (lat_min (N,), lat_max (N,), lon_ext (N, 3) extremum lons —
    copies of lon[:, 0] where no interior extremum — and pole (N,) i8:
    +1 north pole inside, -1 south, 0 neither).

    The numpy body below is the ORACLE; the native C++ mirror
    (ih_edge_extrema, same f64 formula order, tested element-equal in
    tests/test_native.py) runs by default because the numpy temporaries
    cost ~5 us/cell-chunk — ~7 min at R2B9's 84M cells vs seconds."""
    if use_native:
        from ..utils.native import native_edge_extrema
        res = native_edge_extrema(lat, lon)
        if res is not None:
            return res
    n = lat.shape[0]
    lat_min = lat.min(axis=1).astype(np.float64)
    lat_max = lat.max(axis=1).astype(np.float64)
    lon_ext = np.tile(lon[:, :1].astype(np.float64), (1, 3))
    pole = np.zeros(n, np.int8)
    for s0 in range(0, n, chunk):
        s = slice(s0, min(s0 + chunk, n))
        la = lat[s].astype(np.float64)
        lo = lon[s].astype(np.float64)
        cl = np.cos(la)
        u = np.stack([cl * np.cos(lo), cl * np.sin(lo), np.sin(la)],
                     axis=-1)                        # (m, 3 verts, 3)
        # pole containment: all three side planes (through the origin,
        # CCW vertex order) contain +-z
        mm = np.cross(u, u[:, [1, 2, 0]])            # (m, 3 edges, 3)
        zin = mm[..., 2]
        pole[s] = np.where((zin <= 0).all(axis=1), 1,
                           np.where((zin >= 0).all(axis=1), -1, 0))
        for e, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
            m3 = mm[:, e]                            # cross(u_i, u_j)
            nrm = np.linalg.norm(m3, axis=1)
            mz = m3[:, 2] / np.maximum(nrm, 1e-300)
            # z-extremum point of the great circle: projection of z-hat
            # onto the circle plane (two antipodes; a minor arc holds
            # at most one)
            zml = np.sqrt(np.maximum(1.0 - mz * mz, 0.0))
            ex = -mz * m3[:, 0] / np.maximum(nrm, 1e-300)
            ey = -mz * m3[:, 1] / np.maximum(nrm, 1e-300)
            ez = zml * zml       # = 1 - mz^2, the unnormalized z comp
            den = np.maximum(zml, 1e-300)
            for sign in (1.0, -1.0):
                px, py, pz = sign * ex / den, sign * ey / den, \
                    sign * ez / den
                p = np.stack([px, py, pz], axis=1)
                # interior test: e strictly between u_i and u_j along
                # the minor arc <=> cross(u_i, p) and cross(p, u_j)
                # both align with the arc plane normal
                c1 = np.einsum('ij,ij->i', np.cross(u[:, i], p), m3)
                c2 = np.einsum('ij,ij->i', np.cross(p, u[:, j]), m3)
                interior = (c1 > 0) & (c2 > 0) & (zml > 1e-12)
                if not interior.any():
                    continue
                plat = np.arcsin(np.clip(pz, -1.0, 1.0))
                plon = np.arctan2(py, px)
                lat_min[s] = np.where(interior,
                                      np.minimum(lat_min[s], plat),
                                      lat_min[s])
                lat_max[s] = np.where(interior,
                                      np.maximum(lat_max[s], plat),
                                      lat_max[s])
                lon_ext[s.start:s.stop, e] = np.where(
                    interior, plon, lon_ext[s.start:s.stop, e])
    return lat_min, lat_max, lon_ext, pole


def _range_records(ds: ICDataset, n_lat: int, n_lon: int,
                   lat_lo, lat_hi, lon_lo, lon_hi) -> np.ndarray:
    """(R, 5) i64 records (cell_id, la0, la1, lb0, lb1) — each cell's bin
    rectangle(s), sorted by cell id.  THE single source of binning truth:
    both the numpy expansion (_bbox_entries) and the native C++ scatter
    (utils.native.native_locator_bins) consume these records, so the
    edge-bulge geometry below cannot diverge between the two paths.

    Cell extents are the spherical hull of vertices AND edge-bulge
    extrema (_edge_extrema); pole-containing cells span the full
    longitude circle; dateline straddlers contribute two wrapped lon
    ranges."""
    n = ds.num_cells

    def lat_bin(v):
        return np.clip(((v - lat_lo) / (lat_hi - lat_lo) * n_lat).astype(np.int64),
                       0, n_lat - 1)

    def lon_bin(v):
        return np.clip(((v - lon_lo) / (lon_hi - lon_lo) * n_lon).astype(np.int64),
                       0, n_lon - 1)

    elat_min, elat_max, elon, pole = _edge_extrema(ds.lat, ds.lon)
    lat_all = np.concatenate([ds.lat, elat_min[:, None], elat_max[:, None]],
                             axis=1)
    lon_all = np.concatenate([ds.lon, elon], axis=1)   # (N, 6)
    lat_all[pole > 0, -1] = lat_hi                     # pole rows reach the
    lat_all[pole < 0, -2] = lat_lo                     # window's lat edge
    la0 = lat_bin(lat_all.min(axis=1))
    la1 = lat_bin(lat_all.max(axis=1))
    lo_min = np.where(pole != 0, lon_lo, lon_all.min(axis=1))
    lo_max = np.where(pole != 0, lon_hi, lon_all.max(axis=1))
    # pole cells legitimately span the whole circle — keep them one
    # full-range record; the two-range split is only for dateline
    # STRADDLERS whose naive [min, max] hull would cover ~every lon bin
    crossing = ((lo_max - lo_min) > np.pi) & (pole == 0)

    ids = np.arange(n, dtype=np.int64)
    reg = ~crossing
    # range records: (cell, la0, la1, lb0, lb1); dateline-crossing cells
    # (lon span > pi) contribute two wrapped lon ranges
    recs = [np.stack([ids[reg], la0[reg], la1[reg],
                      lon_bin(lo_min[reg]), lon_bin(lo_max[reg])], axis=1)]
    if crossing.any():
        c = crossing
        nc = int(c.sum())
        pos_min = np.where(lon_all[c] > 0, lon_all[c], np.inf).min(axis=1)
        neg_max = np.where(lon_all[c] < 0, lon_all[c], -np.inf).max(axis=1)
        recs.append(np.stack([ids[c], la0[c], la1[c], lon_bin(pos_min),
                              np.full(nc, n_lon - 1, np.int64)], axis=1))
        recs.append(np.stack([ids[c], la0[c], la1[c],
                              np.zeros(nc, np.int64), lon_bin(neg_max)], axis=1))
    rec = np.concatenate(recs, axis=0)
    if len(rec):
        rec = rec[np.argsort(rec[:, 0], kind="stable")]
    return rec


def _bbox_entries(ds: ICDataset, n_lat: int, n_lon: int,
                  lat_lo, lat_hi, lon_lo, lon_hi) -> np.ndarray:
    """(M, 2) i64 (bin_id, cell_id) pairs sorted by (bin, cell id) — the
    numpy path of build_locator.

    Fully vectorized (repeat-based rectangle expansion + one packed-key
    sort): polar cells span thousands of lon bins at R2B9."""
    n = ds.num_cells
    rec = _range_records(ds, n_lat, n_lon, lat_lo, lat_hi, lon_lo, lon_hi)
    if not len(rec):
        return np.zeros((0, 2), np.int64)

    wla = rec[:, 2] - rec[:, 1] + 1
    wlo = rec[:, 4] - rec[:, 3] + 1
    cnt = wla * wlo
    m = int(cnt.sum())
    starts = np.zeros(len(rec), np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    r = np.repeat(np.arange(len(rec), dtype=np.int64), cnt)
    o = np.arange(m, dtype=np.int64) - starts[r]
    wlo_r = wlo[r]
    dla = o // wlo_r
    dlo = o - dla * wlo_r
    b = (rec[r, 1] + dla) * n_lon + (rec[r, 3] + dlo)
    cell = rec[r, 0]
    # one packed-key sort gives (bin, cell) lexicographic order
    key = b * np.int64(n + 1) + cell
    key.sort(kind="stable")
    b = key // np.int64(n + 1)
    cell = key - b * np.int64(n + 1)
    return np.stack([b, cell], axis=1)


def _window(ds: ICDataset, pad: float):
    """(lat_lo, lat_hi, lon_lo, lon_hi) of the cell centres, padded; the
    whole sphere for an empty dataset."""
    if not ds.num_cells:
        return -np.pi / 2, np.pi / 2, -np.pi, np.pi
    return (float(ds.lat.min()) - pad, float(ds.lat.max()) + pad,
            float(ds.lon.min()) - pad, float(ds.lon.max()) + pad)


def build_locator(ds: ICDataset, dims: tuple[int, int] | None = None,
                  pad: float = 1e-4, use_native: bool = True,
                  device="cpu") -> Locator:
    """Bin cells by their (lat, lon) corner bounding boxes.

    dims defaults to roughly sqrt(2 N) per axis so mean occupancy stays a
    few cells per bin independent of the R2B level.  Bin rectangles are
    always computed by _range_records (one source of truth, incl. the
    edge-bulge extrema); with use_native the two-pass rectangle scatter
    runs in the C++ host module (native/icon_host.cpp) — identical output.
    """
    n = ds.num_cells
    if dims is None:
        side = max(1, int(np.sqrt(max(n, 1) * 2)))
        dims = (side, side)
    n_lat, n_lon = dims
    lat_lo, lat_hi, lon_lo, lon_hi = _window(ds, pad)

    bins = None
    if use_native and n:
        from ..utils.native import native_locator_bins
        rec = _range_records(ds, n_lat, n_lon, lat_lo, lat_hi,
                             lon_lo, lon_hi)
        res = native_locator_bins(rec, n_lat, n_lon)
        if res is not None:
            bins = res[0]
    if bins is None:
        all_e = _bbox_entries(ds, n_lat, n_lon, lat_lo, lat_hi,
                              lon_lo, lon_hi)
        if len(all_e):
            _, counts = np.unique(all_e[:, 0], return_counts=True)
            k = int(counts.max())
            bins = np.full((n_lat * n_lon, k), -1, np.int32)
            # position of each entry within its bin
            first = np.r_[True, all_e[1:, 0] != all_e[:-1, 0]]
            idx_in_bin = np.arange(len(all_e)) - np.maximum.accumulate(
                np.where(first, np.arange(len(all_e)), 0))
            bins[all_e[:, 0], idx_in_bin] = all_e[:, 1]
        else:
            bins = np.full((n_lat * n_lon, 1), -1, np.int32)

    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return Locator(
        bins=torch.from_numpy(np.ascontiguousarray(bins)).to(device),
        lat_lo=f32(lat_lo), lat_hi=f32(lat_hi),
        lon_lo=f32(lon_lo), lon_hi=f32(lon_hi),
        dims=torch.tensor([n_lat, n_lon], dtype=torch.int32, device=device),
    )


def build_locator_csr(ds: ICDataset) -> tuple[LocatorCSR, int]:
    """CSR locator of the quantized tier; returns (locator, k_cap), k_cap
    the largest bin occupancy.  The resolution is sqrt(N/2) per axis (a
    few candidates per bin).  Host numpy, binned by the same
    `_bbox_entries` as build_locator."""
    n_lat = n_lon = max(1, int(np.sqrt(max(ds.num_cells, 1) / 2)))
    lat_lo, lat_hi, lon_lo, lon_hi = _window(ds, 1e-4)

    all_e = _bbox_entries(ds, n_lat, n_lon, lat_lo, lat_hi, lon_lo, lon_hi)
    n_bins = n_lat * n_lon
    counts = np.bincount(all_e[:, 0], minlength=n_bins).astype(np.int64)
    starts = np.zeros(n_bins, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    k_cap = int(counts.max()) if len(all_e) else 1
    items = all_e[:, 1].astype(np.int32) if len(all_e) \
        else np.zeros((1,), np.int32)
    return LocatorCSR(starts=starts.astype(np.int32),
                      counts=counts.astype(np.int32), items=items,
                      lat_lo=lat_lo, lat_hi=lat_hi, lon_lo=lon_lo,
                      lon_hi=lon_hi, dims=(n_lat, n_lon)), k_cap


def densify_csr(loc: LocatorCSR, k_cap: int, device="cpu") -> Locator:
    """CSR -> dense (n_bins, k_cap) Locator, -1 padded, candidates in the
    CSR's cell-id order (host numpy: a repeat of the row starts and one
    scatter into the padded table)."""
    starts = loc.starts.astype(np.int64)
    counts = loc.counts.astype(np.int64)
    n_bins = starts.shape[0]
    bins = np.full((n_bins, k_cap), -1, np.int32)
    if loc.items.shape[0] and counts.sum() > 0:
        pos = np.repeat(starts, counts)
        binid = np.repeat(np.arange(n_bins, dtype=np.int64), counts)
        slot = np.arange(pos.shape[0], dtype=np.int64) - pos
        ok = slot < k_cap
        bins[binid[ok], slot[ok]] = loc.items[:pos.shape[0]][ok]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return Locator(bins=torch.from_numpy(bins).to(device),
                   lat_lo=f32(loc.lat_lo), lat_hi=f32(loc.lat_hi),
                   lon_lo=f32(loc.lon_lo), lon_hi=f32(loc.lon_hi),
                   dims=torch.tensor(loc.dims, dtype=torch.int32,
                                     device=device))


# ---------------------------------------------------------------------------
# K7-loc: the quantized tier's binning on the device
# ---------------------------------------------------------------------------

#: K7-loc kernel launches (the wrapper counts only CUDA launches)
launches = {"locator_window": 0, "locator_rects": 0, "locator_lists": 0,
            "locator_rows": 0}


def _rect_torch(lat, lon, n_lat: int, n_lon: int, window):
    """Plain K7-loc, step 1: (N, 8) i32 bin rectangles (la0, la1, lb0, lb1
    of one range, then of a second range or -1) of the cells' corner
    lat/lon, in f64 tensors with the formula order of `_edge_extrema` (the
    native mirror's) and `_range_records`."""
    f64 = torch.float64
    dev = lat.device
    lat_lo, lat_hi, lon_lo, lon_hi = (torch.tensor(v, dtype=f64, device=dev)
                                      for v in window)
    la, lo = lat.to(f64), lon.to(f64)
    lo_v = lat.amin(1).to(f64)
    hi_v = lat.amax(1).to(f64)
    cl = torch.cos(la)
    u = [(cl[:, k] * torch.cos(lo[:, k]), cl[:, k] * torch.sin(lo[:, k]),
          torch.sin(la[:, k])) for k in range(3)]
    mm = []
    for e in range(3):
        a, b = u[e], u[(e + 1) % 3]
        mm.append((a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                   a[0] * b[1] - a[1] * b[0]))
    zin = torch.stack([m[2] for m in mm], dim=1)
    pole = torch.where((zin <= 0).all(1), 1, torch.where((zin >= 0).all(1),
                                                          -1, 0))
    lon_ext = [lo[:, 0]] * 3
    for e in range(3):
        ui, uj, m3 = u[e], u[(e + 1) % 3], mm[e]
        nrm = torch.sqrt(m3[0] * m3[0] + m3[1] * m3[1] + m3[2] * m3[2])
        dn = torch.clamp(nrm, min=1e-300)
        mz = m3[2] / dn
        zml = torch.sqrt(torch.clamp(1.0 - mz * mz, min=0.0))
        ex, ey = -mz * m3[0] / dn, -mz * m3[1] / dn
        ez = zml * zml
        den = torch.clamp(zml, min=1e-300)
        for sign in (1.0, -1.0):
            px, py, pz = sign * ex / den, sign * ey / den, sign * ez / den
            c1 = (ui[1] * pz - ui[2] * py) * m3[0] \
                + (ui[2] * px - ui[0] * pz) * m3[1] \
                + (ui[0] * py - ui[1] * px) * m3[2]
            c2 = (py * uj[2] - pz * uj[1]) * m3[0] \
                + (pz * uj[0] - px * uj[2]) * m3[1] \
                + (px * uj[1] - py * uj[0]) * m3[2]
            inner = (c1 > 0) & (c2 > 0) & (zml > 1e-12)
            plat = torch.asin(torch.clamp(pz, -1.0, 1.0))
            lo_v = torch.where(inner, torch.minimum(lo_v, plat), lo_v)
            hi_v = torch.where(inner, torch.maximum(hi_v, plat), hi_v)
            lon_ext[e] = torch.where(inner, torch.atan2(py, px), lon_ext[e])

    def bins_of(v, lo_t, hi_t, n):
        return torch.clamp(((v - lo_t) / (hi_t - lo_t) * n).to(torch.int64),
                           0, n - 1)

    lat_all = torch.cat([la, lo_v[:, None], hi_v[:, None]], dim=1)
    lat_all[:, 4] = torch.where(pole > 0, lat_hi, lat_all[:, 4])
    lat_all[:, 3] = torch.where(pole < 0, lat_lo, lat_all[:, 3])
    la0 = bins_of(lat_all.amin(1), lat_lo, lat_hi, n_lat)
    la1 = bins_of(lat_all.amax(1), lat_lo, lat_hi, n_lat)
    lon_all = torch.cat([lo, torch.stack(lon_ext, dim=1)], dim=1)
    lo_min = torch.where(pole != 0, lon_lo, lon_all.amin(1))
    lo_max = torch.where(pole != 0, lon_hi, lon_all.amax(1))
    crossing = ((lo_max - lo_min) > np.pi) & (pole == 0)
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    pos_min = torch.where(lon_all > 0, lon_all, inf).amin(1)
    neg_max = torch.where(lon_all < 0, lon_all, -inf).amax(1)
    none = torch.full_like(la0, -1)
    rect = torch.stack([
        la0, la1,
        torch.where(crossing, bins_of(pos_min, lon_lo, lon_hi, n_lon),
                    bins_of(lo_min, lon_lo, lon_hi, n_lon)),
        torch.where(crossing, n_lon - 1, bins_of(lo_max, lon_lo, lon_hi,
                                                 n_lon)),
        torch.where(crossing, la0, none), torch.where(crossing, la1, none),
        torch.where(crossing, 0, none),
        torch.where(crossing, bins_of(neg_max, lon_lo, lon_hi, n_lon), none),
    ], dim=1)
    return rect.to(torch.int32)


#: cells per chunk of the plain rectangles, and expanded entries per lat
#: band of the plain expansion (bounds the plain version's temporaries)
_RECT_CHUNK = 1 << 22
_BAND_ENTRIES = 1 << 26


def _locator_bins_torch(lat, lon, n_lat: int, n_lon: int, window):
    """Plain K7-loc: (bins (n_bins, k_cap) i32 -1 padded, k_cap, counts
    (n_bins,) i32, rect (N, 8) i32) — the rectangles, their expansion
    (repeat_interleave), a sort of packed bin * (N + 1) + cell keys and the
    densify, as `_bbox_entries`, `build_locator_csr` and `densify_csr`.
    The expansion runs in bands of whole lat rows; the bands' sorted keys
    concatenate in bin order, so the result is the one global sort's."""
    n, dev = lat.shape[0], lat.device
    n_bins = n_lat * n_lon
    rect = torch.cat([_rect_torch(lat[s:s + _RECT_CHUNK],
                                  lon[s:s + _RECT_CHUNK], n_lat, n_lon,
                                  window)
                      for s in range(0, n, _RECT_CHUNK)]) if n else \
        torch.zeros((0, 8), dtype=torch.int32, device=dev)
    rec = torch.cat([rect[:, :4], rect[:, 4:]]).to(torch.int64)
    ids = torch.arange(n, dtype=torch.int64, device=dev).repeat(2)
    keep = rec[:, 0] >= 0
    rec, ids = rec[keep], ids[keep]
    wlo = rec[:, 3] - rec[:, 2] + 1
    total = int(((rec[:, 1] - rec[:, 0] + 1) * wlo).sum())
    rows = max(1, n_lat * _BAND_ENTRIES // max(total, 1))
    keys, counts = [], torch.zeros(n_bins, dtype=torch.int64, device=dev)
    for r0 in range(0, n_lat, rows):
        r1 = min(r0 + rows, n_lat)
        sel = (rec[:, 0] < r1) & (rec[:, 1] >= r0)
        la0 = torch.clamp(rec[sel, 0], min=r0)
        la1 = torch.clamp(rec[sel, 1], max=r1 - 1)
        lb0, w, cid = rec[sel, 2], wlo[sel], ids[sel]
        cnt = (la1 - la0 + 1) * w
        r = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev),
                                    cnt)
        o = torch.arange(r.shape[0], dtype=torch.int64, device=dev) \
            - (torch.cumsum(cnt, 0) - cnt)[r]
        dla = torch.div(o, w[r], rounding_mode="floor")
        b = (la0[r] + dla) * n_lon + lb0[r] + (o - dla * w[r])
        key, _ = torch.sort(b * (n + 1) + cid[r])
        keys.append(key)
        counts += torch.bincount(b, minlength=n_bins)
    k_cap = int(counts.max()) if total else 1
    starts = torch.cumsum(counts, 0) - counts
    bins = torch.full((n_bins, k_cap), -1, dtype=torch.int32, device=dev)
    offset = 0
    for key in keys:
        b = torch.div(key, n + 1, rounding_mode="floor")
        slot = offset + torch.arange(key.shape[0], device=dev) - starts[b]
        bins[b, slot] = (key - b * (n + 1)).to(torch.int32)
        offset += key.shape[0]
    return bins, k_cap, counts.to(torch.int32), rect


class _LocatorParams(ctypes.Structure):
    """Mirror of `LocatorParams` in csrc/locator.cu (same field order)."""
    _fields_ = [
        ("lat", ctypes.c_void_p), ("lon", ctypes.c_void_p),
        ("rect", ctypes.c_void_p), ("tile_count", ctypes.c_void_p),
        ("tile_fill", ctypes.c_void_p), ("tile_start", ctypes.c_void_p),
        ("entries", ctypes.c_void_p), ("big", ctypes.c_void_p),
        ("n_big", ctypes.c_void_p), ("k_max", ctypes.c_void_p),
        ("counts", ctypes.c_void_p), ("bins", ctypes.c_void_p),
        ("lat_lo", ctypes.c_double), ("lat_hi", ctypes.c_double),
        ("lon_lo", ctypes.c_double), ("lon_hi", ctypes.c_double),
        ("n", ctypes.c_longlong),
        ("n_lat", ctypes.c_int), ("n_lon", ctypes.c_int),
        ("k_cap", ctypes.c_int), ("big_cap", ctypes.c_int),
    ]


#: most cells of many tiles that `locator_bins` lists in its first try (the
#: list lives in the counts' buffer until the counts land; more such cells
#: rerun the first step with a list of their number)
_BIG_CAP = 1 << 30


def build_locator_kernel():
    """Compile csrc/locator.cu for sm_90a and bind its entry points."""
    lib = cuda_build.build("locator")
    for fn in (lib.locator_rects_launch, lib.locator_lists_launch,
               lib.locator_rows_launch):
        fn.argtypes = [ctypes.POINTER(_LocatorParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.locator_tile.restype = ctypes.c_int
    lib.locator_window_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_longlong, ctypes.c_void_p,
                                          ctypes.c_void_p]
    lib.locator_window_launch.restype = ctypes.c_int
    return lib


def locator_bins(lat, lon, n_lat: int, n_lon: int, window):
    """K7-loc wrapper: the dense (n_lat * n_lon, k_cap) bins of cells with
    (N, 3) f32 corner lat/lon over `window` (lat_lo, lat_hi, lon_lo,
    lon_hi); returns (bins, k_cap, counts, rect) as `_locator_bins_torch`.
    CUDA tensors launch csrc/locator.cu (three steps, a host read after
    each of the first two); CPU tensors run the plain version; anything
    else raises."""
    dev = lat.device
    for name, x in (("lat", lat), ("lon", lon)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 \
                or not x.is_contiguous() or x.device != dev \
                or x.shape[0] != lat.shape[0]:
            raise ValueError(f"locator_bins: {name} must be a contiguous "
                             f"(N, 3) float32 tensor on {dev}")
    n_bins = n_lat * n_lon
    if n_lat < 1 or n_lon < 1 or n_bins >= 2 ** 31:
        raise ValueError(f"locator_bins: {n_lat} x {n_lon} bins")
    if lat.shape[0] >= 2 ** 31:
        raise ValueError("locator_bins: cell ids must fit int32")
    if dev.type == "cpu":
        return _locator_bins_torch(lat, lon, n_lat, n_lon, window)
    if dev.type != "cuda":
        raise ValueError(f"locator_bins: unsupported device {dev}")
    lib = build_locator_kernel()
    n = lat.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    tile = lib.locator_tile()
    n_tiles = -(-n_lat // tile) * -(-n_lon // tile)
    i32 = dict(dtype=torch.int32, device=dev)
    rect = torch.empty((n, 8), **i32)
    counts = torch.empty(n_bins, **i32)
    tile_count = torch.zeros(n_tiles, **i32)
    scalars = torch.zeros(2, **i32)                  # n_big, k_max
    big, big_cap = counts, min(n_bins, _BIG_CAP)
    p = _LocatorParams(lat=lat.data_ptr(), lon=lon.data_ptr(),
                       rect=rect.data_ptr(), tile_count=tile_count.data_ptr(),
                       n_big=scalars.data_ptr(),
                       k_max=scalars.data_ptr() + 4,
                       counts=counts.data_ptr(),
                       lat_lo=window[0], lat_hi=window[1],
                       lon_lo=window[2], lon_hi=window[3], n=n,
                       n_lat=n_lat, n_lon=n_lon)
    while True:
        p.big, p.big_cap = big.data_ptr(), big_cap
        cuda_build.check("locator_rects", lib.locator_rects_launch(
            ctypes.byref(p), stream))
        launches["locator_rects"] += n > 0
        end = torch.cumsum(tile_count, 0, dtype=torch.int64)
        n_big, total = torch.stack([scalars[0].long(), end[-1]]).tolist()
        if n_big <= big_cap:
            break
        # more cells of many tiles than the list holds: count again with
        # a list of their number
        big, big_cap = torch.empty(n_big, **i32), n_big
        tile_count.zero_()
        scalars.zero_()
    start = end - tile_count
    entries = torch.empty(max(total, 1), dtype=torch.int64, device=dev)
    tile_fill = torch.zeros(n_tiles, **i32)
    p.tile_start, p.entries = start.data_ptr(), entries.data_ptr()
    p.tile_fill = tile_fill.data_ptr()
    cuda_build.check("locator_lists", lib.locator_lists_launch(
        ctypes.byref(p), stream))
    launches["locator_lists"] += 1
    k_cap = max(1, int(scalars[1]))
    bins = torch.empty((n_bins, k_cap), **i32)
    p.bins, p.k_cap = bins.data_ptr(), k_cap
    cuda_build.check("locator_rows", lib.locator_rows_launch(
        ctypes.byref(p), stream))
    launches["locator_rows"] += 1
    return bins, k_cap, counts, rect


def _locator_window_torch(lat, lon):
    """Plain `locator_window`: torch's min and max of the corners."""
    mm = torch.stack([lat.min(), lat.max(), lon.min(), lon.max()]).tolist()
    return mm[0] - 1e-4, mm[1] + 1e-4, mm[2] - 1e-4, mm[3] + 1e-4


def locator_window(lat, lon):
    """(lat_lo, lat_hi, lon_lo, lon_hi) of (N, 3) f32 corner lat/lon
    tensors, padded by 1e-4 as `_window`; the whole sphere for no cells.
    CUDA tensors launch csrc/locator.cu's one-pass extremes (one host
    read); CPU tensors run the plain version; anything else raises."""
    if not lat.shape[0]:
        return -np.pi / 2, np.pi / 2, -np.pi, np.pi
    dev = lat.device
    for name, x in (("lat", lat), ("lon", lon)):
        if x.dtype != torch.float32 or x.shape != lat.shape \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"locator_window: {name} must be a contiguous "
                             f"float32 tensor of lat's shape on {dev}")
    if dev.type == "cpu":
        return _locator_window_torch(lat, lon)
    if dev.type != "cuda":
        raise ValueError(f"locator_window: unsupported device {dev}")
    lib = build_locator_kernel()
    out = torch.tensor([2 ** 31 - 1, -2 ** 31] * 2 + [0, 0],
                       dtype=torch.int32, device=dev)
    cuda_build.check("locator_window", lib.locator_window_launch(
        lat.data_ptr(), lon.data_ptr(), lat.numel(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    launches["locator_window"] += 1
    got = np.array(out.tolist(), np.int32)
    keys = got[:4]
    mm = np.where(keys >= 0, keys, keys ^ 0x7FFFFFFF).astype(np.int32) \
        .view(np.float32).tolist()
    for a in (0, 1):              # a NaN makes both extremes NaN
        if got[4 + a]:
            mm[2 * a] = mm[2 * a + 1] = float("nan")
    return mm[0] - 1e-4, mm[1] + 1e-4, mm[2] - 1e-4, mm[3] + 1e-4


def bin_locator(lat, lon, dims_scale: float = 1.0):
    """The quantized tier's dense locator of cells with (N, 3) f32 corner
    lat/lon tensors, on their device: sqrt(N/2) bins per axis (times
    dims_scale) over `locator_window`.  Returns (Locator, k_cap, counts,
    rect); equal to densify_csr(build_locator_csr(...)) for the same
    lat/lon.  K7-loc on CUDA tensors, the plain version on CPU ones."""
    side = np.sqrt(max(lat.shape[0], 1) / 2)
    if dims_scale != 1.0:
        side *= dims_scale
    n_lat = n_lon = max(1, int(side))
    window = locator_window(lat, lon)
    bins, k_cap, counts, rect = locator_bins(lat, lon, n_lat, n_lon, window)
    dev = lat.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    loc = Locator(bins=bins, lat_lo=f32(window[0]), lat_hi=f32(window[1]),
                  lon_lo=f32(window[2]), lon_hi=f32(window[3]),
                  dims=torch.tensor([n_lat, n_lon], dtype=torch.int32,
                                    device=dev))
    return loc, k_cap, counts, rect


def locator_rows(loc: Locator, pos, dims=None):
    """The locator row of each point, clipped into the grid as
    sample_locator's: pos (L, 3) -> (radius (L,), row (L,) i64).  dims:
    (n_lat, n_lon) as ints, to spare the host read of loc.dims in a
    loop."""
    r = _radius(pos)
    lat = torch.asin(pos[:, 2] / r)
    lon = torch.atan2(pos[:, 1], pos[:, 0])
    n_lat, n_lon = dims or (int(d) for d in loc.dims.tolist())
    bl = torch.clamp(((lat - loc.lat_lo) / (loc.lat_hi - loc.lat_lo)
                      * float(n_lat)).to(torch.int32), 0, n_lat - 1)
    bo = torch.clamp(((lon - loc.lon_lo) / (loc.lon_hi - loc.lon_lo)
                      * float(n_lon)).to(torch.int32), 0, n_lon - 1)
    return r, (bl * n_lon + bo).long()


def sample_locator(cells: Cells, loc: Locator, pos, dims=None):
    """Point query through the locator, batched over lanes: pos (L, 3) ->
    (hit (L,) bool, value (L,) f32).  Equals sample_brute_force (the
    lowest-id containing cell: each row lists its candidates in ascending
    id order) at O(K) instead of O(N) per query (ref fallback:
    deviceCode.cu:116-123).  dims as `locator_rows`."""
    r, row = locator_rows(loc, pos, dims)
    cand = loc.bins[row]                                       # (L, K)
    safe = torch.clamp(cand, min=0).long()
    radial, planes = candidate_tests(cells, safe, pos, r)
    inside = (cand >= 0) & radial & planes.all(dim=-1)
    hit = inside.any(dim=1)
    slot = inside.to(torch.uint8).argmax(dim=1)
    idx = safe.gather(1, slot[:, None])[:, 0]
    layer = find_layer(cells.height[idx], cells.num_layers[idx], r)
    return hit, torch.where(hit, cells.value[idx, layer], 0.0)
