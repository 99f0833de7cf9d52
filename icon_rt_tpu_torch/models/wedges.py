"""Per-layer wedge (triangular prism) extraction and the unstructured
sampler -- the reference's cuBQL mode (ref: icon_rt/hostCode.cu:557-650,
deviceCode.cu:90-115).

Each column layer becomes one 6-vertex wedge with FLAT bottom and top
faces (no bulge) and per-vertex scalars.  Faithful quirk: the reference's
'#if 1' branch (hostCode.cu:583-586) gives all six vertices the BOTTOM
value bv, the layer-midpoint average
    bv(0) = value[0];  bv(h) = (getValue(h[h-1]) + getValue(h[h])) / 2
(hostCode.cu:574), so cuBQL-mode images are piecewise constant with
smoothed, shifted values relative to the analytic sampler.

Cell location reuses the 2-D locator: wedge side faces lie in the same
origin-through planes as the column side planes, so the candidate columns
are the same; only the radial layer needs a search window, whose width
(`layer_pad`) is bounded by the flat-face sagitta computed at build time.

The builders are host numpy, bit-equal to the JAX package's
icon_rt_tpu/models/wedges.py; `sample_wedges` is the plain version of the
wedge sampler of kernel K8 (csrc/parity.cu `sample<kWedge>`, K9-p),
batched over lanes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.icfile import MAX_LAYERS, ICDataset
from ..ops.uelems import newton
from ..utils.vecmath import np_to_cartesian
from .cells import Cells, find_layer
from .locator import Locator, locator_rows

F = np.float32


class Wedges(NamedTuple):
    verts: torch.Tensor         # (W, 6, 3) f32: bottom corners, then top
    scalars: torch.Tensor       # (W, 6) f32
    cell_offset: torch.Tensor   # (N,) i32: the first wedge of each column
    layer_pad: int              # the radial search window's width (>= 1)


def _corners(ds: ICDataset, sel: np.ndarray, h: np.ndarray) -> np.ndarray:
    """(n_sel, 3, 3) Cartesian corners of the flat face at heights h of the
    columns sel."""
    sph = np.stack([np.repeat(h[:, None], 3, 1), ds.lat[sel], ds.lon[sel]],
                   axis=-1).astype(F)
    return np_to_cartesian(sph)


def _sag_layers(ds: ICDataset, sel: np.ndarray, L: int,
                bottom: np.ndarray) -> int:
    """The largest flat-face sagitta of layer L of the columns sel (the
    bottom-face centroid below the bottom height), in layer thicknesses,
    rounded up; `bottom` is the face's corners."""
    hb = ds.height[sel, L]
    bary = bottom.mean(axis=1)
    sag = hb - np.sqrt(np.sum(bary * bary, axis=-1))
    thick = np.maximum(ds.height[sel, L + 1] - hb, 1e-30)
    return int(np.ceil((sag / thick).max()))


def _layers(ds: ICDataset):
    """(L, the columns with a layer L) for every layer index."""
    for L in range(int(ds.num_layers.max()) if ds.num_cells else 0):
        yield L, np.nonzero(ds.num_layers > L)[0]


def build_wedges(ds: ICDataset, device="cpu") -> Wedges:
    """One wedge per column layer (column-major: a column's layers are
    consecutive, from cell_offset), all six vertices carrying the layer's
    `bv_all` scalar, with the search window `layer_pad`."""
    counts = ds.num_layers.astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])[:-1].astype(np.int32)
    total = int(counts.sum())
    verts = np.zeros((total, 6, 3), F)
    scalars = np.zeros((total, 6), F)
    bv = bv_all(ds.value, ds.num_layers)
    sag = 0
    for L, sel in _layers(ds):
        widx = offsets[sel] + L
        verts[widx, :3] = _corners(ds, sel, ds.height[sel, L])
        verts[widx, 3:] = _corners(ds, sel, ds.height[sel, L + 1])
        scalars[widx] = bv[sel, L][:, None]
        sag = max(sag, _sag_layers(ds, sel, L, verts[widx, :3]))

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Wedges(verts=t(verts), scalars=t(scalars), cell_offset=t(offsets),
                  layer_pad=min(sag + 1, MAX_LAYERS))


def layer_pad(ds: ICDataset) -> int:
    """The wedges' radial search window: one more than the largest
    flat-face sagitta in layer thicknesses, at most MAX_LAYERS -- the
    `layer_pad` of `build_wedges`, without building the wedges."""
    sag = max((_sag_layers(ds, sel, L, _corners(ds, sel, ds.height[sel, L]))
               for L, sel in _layers(ds)), default=0)
    return min(sag + 1, MAX_LAYERS)


def wedge_candidates(cells: Cells, wedges: Wedges, loc: Locator, pos,
                     dims=None):
    """Every Newton test of the wedge sampler on pos (L, 3): for each
    candidate k of the point's locator bin and window offset d, the wedge
    of layer find_layer(r) + d.  Returns a dict of (L, K, pad) tensors --
    "hit" (valid candidate, layer in range, inside), "value", "iters" (the
    Newton's iterations), "in_range" (valid and layer < num_layers),
    "wid" (the wedge id, clamped into the table) -- plus "cand" (L, K) and
    "r" (L,)."""
    r, row = locator_rows(loc, pos, dims)
    cand = loc.bins[row]                                       # (L, K)
    L, K = cand.shape
    pad = wedges.layer_pad
    valid = cand >= 0
    safe = torch.clamp(cand, min=0).long()
    nl = cells.num_layers[safe]                                # (L, K)
    base = find_layer(cells.height[safe].reshape(L * K, MAX_LAYERS),
                      nl.reshape(-1), r[:, None].expand(L, K).reshape(-1)
                      ).reshape(L, K)
    layer = base[..., None] + torch.arange(pad, device=pos.device)
    in_range = valid[..., None] & (layer >= 0) & (layer < nl[..., None])
    w = wedges.cell_offset[safe].long()[..., None] \
        + torch.clamp(layer, 0, MAX_LAYERS - 1)
    wid = torch.clamp(w, 0, wedges.verts.shape[0] - 1).reshape(-1)
    P = pos[:, None, :].expand(L, K * pad, 3).reshape(-1, 3)
    inside, value, iters = newton(P, wedges.verts[wid], wedges.scalars[wid],
                                  return_iters=True)
    shape = (L, K, pad)
    hit = inside.reshape(shape) & in_range
    return dict(hit=hit, value=torch.where(hit, value.reshape(shape), 0.0),
                iters=iters.reshape(shape), in_range=in_range,
                wid=wid.reshape(shape), cand=cand, r=r)


def sample_wedges(cells: Cells, wedges: Wedges, loc: Locator, pos,
                  dims=None):
    """Point query through the locator's candidate columns, the radial
    window and the Newton wedge test, batched over lanes: pos (L, 3) ->
    (hit (L,) bool, value (L,) f32).  The first wedge whose inversion
    contains the point wins, in (candidate, window offset) order, as the
    JAX package's argmax (the reference's BVH order is arbitrary; wedges
    tile a column, so at most boundary ties differ).  dims as
    `locator_rows`."""
    c = wedge_candidates(cells, wedges, loc, pos, dims)
    hits = c["hit"].reshape(pos.shape[0], -1)
    first = torch.argmax(hits.to(torch.uint8), dim=1)
    value = c["value"].reshape(pos.shape[0], -1).gather(1, first[:, None])
    hit = hits.any(dim=1)
    return hit, torch.where(hit, value[:, 0], 0.0)


def bv_all(values: np.ndarray, num_layers: np.ndarray) -> np.ndarray:
    """(N, MAX_LAYERS) per-wedge constant scalar of every layer, the
    midpoint average of getValue at the layer's two bounding heights
    (ref: hostCode.cu:574 and its getValue height-snap quirk: getValue
    at height[k] resolves to value[max(k-1, 0)]): bv[0] = value[0];
    bv[L] = (value[max(L-2,0)] + value[max(L-1,0)]) / 2.  Entries past num_layers are value[0]-ish garbage; callers mask by
    layer count."""
    values = np.asarray(values, F)
    n, ml = values.shape
    L = np.arange(ml)
    prev = values[:, np.maximum(L - 2, 0)]
    cur = values[:, np.maximum(L - 1, 0)]
    out = 0.5 * (prev + cur)
    out[:, 0] = values[:, 0]
    return out.astype(F)


def column_min_norm(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """(N,) minimum norm over the chordal hull of a column's three corner
    unit vectors: a flat triangular face at height h spans radii
    [h * mn, h], so wedge radial extents (and band majorant attribution)
    inflate downward by this factor."""
    lat = np.asarray(lat, F)
    lon = np.asarray(lon, F)
    cl = np.cos(lat)
    u = np.stack([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)],
                 axis=-1)                                     # (N, 3, 3)

    def seg_min(a, b):
        """Min |x| over the segment a..b, per row."""
        d = b - a
        tt = -np.sum(a * d, axis=-1) / np.maximum(
            np.sum(d * d, axis=-1), 1e-30)
        tt = np.clip(tt, 0.0, 1.0)
        p = a + tt[:, None] * d
        return np.sqrt(np.sum(p * p, axis=-1))

    # closest point of the supporting plane; valid when inside the triangle
    n = np.cross(u[:, 1] - u[:, 0], u[:, 2] - u[:, 0])
    nn = np.maximum(np.sum(n * n, axis=-1), 1e-30)
    c = np.sum(u[:, 0] * n, axis=-1)
    q = (c / nn)[:, None] * n

    def tri_in(q):
        """Barycentric inside test: the sub-triangle dets share a sign."""
        s = []
        for i in range(3):
            a, b = u[:, i], u[:, (i + 1) % 3]
            s.append(np.sum(np.cross(b - a, q - a) * n, axis=-1))
        s = np.stack(s, axis=-1)
        return (s >= 0).all(axis=-1) | (s <= 0).all(axis=-1)

    edge_min = np.minimum(seg_min(u[:, 0], u[:, 1]),
                          np.minimum(seg_min(u[:, 1], u[:, 2]),
                                     seg_min(u[:, 2], u[:, 0])))
    mn = np.where(tri_in(q), np.minimum(np.abs(c) / np.sqrt(nn), edge_min),
                  edge_min)
    return np.minimum(mn, 1.0).astype(F)
