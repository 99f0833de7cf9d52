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
batched over lanes.  `wedge_shell` bounds the radii at which any wedge's
Newton inversion can accept a point, so that both reject a point outside
it before the locate.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.icfile import MAX_LAYERS, ICDataset
from ..ops.uelems import newton
from ..utils.vecmath import np_to_cartesian
from .cells import Cells, find_layer, square_bounds
from .locator import Locator, locator_rows

F = np.float32
#: the wedge shell's margin beyond the wedges' hulls: this share of each
#: wedge's bounding-box diagonal, plus this share of its largest vertex
#: norm (`wedge_shell` gives the argument)
SHELL_DIAGONAL = 4e-3
SHELL_NORM = 2e-5


class Wedges(NamedTuple):
    verts: torch.Tensor         # (W, 6, 3) f32: bottom corners, then top
    scalars: torch.Tensor       # (W, 6) f32
    cell_offset: torch.Tensor   # (N,) i32: the first wedge of each column
    layer_pad: int              # the radial search window's width (>= 1)
    shell: torch.Tensor         # (4,) f32 radial shell (`wedge_shell`)


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
                  layer_pad=min(sag + 1, MAX_LAYERS),
                  shell=t(wedge_shell(verts)))


def _triangle_min_norm(a, b, c):
    """(W,) f64 distance from the origin to the triangles (a, b, c), each
    (W, 3) f64: the nearest point of the supporting plane where it lies
    inside the triangle, else the nearest of its three edges (the
    construction of `column_min_norm`, at any radius).  A degenerate
    triangle can only come out nearer than it is."""
    def seg_min(p, q):
        d = q - p
        t = np.clip(-np.sum(p * d, axis=-1)
                    / np.maximum(np.sum(d * d, axis=-1), 1e-300), 0.0, 1.0)
        x = p + t[:, None] * d
        return np.sqrt(np.sum(x * x, axis=-1))

    n = np.cross(b - a, c - a)
    nn = np.maximum(np.sum(n * n, axis=-1), 1e-300)
    off = np.sum(a * n, axis=-1)
    q = (off / nn)[:, None] * n
    sides = np.stack([np.sum(np.cross(v - u, q - u) * n, axis=-1)
                      for u, v in ((a, b), (b, c), (c, a))], axis=-1)
    inside = (sides >= 0).all(axis=-1) | (sides <= 0).all(axis=-1)
    edges = np.minimum(seg_min(a, b), np.minimum(seg_min(b, c),
                                                 seg_min(c, a)))
    return np.where(inside, np.minimum(np.abs(off) / np.sqrt(nn), edges),
                    edges)


def wedge_shell(verts) -> np.ndarray:
    """The radial shell outside of which no wedge's Newton inversion
    accepts a point, as (4,) f32 [r_lo, r_hi, s_lo, s_hi]: the radii, then
    the same bounds on the squared radius (models/cells.py
    `square_bounds`, as `shell_range` gives the cells' shell).  verts
    (W, 6, 3), wedges with NaN vertices left out (their inversion never
    converges); no wedge gives [+inf, -inf].

    The argument, in f64 and rounded outward to f32.  A wedge's bottom
    corners v0..v2 lie at one height and its top corners v3..v5 on the
    same rays at another, so its hull lies in the cone over either face,
    between the two: no point of the hull is nearer the origin than the
    nearer face (`_triangle_min_norm`), none farther than its farthest
    vertex (the norm is convex).  The shape map X(r, s, t) of
    ops/uelems.py `newton` sends the parametric prism (r, s, t >= 0,
    r + s <= 1, t <= 1) into that hull.  Newton accepts P when its last step was below 1e-4 in each
    coordinate and the point it reached lies in the prism widened by
    1e-6.  The point it stepped from, pc, then lies within ~3.3e-4 of the
    prism, so X(pc) within sqrt(3) * 1.001 * D * 3.3e-4 of the hull, D the
    wedge's bounding-box diagonal (each column of the Jacobian is a convex
    combination of edges, widened by the 1e-4); and X(pc) - P equals the
    Jacobian times the step up to the f32 rounding of the residual, so
    |X(pc) - P| <= 3.0e-4 * D plus ~20 ULPs of the vertex norms.  In all
    |P| stays within 8.7e-4 * D + 1.2e-6 |v|max of the hull's radii; the
    margin SHELL_DIAGONAL * D + SHELL_NORM * |v|max doubles that and also
    covers the f32 rounding of the kernel's x*x + y*y + z*z and of the
    corners off their common rays.  A wedge too small for Newton's
    singularity test (tol = D**2 * 1e-6 below the 1e-30 at which the
    determinant is replaced by 1) could accept any point: then the shell
    is everything."""
    v = np.asarray(verts, np.float64).reshape(-1, 6, 3)
    inf = np.inf
    norm = np.sqrt(np.sum(v * v, axis=-1)).max(axis=1)          # (W,)
    diag = np.sqrt(np.sum((v.max(axis=1) - v.min(axis=1)) ** 2, axis=-1))
    if np.any(diag * diag * 1e-6 < 1e-29):
        lo, hi = F(-inf), F(inf)
    else:
        margin = SHELL_DIAGONAL * diag + SHELL_NORM * norm
        near = np.fmin(_triangle_min_norm(v[:, 0], v[:, 1], v[:, 2]),
                       _triangle_min_norm(v[:, 3], v[:, 4], v[:, 5]))
        lo64 = np.fmin.reduce(near - margin, initial=inf)
        hi64 = np.fmax.reduce(norm + margin, initial=-inf)
        lo, hi = F(lo64), F(hi64)
        if lo > lo64:                     # round outward
            lo = np.nextafter(lo, F(-inf))
        if hi < hi64:
            hi = np.nextafter(hi, F(inf))
    return np.array([lo, hi, *square_bounds(lo, hi)], F)


def in_wedge_shell(wedges: Wedges, pos):
    """The wedge shell test of pos (L, 3), the kernel's: the squared radius
    x*x + y*y + z*z against shell[2:], False for NaN.  A point that fails
    it lies in no wedge (`wedge_shell`)."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    s = x * x + y * y + z * z
    return (s >= wedges.shell[2]) & (s <= wedges.shell[3])


def shell_probes(wedges: Wedges, columns: int, seed: int):
    """Seeded points dense where `wedge_shell`'s edges are decided, to hold
    the shell against a search that does not use it (`wedge_candidates`):
    along the ray through the centre of each probed column's bottom face
    and top face, steps of 1e-4 of the wedge's diagonal across it, in the
    column's lowest and highest wedge; each vertex of those two wedges
    moved radially by the same steps and sideways; and 200 points in
    random directions at each shell radius.  The columns probed are the
    one with the nearest bottom-face centre, the one with the farthest top
    vertex and `columns` seeded ones.  Returns (P, 3) f32 on the wedges'
    device."""
    off = wedges.cell_offset.long()
    top = torch.cat([off[1:], off.new_tensor([wedges.verts.shape[0]])]) - 1
    lowest = wedges.verts[off].double().cpu().numpy()      # (N, 6, 3)
    highest = wedges.verts[top].double().cpu().numpy()
    rng = np.random.default_rng(seed)
    near = np.linalg.norm(lowest[:, :3].mean(1), axis=1)
    far = np.linalg.norm(highest[:, 3:], axis=2).max(1)
    cols = np.unique(np.concatenate([
        [np.argmin(near), np.argmax(far)],
        rng.integers(0, off.shape[0], columns)]))
    pts = []
    steps = np.linspace(-30, 30, 21) * 1e-4
    for c in cols:
        for verts in (lowest[c], highest[c]):
            d = np.linalg.norm(verts.max(0) - verts.min(0))
            for face in (verts[:3], verts[3:]):
                ctr = face.mean(0)
                u = ctr / np.linalg.norm(ctr)
                pts.append(ctr + np.outer(steps * d, u))
            for k in range(6):
                u = verts[k] / np.linalg.norm(verts[k])
                side = rng.normal(size=(6, 3)) * 1e-3 * d
                pts.append(verts[k] + np.outer(steps[::4] * d, u) + side)
    lo, hi = (float(x) for x in wedges.shell[:2])
    dirs = rng.normal(size=(200, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for r in (lo, hi):
        pts.append(dirs * (r * (1.0 + rng.uniform(-1e-4, 1e-4, (200, 1)))))
    return torch.from_numpy(np.concatenate(pts).astype(F)).to(
        wedges.verts.device)


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
    """Point query through the wedge shell test, the locator's candidate
    columns, the radial window and the Newton wedge test, batched over
    lanes: pos (L, 3) -> (hit (L,) bool, value (L,) f32).  The first wedge
    whose inversion contains the point wins, in (candidate, window offset)
    order, as the JAX package's argmax (the reference's BVH order is
    arbitrary; wedges tile a column, so at most boundary ties differ).  A
    point outside `Wedges.shell` lies in no wedge: on the CPU only the
    points inside it run the search; on a card every point runs it and the
    test masks the result (fixed shapes, no host read, as the lock-step
    loop's CUDA graph needs).  dims as `locator_rows`."""
    inner = in_wedge_shell(wedges, pos)
    hit = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    value = torch.zeros(pos.shape[0], dtype=torch.float32, device=pos.device)
    rows = torch.nonzero(inner).squeeze(1) if pos.device.type == "cpu" \
        else None
    c = wedge_candidates(cells, wedges, loc, pos if rows is None
                         else pos[rows], dims)
    n = c["hit"].shape[0]
    hits = c["hit"].reshape(n, c["hit"][0].numel() if n else 0)
    first = torch.argmax(hits.to(torch.uint8), dim=1) if n else \
        torch.zeros(0, dtype=torch.int64, device=pos.device)
    got = c["value"].reshape(hits.shape).gather(1, first[:, None])
    found = hits.any(dim=1)
    got = torch.where(found, got[:, 0], 0.0)
    if rows is None:
        found = found & inner
        return found, torch.where(found, got, 0.0)
    return hit.index_put((rows,), found), value.index_put((rows,), got)


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
