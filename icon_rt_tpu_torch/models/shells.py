"""Radial-shell majorant bands — the empty-space accelerator of the fast path.

ICON scalar fields vary most strongly with HEIGHT, so a majorant that
depends only on radius captures most of the empty-space structure while
keeping the traversal pure arithmetic:

  * band edges are B+1 radii spanning [r_bot, r_top];
  * a ray's crossings with every band edge are closed-form sphere
    intersections from the precomputed o.o / o.d;
  * the per-band majorant is one of B (<= 64) values.

Per-band value ranges use the exact per-layer range (the layer value is
piecewise constant), so these majorants are tighter than the reference's
unsorted-range quirk; the bands back the fast raygen only.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.icfile import ICDataset
from .accel import _rasterize, max_opacity

F = np.float32


class RadialBands(NamedTuple):
    edges: torch.Tensor          # (B+1,) f32 radii, ascending
    value_ranges: torch.Tensor   # (B, 2) f32
    max_opacities: torch.Tensor  # (B,) f32

    @property
    def num_bands(self) -> int:
        return self.value_ranges.shape[0]


def build_radial_bands(ds: ICDataset, num_bands: int = 64,
                       device="cpu") -> RadialBands:
    idx = np.arange(ds.num_cells)
    r_lo = float(ds.height[:, 0].min()) if ds.num_cells else 0.0
    r_hi = float(ds.height[idx, ds.num_layers].max()) if ds.num_cells else 1.0
    edges = np.linspace(r_lo, r_hi, num_bands + 1).astype(F)
    vr_lo = np.full(num_bands, np.finfo(F).max, F)
    vr_hi = np.full(num_bands, -np.finfo(F).max, F)
    max_l = int(ds.num_layers.max()) if ds.num_cells else 0
    span = max(r_hi - r_lo, 1e-30)
    for L in range(max_l):
        sel = ds.num_layers > L
        if sel.all():   # uniform layer count: skip the (slow) fancy index
            h0 = ds.height[:, L]
            h1 = ds.height[:, L + 1]
            v = ds.value[:, L].astype(F)
        else:
            h0 = ds.height[sel, L]
            h1 = ds.height[sel, L + 1]
            v = ds.value[sel, L].astype(F)
        b0 = np.clip(((h0 - r_lo) / span * num_bands).astype(np.int64),
                     0, num_bands - 1)
        b1 = np.clip(((h1 - r_lo) / span * num_bands).astype(np.int64),
                     0, num_bands - 1)
        n = b0.shape[0]
        lo_idx = np.zeros((n, 3), np.int64)
        up_idx = np.zeros((n, 3), np.int64)
        lo_idx[:, 0] = b0
        up_idx[:, 0] = b1
        _rasterize(vr_lo, vr_hi, lo_idx, up_idx, v, v,
                   np.array([num_bands, 1, 1], np.int64))
    return RadialBands(
        edges=torch.from_numpy(edges).to(device),
        value_ranges=torch.from_numpy(np.stack([vr_lo, vr_hi], axis=1)
                                      ).to(device),
        max_opacities=torch.zeros(num_bands, dtype=torch.float32,
                                  device=device),
    )



def build_radial_bands_wedge(ds: ICDataset, num_bands: int = 64,
                             device="cpu") -> RadialBands:
    """Radial bands of the fast WEDGE tier (ops/fast.py sampler='wedge'),
    bit-equal to the JAX package's icon_rt_tpu/models/shells.py
    `build_radial_bands_wedge`.  Unlike build_radial_bands, the per-layer
    values are the reference's per-wedge constants bv (models/wedges.py
    `bv_all`, ref: hostCode.cu:574,583-586), and each wedge's radial
    extent is inflated downward by its column's flat-face sagitta (a flat
    face at height h spans radii [h * mn, h]), the global band range
    included."""
    from .wedges import bv_all, column_min_norm

    mn = column_min_norm(ds.lat, ds.lon)
    bv = bv_all(ds.value, ds.num_layers)
    idx = np.arange(ds.num_cells)
    r_lo = float((ds.height[:, 0] * mn).min()) if ds.num_cells else 0.0
    r_hi = float(ds.height[idx, ds.num_layers].max()) if ds.num_cells else 1.0
    edges = np.linspace(r_lo, r_hi, num_bands + 1).astype(F)
    vr_lo = np.full(num_bands, np.finfo(F).max, F)
    vr_hi = np.full(num_bands, -np.finfo(F).max, F)
    max_l = int(ds.num_layers.max()) if ds.num_cells else 0
    span = max(r_hi - r_lo, 1e-30)
    for L in range(max_l):
        sel = ds.num_layers > L
        h0 = ds.height[sel, L] * mn[sel]
        h1 = ds.height[sel, L + 1]
        v = bv[sel, L].astype(F)
        b0 = np.clip(((h0 - r_lo) / span * num_bands).astype(np.int64),
                     0, num_bands - 1)
        b1 = np.clip(((h1 - r_lo) / span * num_bands).astype(np.int64),
                     0, num_bands - 1)
        n = b0.shape[0]
        lo_idx = np.zeros((n, 3), np.int64)
        up_idx = np.zeros((n, 3), np.int64)
        lo_idx[:, 0] = b0
        up_idx[:, 0] = b1
        _rasterize(vr_lo, vr_hi, lo_idx, up_idx, v, v,
                   np.array([num_bands, 1, 1], np.int64))
    return RadialBands(
        edges=torch.from_numpy(edges).to(device),
        value_ranges=torch.from_numpy(np.stack([vr_lo, vr_hi], axis=1)
                                      ).to(device),
        max_opacities=torch.zeros(num_bands, dtype=torch.float32,
                                  device=device),
    )

def update_band_majorants(bands: RadialBands, lut,
                          tf_value_range) -> RadialBands:
    """TF-edit handler for the radial bands (kernel K5b, the reference's
    computeMaxOpacities range-max, ref: hostCode.cu:362-434)."""
    mo = max_opacity(bands.value_ranges, lut, tf_value_range)
    return bands._replace(max_opacities=mo)
