"""Scene-sharded rendering: the cells split into latitude slabs, one slab
per rank (the counterpart of icon_rt_tpu/parallel/scene_shard.py).

Each cell lives on exactly one slab, assigned by its centroid latitude at
equal-count quantiles, and a rank holds only its slab's quantized tables
and locator.  Every slab rank tracks the whole ray against its slab (a
point in another slab's cell locates to "no cell", a null collision) with
its own tracking stream (`rng_salt = slab + 1`) and reports its first
accepted collision's t (+inf without one).  Delta tracking is memoryless,
so the first collision over the slabs -- the minimum t, and that slab's
colour -- is distributed as the whole ray's first collision.  The
majorants stay global (bands built from the whole quantized dataset), so
every slab's acceptance test is conservative everywhere.

The composite (JAX's `_argmin_select`, three O(L) collectives, no gather of
the slabs' samples): all_reduce(MIN) of t; K10's candidate mask (this slab
if its t is the minimum, else D) and all_reduce(MIN), which breaks ties
toward the lowest slab; K10's payload mask (the winner's colour, else 0)
and all_reduce(SUM); K10's first-hit finalize.  The mesh is ("slabs",) or
("slabs", "tiles"): with tiles the frame's pixels are additionally split in
equal natural-order rows, and the composite reduces over "slabs" only.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..data.icfile import ICDataset
from ..models.locator import Locator, bin_locator
from ..models.qcells import (QuantizedCells, bake_alpha_q, quantize_cells,
                             quantize_dataset_values)
from ..models.transfunc import Transfunc
from ..ops.composite import (finalize_first_hit, select_candidates,
                             select_payload)
from ..ops.fast import alloc_raw
from ..ops.fastq import track_q
from .sharded import MIN, SUM, Timer, all_reduce, axis_index, axis_size, \
    device_mesh, tile_pixels


class ShardedScene(NamedTuple):
    """One slab's tables, unpadded (the JAX package stacks and pads every
    slab's for shard_map; here each rank holds its own only).  The field
    names are JAX's."""
    test12: torch.Tensor     # (N_s, 12) f32
    h_frac: torch.Tensor     # (1, Lm) or (N_s, Lm) f32
    value_q: torch.Tensor    # (N_s, Lm) u8
    alpha_q: torch.Tensor    # (N_s, Lm) u8
    value_lo: torch.Tensor   # () f32 (global range, shared)
    value_hi: torch.Tensor   # () f32
    alpha_max: torch.Tensor  # () f32 this slab's dequant scale
    bins: torch.Tensor       # (n_lat * n_lon, k_cap) i32, -1 padded
    lat_lo: torch.Tensor     # () f32 this slab's locator window
    lat_hi: torch.Tensor
    lon_lo: torch.Tensor
    lon_hi: torch.Tensor
    dims: torch.Tensor       # (2,) i32

    def cells(self) -> QuantizedCells:
        return QuantizedCells(
            test12=self.test12, h_frac=self.h_frac, value_q=self.value_q,
            alpha_q=self.alpha_q, value_lo=self.value_lo,
            value_hi=self.value_hi, alpha_max=self.alpha_max)

    def locator(self) -> Locator:
        return Locator(bins=self.bins, lat_lo=self.lat_lo,
                       lat_hi=self.lat_hi, lon_lo=self.lon_lo,
                       lon_hi=self.lon_hi, dims=self.dims)


def make_slab_mesh(backend: str, slabs: int, tiles: int | None = None):
    """The ("slabs",) mesh, or with `tiles` the ("slabs", "tiles") mesh, over
    the process group's ranks: rank = slab * tiles + tile."""
    if tiles is None:
        return device_mesh(backend, (slabs,), ("slabs",))
    return device_mesh(backend, (slabs, tiles), ("slabs", "tiles"))


def partition_dataset(ds: ICDataset, n_slabs: int) -> list[np.ndarray]:
    """Equal-count latitude-quantile partition; per-slab cell index arrays,
    every cell in exactly one slab (icon_rt_tpu/parallel/scene_shard.py:85,
    bit for bit)."""
    clat = ds.lat.mean(axis=1)
    order = np.argsort(clat, kind="stable")
    return [np.sort(part) for part in np.array_split(order, n_slabs)]


def _slab_dataset(ds: ICDataset, idx: np.ndarray) -> ICDataset:
    return dataclasses.replace(
        ds, lat=ds.lat[idx], lon=ds.lon[idx], num_layers=ds.num_layers[idx],
        height=ds.height[idx], value=ds.value[idx])


def _slab_locator(sub: ICDataset, device):
    """(Locator, k) of a slab's cells: K7-loc on the card, its plain version
    on the CPU (equal to densify_csr(build_locator_csr(sub), k))."""
    lat = torch.from_numpy(np.ascontiguousarray(sub.lat)).to(device)
    lon = torch.from_numpy(np.ascontiguousarray(sub.lon)).to(device)
    return bin_locator(lat, lon)[:2]


def build_sharded_scene(ds: ICDataset, tf: Transfunc, n_slabs: int,
                        slab: int, device="cuda"
                        ) -> tuple[ShardedScene, int, ICDataset]:
    """Slab `slab` of `n_slabs` on `device` (icon_rt_tpu/parallel/
    scene_shard.py:93): the dataset's values snapped to the 256-level grid,
    the slab's cells quantized with the GLOBAL value range and baked with
    `tf`, its locator binned at k_cap, the largest bin occupancy over every
    slab (each rank bins every slab's cells to learn it, and keeps only its
    own).  Returns (scene, k_cap, ds_quantized); build the global radial
    bands from ds_quantized so the majorants bound the field every slab
    samples."""
    ds_q, lo, hi = quantize_dataset_values(ds)
    parts = partition_dataset(ds_q, n_slabs)
    loc, k_cap = None, 1
    for s, idx in enumerate(parts):
        loc_s, k = _slab_locator(_slab_dataset(ds_q, idx), device)
        k_cap = max(k_cap, k)
        if s == slab:
            loc = loc_s
    bins = loc.bins
    if bins.shape[1] < k_cap:
        bins = torch.nn.functional.pad(bins, (0, k_cap - bins.shape[1]),
                                       value=-1)
    q = bake_alpha_q(quantize_cells(_slab_dataset(ds_q, parts[slab]),
                                    value_range=(lo, hi), device=device), tf)
    scene = ShardedScene(
        test12=q.test12, h_frac=q.h_frac, value_q=q.value_q,
        alpha_q=q.alpha_q, value_lo=q.value_lo, value_hi=q.value_hi,
        alpha_max=q.alpha_max, bins=bins.contiguous(), lat_lo=loc.lat_lo,
        lat_hi=loc.lat_hi, lon_lo=loc.lon_lo, lon_hi=loc.lon_hi,
        dims=loc.dims)
    return scene, k_cap, ds_q


def render_frame_scene_sharded(mesh, scene: ShardedScene, bands,
                               tf: Transfunc, lp, accum, fb, *, width: int,
                               height: int, timings: dict | None = None):
    """One progressive sample over the scene-sharded mesh
    (icon_rt_tpu/parallel/scene_shard.py:185).  scene: this rank's slab;
    bands: the GLOBAL radial bands; accum (P, 4) / fb (P,): this rank's
    tile of the frame (`tile_pixels`), the same on every slab, updated IN
    PLACE and returned.  timings: a dict of seconds per part ("track",
    "t_min", "cand", "payload", "composite"), or None."""
    n_slabs = axis_size(mesh, "slabs")
    slab = axis_index(mesh, "slabs")
    pix = tile_pixels(mesh, width, height, accum.device)
    tm = Timer(timings, accum.device)
    raw = alloc_raw(pix.shape[0], accum.device)
    track_q(scene.cells(), scene.locator(), bands, tf, lp, pix, None, None,
            width=width, height=height, out=raw, rng_salt=slab + 1)
    tm.mark("track")
    t_min = all_reduce(raw.t.clone(), MIN, mesh, "slabs")
    tm.mark("t_min")
    cand = select_candidates(raw.t, t_min, slab, n_slabs)
    tm.mark("composite")
    win = all_reduce(cand, MIN, mesh, "slabs")
    tm.mark("cand")
    send = select_payload(raw.t, t_min, win, raw.ca, slab)
    tm.mark("composite")
    all_reduce(send, SUM, mesh, "slabs")
    tm.mark("payload")
    # `wrote` (the ray met the shell) is the same on every slab
    finalize_first_hit(send, t_min, raw.wrote, accum, fb, lp.accum_id)
    tm.mark("composite")
    return accum, fb
