"""Multi-timestep animation: a time series of scalar fields on one ICON grid
(the counterpart of icon_rt_tpu/data/animation.py).

Geometry (planes, heights, locator, bands, fine map) is built once; each
timestep swaps only the per-layer values, so advancing time re-bakes the
tables the tracker classifies through (K5a on the f32 tier, K5c-q on the
quantized tier) and rebuilds no acceleration structure.  The sharded
paths also re-order the covered pixels (K6) and re-deal them over the
mesh's tiles for each timestep's camera.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from .icfile import ICDataset, read_ic


class Animation:
    """values[t] on a fixed grid; construct from datasets or .ic paths."""

    def __init__(self, datasets: Sequence[ICDataset]):
        if not datasets:
            raise ValueError("empty animation")
        base = datasets[0]
        for d in datasets[1:]:
            if d.num_cells != base.num_cells \
                    or not np.array_equal(d.lat, base.lat) \
                    or not np.array_equal(d.height, base.height):
                raise ValueError("animation timesteps must share the grid")
        self.geometry = base
        self.values = np.stack([d.value for d in datasets])  # (T, N, 32)

    @classmethod
    def from_files(cls, paths: Sequence[str]) -> "Animation":
        return cls([read_ic(p) for p in paths])

    @property
    def num_timesteps(self) -> int:
        return self.values.shape[0]

    def dataset_at(self, t: int) -> ICDataset:
        g = self.geometry
        return ICDataset(g.lat, g.lon, g.num_layers, g.height, self.values[t])


def _packed_at(anim: Animation, cells, tf, test_rows, t: int):
    """The f32 tier's tables of timestep t: K5a over its values."""
    from ..ops.fast import PackedCells, classify_bake
    vals = torch.from_numpy(np.ascontiguousarray(anim.values[t])).to(
        cells.value.device)
    prof, rgb = classify_bake(cells, tf, values=vals)
    return PackedCells(test=test_rows, prof=prof, rgb=rgb)


def animate_fast(anim: Animation, cells, loc, bands, tf, lp_for_frame,
                 width: int, height: int, samples_per_frame: int = 4
                 ) -> Iterator[np.ndarray]:
    """Render the time series on the fast path (K5a, then K1 per sample,
    every pixel in natural order); yields one (H*W,) uint32 framebuffer per
    timestep.  cells/loc/bands are built from anim.geometry on the device
    the frames render on; lp_for_frame(t, s) returns the launch params of
    timestep t, sample s (the camera may move per timestep)."""
    from ..ops.fast import pack_test_rows, render_frame_fast
    from ..ops.render import alloc_frame

    dev = cells.value.device
    test_rows = pack_test_rows(cells)
    for t in range(anim.num_timesteps):
        packed = _packed_at(anim, cells, tf, test_rows, t)
        accum, fb = alloc_frame(width, height, device=dev)
        for s in range(samples_per_frame):
            render_frame_fast(cells, packed, loc, bands, lp_for_frame(t, s),
                              accum, fb, width=width, height=height)
        yield fb.cpu().numpy().view(np.uint32)


def _sharded_frames(mesh, steps, n_steps: int, render_step, lp_for_frame,
                    r_in, r_out, width: int, height: int,
                    samples_per_frame: int, chunk: int, device,
                    timings: dict | None):
    """The per-timestep loop of both sharded animations: for each of the
    n_steps timesteps' tables (from the iterable `steps`; timed as "bake"),
    order and deal the covered pixels of its camera,
    render samples_per_frame samples through render_step(tables, lp, accum,
    fb, pix, timings), and gather the dealt framebuffer.  Yields the
    natural-order (H*W,) uint32 frame on the mesh's first rank, None on the
    others."""
    from ..ops.order import pixel_order
    from ..parallel.sharded import (Timer, alloc_fast_sharded_frame,
                                    axis_index, axis_size, gather_frame,
                                    local_lanes, plan_fast_sharding,
                                    scatter_fast_frame)

    n_tiles = axis_size(mesh, "tiles")
    steps = iter(steps)
    for t in range(n_steps):
        tm = Timer(timings, device)
        tables = next(steps)
        tm.mark("bake")
        perm, n_active = pixel_order(lp_for_frame(t, 0), r_in, r_out, width,
                                     height)
        local = plan_fast_sharding(perm.cpu().numpy(), n_active, n_tiles,
                                   chunk=chunk)
        pix = local_lanes(mesh, local, device)
        accum, fb = alloc_fast_sharded_frame(mesh, local, device)
        tm.mark("order")
        for s in range(samples_per_frame):
            render_step(tables, lp_for_frame(t, s), accum, fb, pix, timings)
        tm = Timer(timings, device)
        # the ranks of sample 0 hold the frame; their tiles axis gathers it
        got = gather_frame(mesh, fb) if axis_index(mesh, "samples") == 0 \
            else None
        tm.mark("gather")
        yield None if got is None else scatter_fast_frame(
            got.view(np.uint32), local, width, height)


def animate_fast_sharded(anim: Animation, cells, loc, bands, tf,
                         lp_for_frame, mesh, width: int, height: int,
                         samples_per_frame: int = 4, chunk: int = 4096,
                         timings: dict | None = None
                         ) -> Iterator[np.ndarray | None]:
    """The f32 time series over a ("tiles", "samples") mesh (icon_rt_tpu/
    data/animation.py:52; BASELINE configs[4]'s composition on the f32
    tier): per timestep K5a, the K6 order of its camera dealt over the
    tiles, samples_per_frame samples through parallel/sharded.py
    `render_frame_fast_sharded`, the dealt fb gathered.  Yields the
    natural-order (H*W,) uint32 frame (zero where nothing was dealt) on the
    mesh's first rank, None on the others; mesh=None is one process."""
    from ..models.cells import compute_stats
    from ..ops.fast import pack_test_rows
    from ..parallel.sharded import render_frame_fast_sharded

    stats = compute_stats(anim.geometry)
    dev = cells.value.device
    test_rows = pack_test_rows(cells)
    steps = (_packed_at(anim, cells, tf, test_rows, t)
             for t in range(anim.num_timesteps))

    def render_step(packed, lp, accum, fb, pix, tim):
        render_frame_fast_sharded(mesh, packed, loc, bands, lp, accum, fb,
                                  pix, width=width, height=height,
                                  timings=tim)

    return _sharded_frames(mesh, steps, anim.num_timesteps, render_step,
                           lp_for_frame, stats.spherical_bounds_lo[0],
                           stats.spherical_bounds_hi[0], width, height,
                           samples_per_frame, chunk, dev, timings)


def animate_fastq_sharded(geometry_q, value_q_steps, loc, bands, tf,
                          lp_for_frame, mesh, stats, width: int, height: int,
                          samples_per_frame: int = 4, chunk: int = 4096,
                          finemap=None, timings: dict | None = None
                          ) -> Iterator[np.ndarray | None]:
    """The QUANTIZED time series over a ("tiles", "samples") mesh -- the
    north-star composition, BASELINE configs[4] (icon_rt_tpu/data/
    animation.py:98): per timestep the value plane swapped and K5c-q's full
    bake, the K6 order dealt over the tiles, samples_per_frame samples of K2
    through parallel/sharded.py `render_frame_fastq_sharded`, the dealt fb
    gathered.  Yields as `animate_fast_sharded`; mesh=None is one process.

    geometry_q: models/qcells.QuantizedCells of the grid.  value_q_steps:
    per timestep an (N, Lm) u8 array or tensor (a tensor on the device
    never passes through the host).  The geometry, locator, fine map and
    bands serve every timestep: build the bands' value ranges wide enough
    for every timestep's values (the fine map holds candidate columns,
    which the values do not move)."""
    from ..models.qcells import bake_alpha_q
    from ..parallel.sharded import render_frame_fastq_sharded

    dev = geometry_q.test12.device

    def steps():
        for vq in value_q_steps:
            vq = torch.as_tensor(vq).to(dev)
            # alpha_tab=None: the values changed, so bake_alpha_q's
            # unchanged-table shortcut must not keep the stale alpha_q
            yield bake_alpha_q(geometry_q._replace(value_q=vq,
                                                   alpha_tab=None), tf)

    def render_step(q, lp, accum, fb, pix, tim):
        render_frame_fastq_sharded(mesh, q, loc, bands, tf, lp, accum, fb,
                                   pix, width=width, height=height,
                                   finemap=finemap, timings=tim)

    return _sharded_frames(mesh, steps(), len(value_q_steps), render_step,
                           lp_for_frame, stats.spherical_bounds_lo[0],
                           stats.spherical_bounds_hi[0], width, height,
                           samples_per_frame, chunk, dev, timings)
