"""Carry state from the JAX package into this one, as numpy arrays.

Each function takes an object of the JAX package (or anything with the
same field names) whose leaves `np.asarray` accepts, and builds this
package's NamedTuple on `device`.  The tests hand both packages the same
scene and tables through these; nothing here imports jax — the caller
passes the objects in.

The JAX quantized tier stores its gather tables in the 128-lane row
layout of icon_rt_tpu/utils/layout.py `pack_table`: logical (N, W) rows as
(N/f, f*W'), W' = W or the next power of two that divides 128.  This
package keeps them unpacked; `_unpack_table` is that layout's inverse.
"""
from __future__ import annotations

import numpy as np
import torch

from .data.animation import Animation
from .data.device_scene import DeviceScene
from .data.icfile import ICDataset
from .models.accel import GridAccel, ShellAccel
from .models.cells import Cells, CellStats, check_ceilings, shell_range
from .models.finemap import FineMap
from .models.locator import Locator
from .models.qcells import QuantizedCells, check_q_ceilings
from .models.shells import RadialBands
from .models.transfunc import Transfunc
from .models.wedges import Wedges, wedge_shell
from .ops.fast import PackedCells
from .ops.render import LaunchParams
from .parallel.scene_shard import ShardedScene


def to_tensor(a, device="cpu") -> torch.Tensor:
    """np.asarray(a) as a tensor on `device`; uint32 arrays (framebuffers)
    become int32 tensors holding the same bits."""
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _convert(obj, cls, device):
    return cls(**{f: to_tensor(getattr(obj, f), device) for f in cls._fields})


def dataset(ds) -> ICDataset:
    """A JAX-package ICDataset (numpy already) as this package's ICDataset."""
    return ICDataset(*(np.asarray(getattr(ds, f)) for f in
                       ("lat", "lon", "num_layers", "height", "value")))


def cells(c, device="cpu") -> Cells:
    """A JAX Cells, with the radial shell that the port's Cells keep
    (models/cells.py `shell_range`) computed from its h_bot and h_top."""
    check_ceilings(np.asarray(c.height), np.asarray(c.num_layers))
    return Cells(**{f: to_tensor(getattr(c, f), device)
                    for f in Cells._fields if f != "shell"},
                 shell=to_tensor(shell_range(c.h_bot, c.h_top), device))


def locator(loc, device="cpu") -> Locator:
    return _convert(loc, Locator, device)


def grid_accel(a, device="cpu") -> GridAccel:
    """A JAX GridAccel (dims, bounds, value ranges, majorants)."""
    return _convert(a, GridAccel, device)


def shell_accel(a, device="cpu") -> ShellAccel:
    """A JAX ShellAccel (dims, spherical bounds, value ranges, majorants)."""
    return _convert(a, ShellAccel, device)


def radial_bands(b, device="cpu") -> RadialBands:
    return _convert(b, RadialBands, device)


def transfunc(tf, device="cpu") -> Transfunc:
    return _convert(tf, Transfunc, device)


def packed_cells(p, device="cpu") -> PackedCells:
    """A JAX PackedCells: the f32 tier's (N, 16) test rows, or the wedge
    tier's (N, 32) ones (pack_cells_wedge), with prof and rgb."""
    return _convert(p, PackedCells, device)


def wedges(w, device="cpu") -> Wedges:
    """A JAX Wedges (verts, scalars, cell_offset and the static layer_pad)
    as this package's Wedges, with the radial shell (models/wedges.py
    `wedge_shell`) that the JAX Wedges does not keep."""
    return Wedges(verts=to_tensor(w.verts, device),
                  scalars=to_tensor(w.scalars, device),
                  cell_offset=to_tensor(w.cell_offset, device),
                  layer_pad=int(w.layer_pad),
                  shell=to_tensor(wedge_shell(np.asarray(w.verts)), device))


def launch_params(lp, device="cpu") -> LaunchParams:
    return _convert(lp, LaunchParams, device)


def _unpack_table(x, w: int, n: int | None = None) -> np.ndarray:
    """(N/f, f*W') packed rows -> (N, w) (the same bytes minus slot
    padding), trimmed to n rows when given.  A slot is w wide when it
    divides the row (tables packed at their true width), else the next
    power of two (aligned slots)."""
    x = np.asarray(x)
    minor = x.shape[-1]
    wa = w
    if minor % w:
        wa = 1
        while wa < w:
            wa *= 2
        if minor % wa:
            raise ValueError(f"row width {minor} fits no packing of {w}")
    out = x.reshape(-1, wa)[:, :w]
    return np.ascontiguousarray(out[:n] if n is not None else out)


def quantized_cells(q, device="cpu", n: int | None = None) -> QuantizedCells:
    """A JAX QuantizedCells (packed test12/value_q/alpha_q, h_frac (1, Lm)
    u16 or (N, Lm) f32) as this package's unpacked tables, trimmed to n
    cells (default: the fewest rows any packed table holds; the rest are
    all-zero pack padding no locator row names)."""
    hf = np.asarray(q.h_frac)
    lm = hf.shape[1]
    t12 = _unpack_table(q.test12, 12)
    vq = _unpack_table(q.value_q, lm)
    aq = _unpack_table(q.alpha_q, lm)
    n = min(len(t12), len(vq), len(aq)) if n is None else n
    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    f32 = lambda v: torch.tensor(float(np.float32(v)), dtype=torch.float32,
                                 device=device)
    tab = getattr(q, "alpha_tab", None)
    out = QuantizedCells(
        test12=t(t12[:n]), h_frac=t(hf.astype(np.float32)),
        value_q=t(vq[:n]), alpha_q=t(aq[:n]),
        value_lo=f32(q.value_lo), value_hi=f32(q.value_hi),
        alpha_max=f32(q.alpha_max),
        alpha_tab=None if tab is None else np.asarray(tab, np.uint8).copy())
    check_q_ceilings(out.h_frac, out.test12)
    return out


def locator_packed(loc, k_cap: int, device="cpu") -> Locator:
    """A JAX Locator whose bins are pack_table'd at their true width
    (models/locator.py `densify_csr`) as this package's (n_bins, k_cap)
    Locator."""
    n_lat, n_lon = (int(v) for v in np.asarray(loc.dims))
    bins = _unpack_table(loc.bins, k_cap, n_lat * n_lon).astype(np.int32)
    return locator(loc._replace(bins=bins), device)


def finemap(fm, device="cpu") -> FineMap:
    """A JAX FineMap (pairs packed 32 bins per 128-byte row) as this
    package's unpacked (n_fine, 4) u8 slots."""
    f_lat, f_lon = (int(v) for v in np.asarray(fm.dims))
    slots = _unpack_table(fm.pairs, 4, f_lat * f_lon)
    return FineMap(slots=to_tensor(slots, device),
                   **{f: to_tensor(getattr(fm, f), device)
                      for f in ("lat_lo", "lat_hi", "lon_lo", "lon_hi",
                                "dims")})


def device_scene(dsc, n: int, device="cpu") -> DeviceScene:
    """A JAX DeviceScene (packed tables, pad rows past n) as this package's
    DeviceScene of n cells: its quantized cells, radial bands and stats."""
    st = dsc.stats
    stats = CellStats(*(np.array(getattr(st, f), np.float32, copy=True)
                        for f in CellStats._fields))
    return DeviceScene(cells=quantized_cells(dsc.cells, device, n),
                       bands=radial_bands(dsc.bands, device), stats=stats)


def sharded_scene(scene, slab: int, n: int, k_cap: int,
                  device="cpu") -> ShardedScene:
    """Slab `slab` of a JAX ShardedScene (every slab's tables stacked and
    padded to a common shape, packed as pack_table rows) as this package's
    one-slab ShardedScene: the slab's n cells and its locator's n_lat *
    n_lon rows of k_cap candidates, padding dropped."""
    dims = np.asarray(scene.dims)[slab]
    hf = np.asarray(scene.h_frac)[slab]
    lm = hf.shape[1]
    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    f32 = lambda v: torch.tensor(float(np.float32(v)), dtype=torch.float32,
                                 device=device)
    out = ShardedScene(
        test12=t(_unpack_table(np.asarray(scene.test12)[slab], 12, n)),
        h_frac=t(hf.astype(np.float32) if hf.shape[0] == 1
                 else hf[:n].astype(np.float32)),
        value_q=t(_unpack_table(np.asarray(scene.value_q)[slab], lm, n)),
        alpha_q=t(_unpack_table(np.asarray(scene.alpha_q)[slab], lm, n)),
        value_lo=f32(scene.value_lo), value_hi=f32(scene.value_hi),
        alpha_max=f32(np.asarray(scene.alpha_max)[slab]),
        bins=t(_unpack_table(np.asarray(scene.bins)[slab], k_cap,
                             int(dims[0]) * int(dims[1])).astype(np.int32)),
        **{f: f32(np.asarray(getattr(scene, f))[slab])
           for f in ("lat_lo", "lat_hi", "lon_lo", "lon_hi")},
        dims=t(dims.astype(np.int32)))
    check_q_ceilings(out.h_frac, out.test12)
    return out


def animation(anim) -> Animation:
    """A JAX Animation (numpy geometry and values) as this package's."""
    return Animation([dataset(anim.dataset_at(t))
                      for t in range(anim.num_timesteps)])
