"""Multi-device rendering over a `torch.distributed` device mesh.

The counterpart of icon_rt_tpu/parallel/sharded.py.  One process is one
rank, and every rank holds the whole scene (cells, LUT, locator, accel,
bands); only framebuffer state is sharded.  Two mesh axes:

  * "tiles"   — `render_frame_sharded` (every raygen: the parity raygens
                through K8, the fast one through K1) gives each tile a
                block of rows in natural order (`tile_pixels`).  The fast
                paths instead deal the frame's covered pixels, sorted by
                expected ray cost (ops/order.py `pixel_order`), round-robin
                over the tiles (`plan_fast_sharding`), so every rank gets
                the same cost mix and the uncovered tail is dealt to no
                one.  No communication until the frame is gathered.
  * "samples" — the ranks of one tile render the SAME lanes at different
                sample ids (accum_id * S + s) in raw mode (K1, K2 or K8);
                K10's mean composite (ops/composite.py) joins them with one
                all_reduce(SUM).  For pixels whose rays all hit (or all
                miss) the shell this equals sequential accumulation; at
                silhouette pixels the batch average weights the written
                samples uniformly where a running average would weight them
                by arrival order -- the JAX package's documented difference.

A rank's lanes and its accum (p_local, 4) / fb (p_local,) follow JAX's row
tiles or its dealing plan; the plan's -1 padding lanes sit at the tail of
each rank's row and are left out of the launch, since K1, K2 and K8 take
their lane count at run time.  `gather_frame` brings the tiles' frames to
one rank (the row tiles then are the natural frame), and
`scatter_fast_frame` restores natural pixel order of a dealt frame on the
host.

`mesh=None` everywhere means one process without a process group: a 1 x 1
mesh whose collectives are no-ops (the single-process path the sharded
paths are held against).  The backend is always the caller's choice
(`make_mesh`): NCCL with one rank per card, gloo for CPU tensors or for
ranks that share a card (NCCL refuses two ranks on one card).  Nothing
chooses or switches it.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops.composite import finalize_mean, mean_payload
from ..ops.fast import alloc_raw, track_f32
from ..ops.fastq import track_q
from ..ops.render import parity_track

SUM, MIN = dist.ReduceOp.SUM, dist.ReduceOp.MIN


# ===========================================================================
# The mesh and its collectives
# ===========================================================================

def device_mesh(backend: str, shape, names):
    """A DeviceMesh of `shape` named `names` over every rank of the
    initialised default process group, whose backend must be `backend`."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("device_mesh: no process group (see ranks.py)")
    if dist.get_backend() != backend:
        raise ValueError(f"device_mesh: the process group's backend is "
                         f"{dist.get_backend()}, not {backend}")
    n = dist.get_world_size()
    if int(np.prod(shape)) != n:
        raise ValueError(f"device_mesh: {shape} != {n} ranks")
    # the device type names the transport: gloo's collectives run on the
    # host, NCCL's on the cards
    return DeviceMesh("cuda" if backend == "nccl" else "cpu",
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_mesh(backend: str, tiles: int | None = None, samples: int = 1):
    """The ("tiles", "samples") mesh over the process group's ranks
    (icon_rt_tpu/parallel/sharded.py:44): rank = tile * samples + sample."""
    n = dist.get_world_size()
    if tiles is None:
        tiles = n // samples
    return device_mesh(backend, (tiles, samples), ("tiles", "samples"))


def axis_size(mesh, name: str) -> int:
    """Size of mesh axis `name` (1 without a mesh or without the axis)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on mesh axis `name` (0 as `axis_size`)."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def all_reduce(x, op, mesh, name: str):
    """all_reduce x in place over mesh axis `name` (no-op on an axis of one
    rank).  Over NCCL and over gloo the tensor stays where it is: gloo runs
    its all_reduce of CUDA tensors itself (PyTorch documents it)."""
    if axis_size(mesh, name) > 1:
        dist.all_reduce(x, op=op, group=mesh.get_group(name))
    return x


def gather_frame(mesh, x, name: str = "tiles"):
    """This rank's (p_local, ...) part of a framebuffer tensor, gathered
    along mesh axis `name` to the axis's first rank, which gets the
    (n * p_local, ...) numpy concatenation in axis order (the one device ->
    host copy of a frame, as icon_rt_tpu/parallel/sharded.py:158); the
    other ranks get None.  Gloo gathers host tensors only (PyTorch's backend
    table), so its group gathers a host copy."""
    n = axis_size(mesh, name)
    if n == 1:
        return x.cpu().numpy()
    g = mesh.get_group(name)
    if dist.get_backend(g) == "gloo":
        x = x.cpu()
    first = dist.get_rank(g) == 0
    parts = [torch.empty_like(x) for _ in range(n)] if first else None
    dist.gather(x.contiguous(), parts, dst=dist.get_global_rank(g, 0),
                group=g)
    return torch.cat(parts).cpu().numpy() if first else None


class Timer:
    """Seconds per named part, accumulated into `sums` (a dict, or None for
    no timing); each part ends in a device synchronise when timed."""

    def __init__(self, sums: dict | None, device):
        self.sums, self.device = sums, device
        self.t = time.perf_counter()

    def mark(self, name: str):
        if self.sums is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.sums[name] = self.sums.get(name, 0.0) + now - self.t
        self.t = now


# ===========================================================================
# Row tiles: every raygen over the mesh
# ===========================================================================

def tile_pixels(mesh, width: int, height: int, device) -> torch.Tensor:
    """This rank's pixel ids: row block `tile` of the frame's natural order
    (all of it without a "tiles" axis).  The pixel count must divide the
    tiles axis (icon_rt_tpu/parallel/sharded.py:105)."""
    total = width * height
    n_tiles = axis_size(mesh, "tiles")
    if total % n_tiles:
        raise ValueError("pixel count must divide the tiles axis")
    p_local = total // n_tiles
    base = axis_index(mesh, "tiles") * p_local
    return torch.arange(base, base + p_local, dtype=torch.int32,
                        device=device)


def render_frame_sharded(mesh, cells, tf, accel, lp, accum, fb, *,
                         width: int, height: int, accel_mode: str = "grid",
                         sampler: str = "locator", locator=None,
                         raygen: str = "accel", packed=None, bands=None,
                         timings: dict | None = None):
    """One progressive step over the ("tiles", "samples") mesh
    (icon_rt_tpu/parallel/sharded.py:87-141): rank (t, s) renders row tile
    t (`tile_pixels`) at sample accum_id * S + s; a samples axis of S > 1
    joins the S samples by K10's mean and one all_reduce(SUM).

    raygen "ae" (or `accel` None) runs K8's AE raygen, "accel" K8 on
    `accel` (a ShellAccel for accel_mode "sphere", a GridAccel for "grid"),
    both with `sampler` ("locator" needs `locator`, or "brute"); "fast"
    runs K1 on `packed`, `locator` and `bands` (cells and tf unused).
    accum (p_local, 4) f32 and fb (p_local,) int32 are this rank's tile,
    updated IN PLACE and returned; `gather_frame` gives the natural frame.
    mesh None is one process.  timings: a dict of seconds per part
    ("track", "composite", "all_reduce"), or None."""
    pix = tile_pixels(mesh, width, height, accum.device)
    if raygen == "fast":
        def track(lp_, pix_, acc, fb_, n, out):
            track_f32(packed, locator, bands, lp_, pix_, acc, fb_,
                      width=width, height=height, samples=n, out=out)
    elif raygen in ("ae", "accel"):
        mode = "ae" if raygen == "ae" or accel is None else accel_mode

        def track(lp_, pix_, acc, fb_, n, out):
            parity_track(cells, tf, lp_, acc, fb_, width=width,
                         height=height, raygen=mode, sampler=sampler,
                         locator=locator,
                         accel=None if mode == "ae" else accel, pix=pix_,
                         out=out)
    else:
        raise ValueError(f"unknown raygen {raygen!r}")
    return _fast_sharded(mesh, track, lp, accum, fb, pix, 1, timings)


# ===========================================================================
# The fast raygen over the mesh, dealt by cost
# ===========================================================================

def plan_fast_sharding(perm: np.ndarray, n_active: int, n_tiles: int,
                       chunk: int = 4096) -> np.ndarray:
    """Deal the covered prefix of a cost-sorted pixel permutation across
    `n_tiles` ranks.  Returns (n_tiles, p_local) i32 pixel ids, -1 for
    padding lanes; p_local is a multiple of `chunk`
    (icon_rt_tpu/parallel/sharded.py:175, bit for bit)."""
    n_active = max(int(n_active), 1)
    n_proc = -(-n_active // (n_tiles * chunk)) * n_tiles * chunk
    padded = np.full(n_proc, -1, np.int32)
    padded[:n_active] = perm[:n_active]
    return np.ascontiguousarray(padded.reshape(-1, n_tiles).T)


def local_lanes(mesh, local_pix: np.ndarray, device) -> torch.Tensor:
    """This rank's dealt pixel ids: its tile's row of the plan without the
    -1 padding at its tail, as an int32 tensor on `device`."""
    row = np.asarray(local_pix)[axis_index(mesh, "tiles")]
    n = int(np.count_nonzero(row >= 0))
    return torch.from_numpy(np.ascontiguousarray(row[:n])).to(device)


def alloc_fast_sharded_frame(mesh, local_pix, device):
    """This rank's dealt-order accum (p_local, 4) f32 and fb (p_local,)
    int32, zero (icon_rt_tpu/parallel/sharded.py:362)."""
    p_local = np.asarray(local_pix).shape[1]
    return (torch.zeros((p_local, 4), dtype=torch.float32, device=device),
            torch.zeros(p_local, dtype=torch.int32, device=device))


def scatter_fast_frame(fb_dealt: np.ndarray, local_pix: np.ndarray,
                       width: int, height: int) -> np.ndarray:
    """Host-side: dealt-order framebuffer -> natural pixel order (background
    zero for pixels that were never dealt)."""
    out = np.zeros(width * height, fb_dealt.dtype)
    flat = np.asarray(local_pix).reshape(-1)
    m = flat >= 0
    out[flat[m]] = np.asarray(fb_dealt).reshape(-1)[m]
    return out


def _fast_sharded(mesh, track, lp, accum, fb, pix, samples: int,
                  timings: dict | None):
    """The frame step of every mesh path (icon_rt_tpu/parallel/sharded.py:
    87-141, 188-256).

    track(lp, pix, accum, fb, samples, out) runs K1, K2 or K8 over `pix`.  On a
    samples axis of one rank the lanes are tracked into accum/fb as on one
    card, `samples` in-lane samples per launch.  Otherwise the rank tracks
    sample accum_id * S + s in raw mode, and K10's mean composite with one
    all_reduce(SUM) accumulates the S samples at accum_id."""
    n_s = axis_size(mesh, "samples")
    if samples > 1 and n_s > 1:
        raise ValueError("in-lane samples need a tiles-only mesh")
    n = pix.shape[0]
    tm = Timer(timings, pix.device)
    if n_s == 1:
        track(lp, pix, accum[:n], fb[:n], samples, None)
        tm.mark("track")
        return accum, fb
    s = axis_index(mesh, "samples")
    raw = alloc_raw(n, pix.device)
    track(lp._replace(accum_id=lp.accum_id * n_s + s), pix, None, None, 1,
          raw)
    tm.mark("track")
    total = mean_payload(raw.wrote, raw.ca)
    tm.mark("composite")
    all_reduce(total, SUM, mesh, "samples")
    tm.mark("all_reduce")
    finalize_mean(total, accum[:n], fb[:n], lp.accum_id)
    tm.mark("composite")
    return accum, fb


def render_frame_fast_sharded(mesh, packed, loc, bands, lp, accum, fb, pix,
                              *, width: int, height: int, samples: int = 1,
                              preserve_cache: bool = True,
                              timings: dict | None = None):
    """One progressive fast-raygen step of the f32 tier (K1) over the mesh
    (icon_rt_tpu/parallel/sharded.py:259).  pix: this rank's dealt lanes
    (`local_lanes`); accum/fb: its dealt frame (`alloc_fast_sharded_frame`),
    updated IN PLACE and returned.  samples > 1: in-lane samples on a
    tiles-only mesh.  timings: a dict of seconds per part ("track",
    "composite", "all_reduce"), or None."""
    def track(lp_, pix_, acc, fb_, n, out):
        track_f32(packed, loc, bands, lp_, pix_, acc, fb_, width=width,
                  height=height, samples=n, preserve_cache=preserve_cache,
                  out=out)

    return _fast_sharded(mesh, track, lp, accum, fb, pix, samples, timings)


def render_frame_fastq_sharded(mesh, q, loc, bands, tf, lp, accum, fb, pix,
                               *, width: int, height: int, samples: int = 1,
                               preserve_cache: bool = True, finemap=None,
                               timings: dict | None = None):
    """The quantized tier's step (K2; icon_rt_tpu/parallel/sharded.py:299),
    the north-star composition of BASELINE configs[4]; `finemap` turns the
    two-stage locate on.  The contract of `render_frame_fast_sharded`."""
    def track(lp_, pix_, acc, fb_, n, out):
        track_q(q, loc, bands, tf, lp_, pix_, acc, fb_, width=width,
                height=height, samples=n, preserve_cache=preserve_cache,
                finemap=finemap, out=out)

    return _fast_sharded(mesh, track, lp, accum, fb, pix, samples, timings)
