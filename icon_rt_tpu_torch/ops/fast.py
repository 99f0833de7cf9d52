"""The fast raygen: radial-band Woodcock tracking with a per-lane column cache.

Every pixel lane traces delta-tracking samples against the piecewise-
constant radial majorant bands (models/shells.py): band crossings are
closed-form sphere intersections, and a tentative collision inside one of
the lane's two cached columns is classified by pure arithmetic (plane tests
plus an ascending-first-match layer select against per-layer heights and
PRE-CLASSIFIED alpha baked at TF-edit time).  Only when a sample leaves
both cached columns does the lane query the locator, and the first column
a lane ever enters stays pinned in slot 0, so in-lane sample restarts land
back in cache.  The estimator is standard delta tracking with a
conservative majorant: unbiased, so converged images match the
reference-parity raygens.

Kernels of this module (each beside its plain-PyTorch version):

  K1+K4 `track_f32` (CUDA C++, csrc/track_f32.cu on the machine of
        csrc/track_common.cuh) — one thread per lane runs its pixel's
        `samples` samples to completion and writes the running average,
        sRGB and RGBA8 pack; in raw mode (`out=`) it stores one sample per
        lane for the multi-device composites (ops/composite.py) instead,
        and `rng_salt` re-keys the tracking streams.  Plain version:
        `_render_frame_fast_torch`, the lock-step loop `_track_torch` over
        the lanes with the same per-lane order of operations and RNG
        draws; the quantized tier
        (ops/fastq.py) runs the same loop on its own storage tier.
  K9-w  `track_wedge` (CUDA C++, csrc/track_wedge.cu, the same machine on
        the wedge tier csrc/tier_wedge.cuh) — the reference's cuBQL mode
        (-mode 2) on the fast raygen: containment and the layer pick
        compare the flat-face coordinate s = dot(P, n') with the heights,
        the radial bands stay radial.  Plain version: `_track_torch` on
        `_WedgeTier`, over the tables of `pack_cells_wedge`.
  K5a   `classify_bake` (Triton) — the TF-edit bake of per-(cell, layer)
        heights, classified alpha and RGB (of the cells' values, or of the
        wedge tier's per-wedge constants).  Plain version:
        `_profile_rows_torch` / `_classify_channels_torch`.
  K5c-f32 `pack_alpha_scale_parts` and `apply_opacity_scale` (Triton) —
        the scale-only opacity re-bake: alpha = A + B * scale, equal to a
        full K5a bake bit for bit.  Plain versions:
        `_alpha_scale_parts_torch`, `_apply_opacity_scale_torch`.

The lane setup `_init_lanes` and the tiers' locate are shared with the
march (ops/march.py).

The JAX package's TPU scheduling (batched refresh phases, compacted
services, `steps_per_refresh`, `chunk`, `outer_unroll`, `refresh_compact`,
`service_cap`) only decides WHEN each lane's work runs and is pinned to the
per-lane semantics implemented here, so it is not ported.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..data.icfile import MAX_LAYERS
from ..models.cells import Cells
from ..models.locator import Locator
from ..models.shells import RadialBands
from ..models.transfunc import Transfunc
from ..utils import cuda_build
from ..utils.lcg import lcg_init, lcg_next
from .render import _finalize

F32 = torch.float32
PROF_W = MAX_LAYERS * 2   # heights (32) + classified alpha (32)
TEST_W = 16
TEST_W_WEDGE = 32         # the f32 test row in 0..14, n' in 16..18
RGB_W = MAX_LAYERS * 3

#: per-sample step cap of a lane (the JAX loop's max_outer=16384 outer
#: iterations x 8 steps); a lane that reaches it ends its sample without a
#: collision.  No lane of the tests or of chip_smoke.py comes near it.
MAX_STEPS = 16384 * 8

#: kernel launches of K1 (track_f32), K9-w (track_wedge), K5a
#: (classify_bake) and the two K5c-f32 kernels (alpha_scale_parts,
#: apply_opacity_scale); the wrappers count only launches of the
#: CUDA/Triton kernels
launches = {"track_f32": 0, "track_wedge": 0, "classify_bake": 0,
            "alpha_scale_parts": 0, "apply_opacity_scale": 0}

tl = None          # triton.language, bound on the first Triton launch
_JITTED: dict = {}


def _jit(fn):
    """triton.jit(fn), compiled on first use (never at import: the CPU
    tests import this module and have no triton)."""
    global tl
    if fn.__name__ not in _JITTED:
        import triton
        import triton.language as tl_mod
        tl = tl_mod
        _JITTED[fn.__name__] = triton.jit(fn)
    return _JITTED[fn.__name__]



class PackedCells(NamedTuple):
    """Per-cell rows, split hot/cold.

    test: (N, 16) f32 — 3 side planes (nx,ny,nz,w)x3, h_bot, h_top,
          float(num_layers), pad.
    prof: (N, 64) f32 — per-layer ceiling heights h[1..32] (inf-padded past
          num_layers) then the CLASSIFIED per-layer ALPHA (h[32] | A[32]).
    rgb:  (N, 96) f32 — classified per-layer RGB planar (R|G|B), read once
          per finished sample at shade time.
    """
    test: torch.Tensor
    prof: torch.Tensor
    rgb: torch.Tensor


def pack_test_rows(cells: Cells) -> torch.Tensor:
    n = cells.num_cells
    rows = torch.zeros((n, TEST_W), dtype=F32, device=cells.planes.device)
    rows[:, 0:12] = cells.planes.reshape(n, 12)
    rows[:, 12] = cells.h_bot
    rows[:, 13] = cells.h_top
    rows[:, 14] = cells.num_layers.to(F32)
    return rows


# ===========================================================================
# K5a: the TF-edit bake
# ===========================================================================

def _classify_channels_torch(values, tf: Transfunc):
    """postClassify (ref: deviceCode.cu:127-135) per channel over (N, 32)
    values; returns [R, G, B, A] each (N, 32).  The reference's asymmetric
    lerp scales only the second LUT sample's alpha by the opacity scale."""
    size = tf.size
    vn = (values - tf.value_range[0]) \
        / (tf.value_range[1] - tf.value_range[0])
    vs = vn * float(size)
    idx = vs.to(torch.int32)
    frac = vs - idx.to(F32)
    i1 = torch.clamp(idx, 0, size - 1).long()
    i2 = torch.clamp(idx + 1, 0, size - 1).long()
    one = torch.ones((), dtype=F32, device=values.device)
    outs = []
    for c in range(4):
        lut_c = tf.values[:, c]
        scale = tf.opacity_scale.to(F32) if c == 3 else one
        outs.append(lut_c[i1] * frac + lut_c[i2] * (1.0 - frac) * scale)
    return outs


def _profile_rows_torch(height, value, num_layers, tf: Transfunc):
    """Plain-PyTorch K5a: (prof (N, 64), rgb (N, 96)) — see PackedCells."""
    heights_hi = torch.cat([height[:, 1:], height[:, -1:]], dim=1)
    k = torch.arange(1, MAX_LAYERS + 1, device=height.device)
    valid = k[None, :] <= num_layers[:, None]
    heights_hi = torch.where(valid, heights_hi, float("inf"))
    rr, gg, bb, aa = _classify_channels_torch(value, tf)
    prof = torch.cat([heights_hi, aa], dim=1)
    rgb = torch.cat([rr, gg, bb], dim=1)
    return prof, rgb


def _classify_kernel(height_ptr, value_ptr, nl_ptr, lut_ptr, tfr_ptr,
                     scale_ptr, prof_ptr, rgb_ptr, n_elem, S,
                     BLOCK: tl.constexpr):
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    msk = i < n_elem
    n = i // 32
    k = i - n * 32
    v0 = tl.load(tfr_ptr)
    v1 = tl.load(tfr_ptr + 1)
    scale = tl.load(scale_ptr)
    val = tl.load(value_ptr + i, mask=msk, other=0.0)
    vn = tl.math.div_rn(val - v0, v1 - v0)
    vs = vn * S.to(tl.float32)
    idx = vs.to(tl.int32)
    frac = vs - idx.to(tl.float32)
    i1 = tl.minimum(tl.maximum(idx, 0), S - 1)
    i2 = tl.minimum(tl.maximum(idx + 1, 0), S - 1)
    w2 = 1.0 - frac
    r = tl.load(lut_ptr + i1 * 4, mask=msk) * frac \
        + tl.load(lut_ptr + i2 * 4, mask=msk) * w2
    g = tl.load(lut_ptr + i1 * 4 + 1, mask=msk) * frac \
        + tl.load(lut_ptr + i2 * 4 + 1, mask=msk) * w2
    b = tl.load(lut_ptr + i1 * 4 + 2, mask=msk) * frac \
        + tl.load(lut_ptr + i2 * 4 + 2, mask=msk) * w2
    a = tl.load(lut_ptr + i1 * 4 + 3, mask=msk) * frac \
        + tl.load(lut_ptr + i2 * 4 + 3, mask=msk) * w2 * scale
    nl = tl.load(nl_ptr + n, mask=msk, other=0)
    h = tl.load(height_ptr + n * 32 + tl.minimum(k + 1, 31), mask=msk)
    h = tl.where(k + 1 <= nl, h, float("inf"))
    tl.store(prof_ptr + n * 64 + k, h, mask=msk)
    tl.store(prof_ptr + n * 64 + 32 + k, a, mask=msk)
    tl.store(rgb_ptr + n * 96 + k, r, mask=msk)
    tl.store(rgb_ptr + n * 96 + 32 + k, g, mask=msk)
    tl.store(rgb_ptr + n * 96 + 64 + k, b, mask=msk)


def classify_bake(cells: Cells, tf: Transfunc, values=None):
    """K5a wrapper: (prof (N, 64), rgb (N, 96)) from the cells' heights and
    values (or `values`, (N, 32) f32: the wedge tier bakes its per-wedge
    constants) and the transfer function.  The Triton kernel runs for CUDA
    tensors, the plain version for CPU tensors; anything else raises.

    Replaces the XLA-fused icon_rt_tpu/ops/fast.py `pack_profile_rows`
    and `_classify_channels`.  Kernel design: one elementwise pass over the
    (N, 32) (cell, layer) grid; each element reads its value, height, the
    cell's layer count and two LUT rows, and writes one prof height, one
    alpha and three RGB entries.  Bound by device-memory traffic (256 bytes read and 640
    written per cell); the 4.8 KB LUT stays in L1/L2, so the TPU's one-hot
    compare-sum over the 300 levels is replaced by plain cached loads."""
    height, nl = cells.height, cells.num_layers
    value = cells.value if values is None else values
    dev = height.device
    n = height.shape[0]
    for name, x, shape, dt in (
            ("height", height, (n, MAX_LAYERS), F32),
            ("value", value, (n, MAX_LAYERS), F32),
            ("num_layers", nl, (n,), torch.int32),
            ("tf.values", tf.values, (tf.size, 4), F32),
            ("tf.value_range", tf.value_range, (2,), F32),
            ("tf.opacity_scale", tf.opacity_scale, (), F32)):
        if tuple(x.shape) != shape or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"classify_bake: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape}")
        if x.device != dev:
            raise ValueError("classify_bake: tensors on different devices")
    if dev.type == "cpu":
        return _profile_rows_torch(height, value, nl, tf)
    if dev.type != "cuda":
        raise ValueError(f"classify_bake: unsupported device {dev}")
    prof = torch.empty((n, PROF_W), dtype=F32, device=dev)
    rgb = torch.empty((n, RGB_W), dtype=F32, device=dev)
    n_elem = n * MAX_LAYERS
    block = 1024
    if n_elem:
        _jit(_classify_kernel)[(-(-n_elem // block),)](
            height, value, nl, tf.values, tf.value_range, tf.opacity_scale,
            prof, rgb, n_elem, tf.size, BLOCK=block, enable_fp_fusion=False)
        launches["classify_bake"] += 1
    return prof, rgb


def pack_cells(cells: Cells, tf: Transfunc) -> PackedCells:
    """Test rows plus the K5a bake of heights and classified per-layer RGBA;
    the bake re-runs on TF edits (ref: hostCode.cu:878-909)."""
    prof, rgb = classify_bake(cells, tf)
    return PackedCells(test=pack_test_rows(cells), prof=prof, rgb=rgb)


def wedge_rows(cells: Cells):
    """The TF-independent half of the fast WEDGE tier's tables (the
    reference's mode 2 / cuBQL path), as the JAX package's
    icon_rt_tpu/ops/fast.py `pack_cells_wedge` (ref: hostCode.cu:556-600):
      * test (N, 32): the pack_test_rows layout in 0..14 and, in 16..18,
        n' = cross(u2 - u1, u3 - u1) / det(u1, u2, u3): a column's flat
        faces share this normal, so the face at height h is exactly
        {x : dot(x, n') = h} and the layer lookup compares the flat
        coordinate s = dot(P, n') with the heights (computed in host numpy
        as JAX does; 15 and 19..31 pad);
      * bv (N, 32): the per-wedge constant scalars (models/wedges.py
        `bv_all`) -- the reference's '#if 1' branch gives all six wedge
        vertices the BOTTOM scalar, so K5a bakes the per-layer alpha and
        RGB from bv instead of the values.
    Built once per scene; `pack_cells_wedge` bakes a TF over them."""
    import numpy as np
    from ..models.wedges import bv_all

    n = cells.num_cells
    dev = cells.lat.device
    rows = torch.zeros((n, TEST_W_WEDGE), dtype=F32, device=dev)
    rows[:, :TEST_W] = pack_test_rows(cells)
    lat = cells.lat.cpu().numpy()
    lon = cells.lon.cpu().numpy()
    cl = np.cos(lat)
    u = np.stack([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)],
                 axis=-1)                                  # (N, 3, 3)
    nrm = np.cross(u[:, 1] - u[:, 0], u[:, 2] - u[:, 0])
    det = np.einsum("ij,ij->i", u[:, 0], nrm)
    nprime = (nrm / np.where(np.abs(det) < 1e-30, 1e-30, det)[:, None]
              ).astype(np.float32)
    rows[:, 16:19] = torch.from_numpy(nprime).to(dev)
    bv = bv_all(cells.value.cpu().numpy(), cells.num_layers.cpu().numpy())
    return rows, torch.from_numpy(np.ascontiguousarray(bv)).to(dev)


def pack_cells_wedge(cells: Cells, tf: Transfunc, rows=None) -> PackedCells:
    """Packed tables of the fast WEDGE tier: the test rows of `wedge_rows`
    (or `rows`, its result, kept across TF edits) and the full K5a bake of
    its bv -- prof (N, 64) heights | bv alpha, rgb (N, 96) bv RGB.  Every
    TF edit bakes again in full (no scale-only shortcut, as JAX)."""
    test, bv = wedge_rows(cells) if rows is None else rows
    prof, rgb = classify_bake(cells, tf, values=bv)
    return PackedCells(test=test, prof=prof, rgb=rgb)


# ===========================================================================
# K5c-f32: the scale-only opacity re-bake
# ===========================================================================

def _alpha_scale_parts_torch(values, tf: Transfunc):
    """Plain K5c-f32 parts: (A, B), each (N, 32), with K5a's baked alpha
    == A + B * opacity_scale bit for bit -- the postClassify alpha
    a1 * frac + a2 * (1 - frac) * scale is affine in the scale, and
    `_classify_channels_torch` rounds it in this order."""
    size = tf.size
    vn = (values - tf.value_range[0]) \
        / (tf.value_range[1] - tf.value_range[0])
    vs = vn * float(size)
    idx = vs.to(torch.int32)
    frac = vs - idx.to(F32)
    lut_a = tf.values[:, 3]
    a1 = lut_a[torch.clamp(idx, 0, size - 1).long()]
    a2 = lut_a[torch.clamp(idx + 1, 0, size - 1).long()]
    return a1 * frac, a2 * (1.0 - frac)


def _apply_opacity_scale_torch(prof, a, b, scale):
    """Plain K5c-f32 apply: prof[:, 32:] = A + B * scale, in place."""
    prof[:, MAX_LAYERS:] = a + b * scale


def _alpha_parts_kernel(value_ptr, lut_ptr, tfr_ptr, a_ptr, b_ptr, n_elem,
                        S, BLOCK: tl.constexpr):
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    msk = i < n_elem
    v0 = tl.load(tfr_ptr)
    v1 = tl.load(tfr_ptr + 1)
    val = tl.load(value_ptr + i, mask=msk, other=0.0)
    vn = tl.math.div_rn(val - v0, v1 - v0)
    vs = vn * S.to(tl.float32)
    idx = vs.to(tl.int32)
    frac = vs - idx.to(tl.float32)
    i1 = tl.minimum(tl.maximum(idx, 0), S - 1)
    i2 = tl.minimum(tl.maximum(idx + 1, 0), S - 1)
    tl.store(a_ptr + i, tl.load(lut_ptr + i1 * 4 + 3, mask=msk) * frac,
             mask=msk)
    tl.store(b_ptr + i, tl.load(lut_ptr + i2 * 4 + 3, mask=msk)
             * (1.0 - frac), mask=msk)


def _apply_scale_kernel(a_ptr, b_ptr, scale_ptr, prof_ptr, n_elem,
                        BLOCK: tl.constexpr):
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    msk = i < n_elem
    n = i // 32
    k = i - n * 32
    s = tl.load(scale_ptr)
    a = tl.load(a_ptr + i, mask=msk, other=0.0)
    b = tl.load(b_ptr + i, mask=msk, other=0.0)
    tl.store(prof_ptr + n * 64 + 32 + k, a + b * s, mask=msk)


def pack_alpha_scale_parts(cells: Cells, tf: Transfunc):
    """K5c-f32 parts wrapper: (A, B), each (N, 32) f32, baked once per LUT
    and value range, so that any later opacity-scale edit is
    `apply_opacity_scale` instead of a full K5a bake.  The Triton kernel
    runs for CUDA tensors, the plain version for CPU tensors; anything else
    raises.

    Replaces the XLA-fused icon_rt_tpu/ops/fast.py `pack_alpha_scale_parts`.
    Kernel design: one elementwise pass over the (N, 32) grid, the alpha
    channel of K5a's arithmetic split at the scale; bound by device memory
    (128 bytes read and 256 written per cell), the LUT stays in L1/L2."""
    value = cells.value
    dev = value.device
    n = value.shape[0]
    for name, x, shape in (("value", value, (n, MAX_LAYERS)),
                           ("tf.values", tf.values, (tf.size, 4)),
                           ("tf.value_range", tf.value_range, (2,))):
        _check(name, x, F32, shape, dev, fn="pack_alpha_scale_parts")
    if dev.type == "cpu":
        return _alpha_scale_parts_torch(value, tf)
    if dev.type != "cuda":
        raise ValueError(f"pack_alpha_scale_parts: unsupported device {dev}")
    a = torch.empty((n, MAX_LAYERS), dtype=F32, device=dev)
    b = torch.empty_like(a)
    n_elem, block = n * MAX_LAYERS, 1024
    if n_elem:
        _jit(_alpha_parts_kernel)[(-(-n_elem // block),)](
            value, tf.values, tf.value_range, a, b, n_elem, tf.size,
            BLOCK=block, enable_fp_fusion=False)
        launches["alpha_scale_parts"] += 1
    return a, b


def apply_opacity_scale(packed: PackedCells, parts, scale) -> PackedCells:
    """K5c-f32 apply wrapper: re-derive the classified-alpha half of
    packed.prof for the opacity scale `scale` ((), f32 tensor) from
    `pack_alpha_scale_parts`, IN PLACE (the JAX version returns a new
    PackedCells; updating the half saves a 335 MB copy at subdiv 8).  RGB
    and heights do not depend on the scale.  Returns `packed`.

    Replaces the XLA-fused icon_rt_tpu/ops/fast.py `apply_opacity_scale`.
    Kernel design: one elementwise pass, alpha = A + B * scale rounded as
    two operations (no FMA), so the result equals a full K5a bake bit for
    bit; bound by device memory (256 bytes read and 128 written per
    cell)."""
    a, b = parts
    prof = packed.prof
    dev = prof.device
    n = prof.shape[0]
    ck = lambda name, x, shape: _check(name, x, F32, shape, dev,
                                       fn="apply_opacity_scale")
    ck("packed.prof", prof, (n, PROF_W))
    ck("A", a, (n, MAX_LAYERS))
    ck("B", b, (n, MAX_LAYERS))
    ck("scale", scale, ())
    if dev.type == "cpu":
        _apply_opacity_scale_torch(prof, a, b, scale)
        return packed
    if dev.type != "cuda":
        raise ValueError(f"apply_opacity_scale: unsupported device {dev}")
    n_elem, block = n * MAX_LAYERS, 1024
    if n_elem:
        _jit(_apply_scale_kernel)[(-(-n_elem // block),)](
            a, b, scale, prof, n_elem, BLOCK=block, enable_fp_fusion=False)
        launches["apply_opacity_scale"] += 1
    return packed


# ===========================================================================
# K1+K4 plain version: lock-step per-lane tracking
# ===========================================================================

def _r_of(t, od, oo):
    return torch.sqrt(torch.clamp(oo + 2.0 * t * od + t * t, min=1e-30))


def _band_of(r, edges, nb: int):
    return torch.clamp((edges[None, :] < r[:, None]).sum(1) - 1, 0, nb - 1)


def _band_exit_from(t, r_lo, r_hi, shi, od, oo):
    """Closed-form t where the ray leaves the band with the given edge
    radii, capped at shi.  Returns (t_exit, crossed_inner_edge)."""
    disc_in = od * od - oo + r_lo * r_lo
    t_in = -od - torch.sqrt(torch.clamp(disc_in, min=0.0))
    disc_out = od * od - oo + r_hi * r_hi
    t_out = -od + torch.sqrt(torch.clamp(disc_out, min=0.0))
    use_in = (t < -od) & (disc_in > 0.0) & (t_in > t)
    return torch.minimum(torch.where(use_in, t_in, t_out), shi), use_in


def _select_band(arr, b):
    """arr[b] per lane (JAX selects with a one-hot sum, which is exact)."""
    return arr[b]


def _band_exit(t, b, shi, od, oo, edges):
    """Band exit looked up by band index."""
    return _band_exit_from(t, edges[b], edges[b + 1], shi, od, oo)


class _Lanes(NamedTuple):
    """Per-lane ray constants and start state (`_init_lanes`)."""
    dx: torch.Tensor         # unit direction (tiny components -> 1e-5)
    dy: torch.Tensor
    dz: torch.Tensor
    od: torch.Tensor         # dot(org, dir)
    rng: torch.Tensor        # LCG state after the two jitter draws
    t: torch.Tensor          # start of the first non-empty shell segment
    seg_hi: torch.Tensor     # its end
    si: torch.Tensor         # bool: the lane starts in segment 1
    s1_lo: torch.Tensor      # the second shell segment
    s1_hi: torch.Tensor
    wrote: torch.Tensor      # bool: the ray meets the shell ahead
    band: torch.Tensor       # first band
    seg_end: torch.Tensor    # its exit
    was_in: torch.Tensor     # bool: the exit is through the inner edge
    m: torch.Tensor          # its majorant
    done: torch.Tensor       # bool: nothing to trace


def _init_lanes(lp, xs, ys, width: int, height: int, edges, majors, oo,
                nb: int, aid, rng_salt: int = 0) -> _Lanes:
    """Ray setup of sample `aid` ((), int64) of the pixels (xs, ys): the
    jittered pinhole ray (ref: deviceCode.cu:36-49), its clip to the shell
    (up to two segments, t >= 0) and the first band -- icon_rt_tpu/ops/
    fast.py `_raygen_soa` and `_init_lanes`, and csrc/track_common.cuh
    `init_lane`.  rng_salt != 0 re-keys the tracking stream after the two
    jitter draws (icon_rt_tpu/ops/fast.py:601-604): the scene shard's slabs
    trace the same ray with independent streams."""
    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    seed0 = ((aid & 0xFFFFFFFF) * (width * height) + xs) & 0xFFFFFFFF
    rng = lcg_init(seed0, ys)
    rng, jx = lcg_next(rng)
    rng, jy = lcg_next(rng)
    if rng_salt:
        rng = lcg_next(rng ^ ((rng_salt * 2654435761) & 0xFFFFFFFF))[0]
    u = xs.to(F32) + 0.5 + jx
    v = ys.to(F32) + 0.5 + jy
    dx = lp.cam_dir00[0] + u * lp.cam_du[0] + v * lp.cam_dv[0]
    dy = lp.cam_dir00[1] + u * lp.cam_du[1] + v * lp.cam_dv[1]
    dz = lp.cam_dir00[2] + u * lp.cam_du[2] + v * lp.cam_dv[2]
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    dx = torch.where(torch.abs(dx) < 1e-5, 1e-5, dx)
    dy = torch.where(torch.abs(dy) < 1e-5, 1e-5, dy)
    dz = torch.where(torch.abs(dz) < 1e-5, 1e-5, dz)
    od = ox * dx + oy * dy + oz * dz

    def sphere_ts(radius):
        disc = od * od - oo + radius * radius
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        return disc > 0.0, -od - sq, -od + sq

    hit_o, to0, to1 = sphere_ts(edges[nb])
    hit_i, ti0, ti1 = sphere_ts(edges[0])
    outer_only = hit_o & ~hit_i
    s0_lo = torch.clamp(to0, min=0.0)
    s0_hi = torch.where(outer_only, to1, ti0)
    s1_lo = torch.clamp(torch.where(outer_only, float("inf"), ti1), min=0.0)
    s1_hi = torch.where(outer_only, float("-inf"), to1)
    wrote = hit_o & (to1 > 0.0)
    s0_bad = s0_hi <= s0_lo
    t = torch.where(s0_bad, s1_lo, s0_lo)
    seg_hi = torch.where(s0_bad, s1_hi, s0_hi)
    band = _band_of(_r_of(t, od, oo), edges, nb)
    seg_end, was_in = _band_exit(t, band, seg_hi, od, oo, edges)
    return _Lanes(dx=dx, dy=dy, dz=dz, od=od, rng=rng, t=t, seg_hi=seg_hi,
                  si=s0_bad.clone(), s1_lo=s1_lo, s1_hi=s1_hi, wrote=wrote,
                  band=band, seg_end=seg_end, was_in=was_in,
                  m=_select_band(majors, band),
                  done=~(wrote & (seg_hi > t)))


def _inside(rows, px, py, pz, r):
    """Radial + 3 side-plane containment against (M, 16) test rows."""
    ev1 = rows[:, 0] * px + rows[:, 1] * py + rows[:, 2] * pz - rows[:, 3]
    ev2 = rows[:, 4] * px + rows[:, 5] * py + rows[:, 6] * pz - rows[:, 7]
    ev3 = rows[:, 8] * px + rows[:, 9] * py + rows[:, 10] * pz - rows[:, 11]
    return ((r >= rows[:, 12]) & (r <= rows[:, 13])
            & (ev1 <= 0.0) & (ev2 <= 0.0) & (ev3 <= 0.0))


def _layer_pick(heights, table_rows, r):
    """Value of the layer containing r: heights ascend and are inf-padded,
    so the layer is #(h < r); index 32 (above the top) gives 0."""
    layer = (r[:, None] > heights).sum(1)
    got = table_rows.gather(1, torch.clamp(layer, max=MAX_LAYERS - 1)[:, None])
    return torch.where(layer < MAX_LAYERS, got[:, 0], 0.0)


def _first_inside(rows_fn, cand, px, py, pz, r, return_rows: bool = False,
                  coord=None):
    """The FIRST candidate (in row order) of the (M, K) cell ids `cand`
    (-1 = empty) whose column contains the point; rows_fn maps cell ids to
    (..., 16) test rows.  The radial test compares r, or with `coord` (a
    tier's coord(rows, px, py, pz, r)) each candidate's own coordinate.
    Returns (cid, hit), and with return_rows also the candidates' (M, K,
    16) rows and their validity."""
    safe = torch.clamp(cand, min=0).long()
    rows = rows_fn(safe)                                  # (M, K, 16)
    ev = [rows[..., 4 * j] * px[:, None] + rows[..., 4 * j + 1] * py[:, None]
          + rows[..., 4 * j + 2] * pz[:, None] - rows[..., 4 * j + 3]
          for j in range(3)]
    valid = cand >= 0
    c = r[:, None] if coord is None else coord(
        rows, px[:, None], py[:, None], pz[:, None], r[:, None])
    inside = (valid & (c >= rows[..., 12])
              & (c <= rows[..., 13])
              & (ev[0] <= 0.0) & (ev[1] <= 0.0) & (ev[2] <= 0.0))
    slot = torch.argmax(inside.to(torch.int32), dim=1)
    cid, hit = safe.gather(1, slot[:, None])[:, 0], inside.any(1)
    return (cid, hit, rows, valid) if return_rows else (cid, hit)


def _grid_bin(a, lo, hi, n: int):
    """Clamped bin of angles a on an axis of n bins over [lo, hi]."""
    return torch.clamp(((a - lo) / (hi - lo) * float(n)).to(torch.int32),
                       0, n - 1)


def _locate_torch(loc: Locator, dims, rows_fn, px, py, pz, r,
                  return_rows: bool = False, coord=None):
    """Locator query on (M,) points: bin row, then the first candidate (in
    bin order) whose column contains the point (`coord` as
    `_first_inside`).  Returns (cid, hit), and with return_rows also the
    bin's (M, K, 16) candidate rows, their validity and the bin (bl, bo)
    -- JAX's `return_rows=True`, for the march's gap skip."""
    n_lat, n_lon = dims
    lat = torch.asin(torch.clamp(pz / r, -1.0, 1.0))
    lon = torch.atan2(py, px)
    bl = _grid_bin(lat, loc.lat_lo, loc.lat_hi, n_lat)
    bo = _grid_bin(lon, loc.lon_lo, loc.lon_hi, n_lon)
    out = _first_inside(rows_fn, loc.bins[(bl * n_lon + bo).long()], px, py,
                        pz, r, return_rows, coord)
    return (*out, bl, bo) if return_rows else out


class _F32Tier:
    """The f32 storage tier of the plain tracker and march: (N, 16) test
    rows, heights and classified alpha in `prof`, baked RGB in `rgb`."""

    #: candidate rows are 16 wide, with the plane offsets w at 3/7/11
    w_cols = True
    #: layers of a march prof row
    ml = MAX_LAYERS
    #: width of a cached test row
    test_w = TEST_W

    def __init__(self, packed: PackedCells, loc: Locator):
        self.packed, self.loc = packed, loc
        self.dims = tuple(int(d) for d in loc.dims.tolist())

    def test_rows(self, cid):
        return self.packed.test[cid]

    @staticmethod
    def coord(rows, px, py, pz, r):
        """The coordinate a column's layers are looked up by: the radius."""
        return r

    def locate(self, px, py, pz, r, return_rows: bool = False):
        """(cid, hit); with return_rows also (rows, valid, bl, bo) of the
        point's bin (`_locate_torch`)."""
        return _locate_torch(self.loc, self.dims, self.test_rows, px, py, pz,
                             r, return_rows)

    def march_prof(self, cid):
        """(M, 64) ceilings | classified alpha of columns cid."""
        return self.packed.prof[cid]

    def march_colors(self, cid, prof):
        """Per-layer classified (R, G, B), each (M, 32), of columns cid."""
        rows = self.packed.rgb[cid]
        return rows[:, :MAX_LAYERS], rows[:, MAX_LAYERS:2 * MAX_LAYERS], \
            rows[:, 2 * MAX_LAYERS:]

    def alpha(self, cid, r):
        prow = self.packed.prof[cid]
        return _layer_pick(prow[:, :MAX_LAYERS], prow[:, MAX_LAYERS:], r)

    def shade(self, cid, r):
        hh = self.packed.prof[cid, :MAX_LAYERS]
        rgb = self.packed.rgb[cid]
        return [_layer_pick(hh, rgb[:, ch * MAX_LAYERS:(ch + 1) * MAX_LAYERS],
                            r) for ch in range(3)]


class _WedgeTier(_F32Tier):
    """The fast wedge tier of the plain tracker (K9-w): the f32 tier's
    machinery on `pack_cells_wedge` tables, whose (N, 32) test rows carry
    each column's flat-face normal n' in 16..18.  Containment and the
    layer pick compare the flat coordinate dot(P, n') (icon_rt_tpu/ops/
    fast.py `step_core(flat_vert=True)`, `_test_and_fill_f32`, `_shade`)."""

    test_w = TEST_W_WEDGE

    @staticmethod
    def coord(rows, px, py, pz, r):
        """s = dot(P, n') of the columns of `rows`, summed x, y, z."""
        return rows[..., 16] * px + rows[..., 17] * py + rows[..., 18] * pz

    def locate(self, px, py, pz, r, return_rows: bool = False):
        return _locate_torch(self.loc, self.dims, self.test_rows, px, py, pz,
                             r, return_rows, self.coord)


def _track_torch(tier, bands: RadialBands, lp, pix, accum, fb, width: int,
                 height: int, samples: int, preserve_cache: bool, cost=None,
                 rng_salt: int = 0, out=None):
    """Plain-PyTorch tracking machine over the lanes of `pix` (pixel ids)
    for a storage tier (`_F32Tier`, ops/fastq.py `_QTier`); updates accum
    (L, 4) and fb (L,) in place, and with `cost` ((W*H,) int32) writes each
    lane's tracking steps over its samples at its pixel.  With `out` (a
    `RawSample`, one sample) it stores the sample there instead and leaves
    accum and fb (then None) alone; rng_salt as `_init_lanes`.

    All lanes advance in lock step, one tracking step per iteration: a
    step draws the flight uniform xi; an overshoot (or a zero majorant)
    advances to the next band or shell segment; otherwise the point is
    tested against the two cached columns (MRU slot wins ties) and, on a
    miss, located and filled into the cache (slot 0 pinned to the lane's
    first column); a point inside the volume then draws the acceptance
    uniform.  Samples run one after another per lane, the cache carried
    over when preserve_cache is set.  This is the per-lane order of
    csrc/track_common.cuh and of icon_rt_tpu/ops/fast.py `step_core`.

    The tier gives test_rows(cid) -> (M, test_w), coord(rows, px, py, pz,
    r) -> (M,) (the coordinate the column's containment and layer pick
    compare: r, or the wedge tier's flat coordinate), locate(px, py, pz, r)
    -> (cid, hit), alpha(cid, coord) -> (M,) and shade(cid, coord) -> [R,
    G, B]."""
    dev = pix.device
    L = pix.shape[0]
    nb = bands.max_opacities.shape[0]
    edges, majors = bands.edges, bands.max_opacities
    xs = torch.remainder(pix, width).to(torch.int64)
    ys = torch.div(pix, width, rounding_mode="floor").to(torch.int64)
    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    oo = ox * ox + oy * oy + oz * oz
    ud = lp.unit_distance
    amb = lp.ambient_color * lp.ambient_radiance
    zero = torch.zeros((), dtype=F32, device=dev)

    if out is None:
        acc, pixels = accum.clone(), fb.clone()
    new_test = lambda: torch.zeros((L, tier.test_w), dtype=F32, device=dev)
    new_i = lambda: torch.zeros(L, dtype=torch.int64, device=dev)
    new_b = lambda: torch.zeros(L, dtype=torch.bool, device=dev)
    c_test = [new_test(), new_test()]
    c_cid = [new_i(), new_i()]
    c_valid = [new_b(), new_b()]
    c_mru = new_b()
    steps_l = new_i() if cost is not None else None

    for samp in range(samples):
        if not preserve_cache:
            c_test = [new_test(), new_test()]
            c_cid = [new_i(), new_i()]
            c_valid = [new_b(), new_b()]
            c_mru = new_b()
        # -- ray setup: jittered pinhole ray, shell clip, first band --------
        ln = _init_lanes(lp, xs, ys, width, height, edges, majors, oo, nb,
                         lp.accum_id.to(torch.int64) + samp, rng_salt)
        dx, dy, dz, od, rng = ln.dx, ln.dy, ln.dz, ln.od, ln.rng
        t, seg_hi, si, s1_lo, s1_hi = (ln.t, ln.seg_hi, ln.si, ln.s1_lo,
                                       ln.s1_hi)
        band, seg_end, was_in, m = ln.band, ln.seg_end, ln.was_in, ln.m
        wrote, done = ln.wrote, ln.done
        alpha = torch.zeros(L, dtype=F32, device=dev)

        # -- tracking: one step per iteration for every unfinished lane -----
        act = torch.nonzero(~done).squeeze(1)
        steps = 0
        while act.numel() and steps < MAX_STEPS:
            steps += 1
            if steps_l is not None:
                steps_l[act] += 1
            m_a = m[act]
            has_m = m_a > 0.0
            rng_a = rng[act]
            rng_n, xi = lcg_next(rng_a)
            rng_a = torch.where(has_m, rng_n, rng_a)
            t_new = t[act] - torch.log(1.0 - xi) / (m_a / ud)
            samp_m = has_m & ~(t_new > seg_end[act])

            # sample point: cached columns, else locate and fill
            b = act[samp_m]
            if b.numel():
                tb = t_new[samp_m]
                t[b] = tb
                px = ox + dx[b] * tb
                py = oy + dy[b] * tb
                pz = oz + dz[b] * tb
                r = _r_of(tb, od[b], oo)
                v0b = c_valid[0][b]
                rows0, rows1 = c_test[0][b], c_test[1][b]
                in0 = v0b & _inside(rows0, px, py, pz,
                                    tier.coord(rows0, px, py, pz, r))
                in1 = c_valid[1][b] & _inside(
                    rows1, px, py, pz, tier.coord(rows1, px, py, pz, r))
                in_cache = in0 | in1
                mru_b = c_mru[b]
                use1 = torch.where(mru_b, in1, in1 & ~in0)
                mru_b = torch.where(in_cache, use1, mru_b)
                hit_vol = in_cache.clone()
                mi = torch.nonzero(~in_cache).squeeze(1)
                if mi.numel():
                    cid, hit = tier.locate(px[mi], py[mi], pz[mi], r[mi])
                    hi, cid = mi[hit], cid[hit]
                    into1 = v0b[hi]
                    for slot, sel in ((0, ~into1), (1, into1)):
                        lanes = b[hi[sel]]
                        c_test[slot][lanes] = tier.test_rows(cid[sel])
                        c_cid[slot][lanes] = cid[sel]
                        c_valid[slot][lanes] = True
                    mru_b[hi] = into1
                    hit_vol[hi] = True
                c_mru[b] = mru_b
                hv = torch.nonzero(hit_vol).squeeze(1)
                rng_b = rng_a[samp_m]
                if hv.numel():
                    lanes = b[hv]
                    mh = mru_b[hv]
                    cid = torch.where(mh, c_cid[1][lanes], c_cid[0][lanes])
                    rows = torch.where(mh[:, None], c_test[1][lanes],
                                       c_test[0][lanes])
                    aa_v = tier.alpha(cid, tier.coord(
                        rows, px[hv], py[hv], pz[hv], r[hv]))
                    rng_v, uu = lcg_next(rng_b[hv])
                    rng_b[hv] = rng_v
                    hit = aa_v >= uu * m_a[samp_m][hv]
                    alpha[lanes[hit]] = aa_v[hit]
                    done[lanes[hit]] = True
                rng_a[samp_m] = rng_b
            rng[act] = rng_a

            # overshoot / zero majorant: advance to the next band or segment
            c = act[~samp_m]
            if c.numel():
                t_adv = seg_end[c]
                at_end = t_adv >= seg_hi[c]
                band_n = band[c] + torch.where(was_in[c], -1, 1)
                to_seg1 = at_end & ~si[c] & (s1_hi[c] > s1_lo[c])
                t_adv = torch.where(to_seg1, s1_lo[c], t_adv)
                band_n = torch.where(
                    to_seg1, _band_of(_r_of(t_adv, od[c], oo), edges, nb),
                    band_n)
                shi_n = torch.where(to_seg1, s1_hi[c], seg_hi[c])
                band_n = torch.clamp(band_n, 0, nb - 1)
                se, win = _band_exit_from(t_adv, edges[band_n],
                                          edges[band_n + 1], shi_n, od[c], oo)
                t[c] = t_adv
                seg_end[c] = se
                seg_hi[c] = shi_n
                band[c] = band_n
                was_in[c] = win
                m[c] = majors[band_n]
                si[c] = si[c] | to_seg1
                done[c] = done[c] | (at_end & ~to_seg1)
            act = act[~done[act]]

        # -- shade the accepted sample and accumulate (K4) -------------------
        cr = torch.zeros(L, dtype=F32, device=dev)
        cg, cb = cr.clone(), cr.clone()
        g = torch.nonzero(alpha > 0.0).squeeze(1)
        if g.numel():
            mg, tg = c_mru[g], t[g]
            cid = torch.where(mg, c_cid[1][g], c_cid[0][g])
            rows = torch.where(mg[:, None], c_test[1][g], c_test[0][g])
            rgb = tier.shade(cid, tier.coord(
                rows, ox + dx[g] * tg, oy + dy[g] * tg, oz + dz[g] * tg,
                _r_of(tg, od[g], oo)))
            for ch, chan in enumerate((cr, cg, cb)):
                chan[g] = rgb[ch] * amb[ch]
        ca = torch.where(alpha > 0.0, 1.0, zero)
        color = torch.stack([cr, cg, cb, ca], dim=1)
        if out is not None:
            out.wrote.copy_(wrote)
            out.ca.copy_(color)
            out.t.copy_(torch.where(alpha > 0.0, t, float("inf")))
            continue
        # fb is repacked after every sample; a lane's last write packs its
        # final accum, as the kernel's single pack at the end does
        acc, pixels = _finalize(wrote, color, acc, pixels,
                                lp.accum_id + samp)

    if out is None:
        accum.copy_(acc)
        fb.copy_(pixels)
    if cost is not None:
        cost[pix.long()] = steps_l.to(torch.int32)


def _render_frame_fast_torch(packed: PackedCells, loc: Locator,
                             bands: RadialBands, lp, pix, accum, fb,
                             width: int, height: int, samples: int,
                             preserve_cache: bool, cost=None,
                             tier=_F32Tier, rng_salt: int = 0, out=None):
    """Plain-PyTorch K1+K4 (or, with tier=_WedgeTier, K9-w) over the lanes
    of `pix` (pixel ids): the tracking machine `_track_torch` on the f32
    tier (the wedge tier)."""
    _track_torch(tier(packed, loc), bands, lp, pix, accum, fb, width,
                 height, samples, preserve_cache, cost, rng_salt, out)


# ===========================================================================
# K1+K4 kernel: build, bind, launch
# ===========================================================================

class _TrackFrame(ctypes.Structure):
    """Mirror of `TrackFrame` in csrc/track_common.cuh (same field order):
    the device addresses of a frame's scalars, which K1, K2, K9-w and K3
    read on the card."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "cam_org", "cam_dir00", "cam_du", "cam_dv", "amb", "amb_rad", "ud",
        "accum_id")]


class _TrackCommon(ctypes.Structure):
    """Mirror of `TrackCommon` in csrc/track_common.cuh (same field order)."""
    _fields_ = [
        ("edges", ctypes.c_void_p), ("majors", ctypes.c_void_p),
        ("pix", ctypes.c_void_p), ("accum", ctypes.c_void_p),
        ("fb", ctypes.c_void_p), ("cost", ctypes.c_void_p),
        ("raw_wrote", ctypes.c_void_p), ("raw_ca", ctypes.c_void_p),
        ("raw_t", ctypes.c_void_p), ("frame", _TrackFrame),
        ("nb", ctypes.c_int), ("n_lanes", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("samples", ctypes.c_int), ("preserve_cache", ctypes.c_int),
        ("max_steps", ctypes.c_int), ("rng_salt", ctypes.c_uint),
    ]


class RawSample(NamedTuple):
    """One sample of K1/K2 in raw mode, per lane, before any composite:
    wrote (L,) bool (the ray met the shell), ca (L, 4) f32 (its colour and
    alpha, 0 without a collision) and t (L,) f32 (the accepted collision's
    ray parameter, +inf without one: icon_rt_tpu/ops/fastq.py:268-271)."""
    wrote: torch.Tensor
    ca: torch.Tensor
    t: torch.Tensor


def alloc_raw(n_lanes: int, device) -> RawSample:
    """An uninitialised RawSample of n_lanes lanes on `device`."""
    return RawSample(
        wrote=torch.empty(n_lanes, dtype=torch.bool, device=device),
        ca=torch.empty((n_lanes, 4), dtype=F32, device=device),
        t=torch.empty(n_lanes, dtype=F32, device=device))


def check_raw(fn, out: RawSample, accum, fb, n_lanes: int, samples: int,
              dev):
    """Raise ValueError unless accum and fb are given without `out`, or
    `out` is a RawSample of n_lanes lanes on `dev` for one sample."""
    if out is None:
        if accum is None or fb is None:
            raise ValueError(f"{fn}: accum and fb are needed without out=")
        return
    if samples != 1:
        raise ValueError(f"{fn}: raw mode (out=) takes one sample")
    ck = lambda name, x, dt, shape: _check(name, x, dt, shape, dev, fn=fn)
    ck("out.wrote", out.wrote, torch.bool, (n_lanes,))
    ck("out.ca", out.ca, F32, (n_lanes, 4))
    ck("out.t", out.t, F32, (n_lanes,))


def host_values(t: torch.Tensor):
    """t.tolist(), read from the device once per tensor: the copy rides on
    the tensor and is read again only after an in-place write through
    PyTorch (which bumps t._version) or a rebind of its storage, so a
    launch whose tables did not change reads nothing back.  The tables
    whose scalars go through it (a Locator's or FineMap's dims and window,
    a QuantizedCells' value and alpha range, a TF's value range) are
    immutable once built: every builder and every TF edit makes new
    tensors.  A write through a raw device pointer (a ctypes kernel) is
    not seen; nothing in the package writes these tensors so."""
    key = (t._version, t.data_ptr())
    memo = getattr(t, "_icon_host_copy", None)
    if memo is None or memo[0] != key:
        memo = (key, t.tolist())
        t._icon_host_copy = memo
    return memo[1]


#: the launch params' fields the kernels read on the card (`track_frame`)
FRAME_FIELDS = ("cam_org", "cam_dir00", "cam_du", "cam_dv", "ambient_color",
                "ambient_radiance", "unit_distance", "accum_id")


def frame_on(lp, dev):
    """lp with the frame's scalars on `dev`: a tensor held elsewhere (a
    host accum_id) is copied to the card, never read back.  The caller
    keeps the result until its launch is enqueued."""
    moved = {f: getattr(lp, f).to(dev) for f in FRAME_FIELDS
             if getattr(lp, f).device != dev}
    return lp._replace(**moved) if moved else lp


def track_frame(lp, dev, fn: str = "track_f32") -> _TrackFrame:
    """A frame's scalars as device addresses: lp's camera, ambient terms,
    unit distance and accum_id, which the kernels read on the card, so a
    launch reads nothing back; raises unless each is a contiguous tensor
    of its shape on `dev`."""
    ck = lambda name, x, dt, shape: _check(name, x, dt, shape, dev, fn=fn)
    for name in ("cam_org", "cam_dir00", "cam_du", "cam_dv",
                 "ambient_color"):
        ck(f"lp.{name}", getattr(lp, name), F32, (3,))
    ck("lp.ambient_radiance", lp.ambient_radiance, F32, ())
    ck("lp.unit_distance", lp.unit_distance, F32, ())
    ck("lp.accum_id", lp.accum_id, torch.int32, ())
    return _TrackFrame(
        cam_org=lp.cam_org.data_ptr(), cam_dir00=lp.cam_dir00.data_ptr(),
        cam_du=lp.cam_du.data_ptr(), cam_dv=lp.cam_dv.data_ptr(),
        amb=lp.ambient_color.data_ptr(),
        amb_rad=lp.ambient_radiance.data_ptr(),
        ud=lp.unit_distance.data_ptr(), accum_id=lp.accum_id.data_ptr())


def track_common(bands: RadialBands, lp, pix, accum, fb, *, width: int,
                 height: int, samples: int, preserve_cache: bool,
                 cost=None, rng_salt: int = 0,
                 out: RawSample | None = None,
                 fn: str = "track_f32") -> _TrackCommon:
    """The tier-independent launch arguments of K1, K2, K9-w and K3, built
    without a device read: the frame's scalars as device addresses
    (`track_frame`, raising in the name of `fn`); `cost` is K1's and K2's
    optional (W*H,) int32 step-count output, `out` their raw mode's
    RawSample and rng_salt their tracking streams' salt."""
    return _TrackCommon(
        edges=bands.edges.data_ptr(), majors=bands.max_opacities.data_ptr(),
        pix=pix.data_ptr(),
        accum=None if accum is None else accum.data_ptr(),
        fb=None if fb is None else fb.data_ptr(),
        cost=None if cost is None else cost.data_ptr(),
        raw_wrote=None if out is None else out.wrote.data_ptr(),
        raw_ca=None if out is None else out.ca.data_ptr(),
        raw_t=None if out is None else out.t.data_ptr(),
        frame=track_frame(lp, pix.device, fn),
        nb=bands.max_opacities.shape[0], n_lanes=pix.shape[0], width=width,
        height=height, samples=samples,
        preserve_cache=int(bool(preserve_cache)), max_steps=MAX_STEPS,
        rng_salt=rng_salt & 0xFFFFFFFF)


def check_rows(fn: str, name: str, x, nbytes: int):
    """Raise ValueError unless x's storage and each of its rows start on an
    `nbytes` boundary: the kernels read the tier's rows as float4 (test
    rows, 16 bytes) or one uint32 (the fine map's 4 slots)."""
    if x.data_ptr() % nbytes or (x.stride(0) * x.element_size()) % nbytes:
        raise ValueError(f"{fn}: {name}'s rows must start on {nbytes}-byte "
                         f"boundaries (the kernel reads them in "
                         f"{nbytes}-byte words)")


class _TrackParams(ctypes.Structure):
    """Mirror of `TrackParams` in csrc/tier_f32.cuh (same field order)."""
    _fields_ = [
        ("c", _TrackCommon),
        ("test", ctypes.c_void_p), ("prof", ctypes.c_void_p),
        ("rgb", ctypes.c_void_p), ("bins", ctypes.c_void_p),
        ("lat_lo", ctypes.c_float), ("lat_hi", ctypes.c_float),
        ("lon_lo", ctypes.c_float), ("lon_hi", ctypes.c_float),
        ("n_lat", ctypes.c_int), ("n_lon", ctypes.c_int),
        ("k_cap", ctypes.c_int),
    ]


def track_params(packed: PackedCells, loc: Locator,
                 c: _TrackCommon) -> _TrackParams:
    """The f32 tier's launch arguments of K1 and K3 (csrc/tier_f32.cuh):
    the locator's scalars from their host copies (`host_values`)."""
    n_lat, n_lon = host_values(loc.dims)
    if loc.bins.shape[0] != n_lat * n_lon:
        raise ValueError("loc.bins rows != n_lat * n_lon")
    win = [host_values(x) for x in (loc.lat_lo, loc.lat_hi, loc.lon_lo,
                                    loc.lon_hi)]
    return _TrackParams(
        c=c, test=packed.test.data_ptr(), prof=packed.prof.data_ptr(),
        rgb=packed.rgb.data_ptr(), bins=loc.bins.data_ptr(),
        lat_lo=win[0], lat_hi=win[1], lon_lo=win[2], lon_hi=win[3],
        n_lat=n_lat, n_lon=n_lon, k_cap=loc.bins.shape[1])


def build_track_f32(name: str = "track_f32"):
    """Compile csrc/<name>.cu (track_f32: K1; track_wedge: K9-w) for sm_90a
    (utils/cuda_build.py) and bind its C entry point; returns the ctypes
    library."""
    lib = cuda_build.build(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.POINTER(_TrackParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(name, x, dtype, shape, device, fn="track_f32"):
    """Raise ValueError unless x is a contiguous `dtype` tensor on `device`
    of `shape` (None = any size)."""
    if x.dtype != dtype or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} "
                         f"tensor on {device}")
    if len(shape) != x.dim() or any(s is not None and s != d
                                    for s, d in zip(shape, x.shape)):
        raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")


def _track_packed(name: str, tier, packed: PackedCells, loc: Locator,
                  bands: RadialBands, lp, pix, accum, fb, width: int,
                  height: int, samples: int, preserve_cache: bool, cost,
                  rng_salt: int = 0, out: RawSample | None = None):
    """K1 (name track_f32, tier _F32Tier) or K9-w (track_wedge,
    _WedgeTier): check the tables, then launch csrc/<name>.cu for CUDA
    tensors or run the plain version on `tier` for CPU tensors."""
    dev = pix.device
    n = packed.test.shape[0]
    nb = bands.max_opacities.shape[0]
    L = pix.shape[0]
    ck = lambda what, x, dt, shape: _check(what, x, dt, shape, dev, fn=name)
    ck("packed.test", packed.test, F32, (n, tier.test_w))
    check_rows(name, "packed.test", packed.test, 16)
    ck("packed.prof", packed.prof, F32, (n, PROF_W))
    ck("packed.rgb", packed.rgb, F32, (n, RGB_W))
    ck("loc.bins", loc.bins, torch.int32, (None, None))
    ck("bands.edges", bands.edges, F32, (nb + 1,))
    ck("bands.max_opacities", bands.max_opacities, F32, (nb,))
    ck("pix", pix, torch.int32, (L,))
    check_raw(name, out, accum, fb, L, samples, dev)
    if out is None:
        ck("accum", accum, F32, (L, 4))
        ck("fb", fb, torch.int32, (L,))
    if cost is not None:
        ck("cost", cost, torch.int32, (width * height,))
    if samples < 1:
        raise ValueError(f"{name}: samples must be >= 1")
    if dev.type == "cpu":
        _render_frame_fast_torch(packed, loc, bands, lp, pix, accum, fb,
                                 width, height, samples, preserve_cache, cost,
                                 tier, rng_salt, out)
        return
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    lib = build_track_f32(name)
    lp = frame_on(lp, dev)
    p = track_params(packed, loc, track_common(
        bands, lp, pix, accum, fb, width=width, height=height,
        samples=samples, preserve_cache=preserve_cache, cost=cost,
        rng_salt=rng_salt, out=out, fn=name))
    cuda_build.check(name, getattr(lib, f"{name}_launch")(
        ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream))
    launches[name] += 1


def track_f32(packed: PackedCells, loc: Locator, bands: RadialBands, lp,
              pix, accum, fb, *, width: int, height: int, samples: int = 1,
              preserve_cache: bool = True, cost=None, rng_salt: int = 0,
              out: RawSample | None = None):
    """K1+K4 wrapper: trace `samples` progressive samples for the lanes of
    `pix` ((L,) int32 pixel ids) and update accum (L, 4) f32 and fb (L,)
    int32 IN PLACE; with `cost` ((W*H,) int32) also store each lane's
    tracking steps at its pixel.  Raw mode (`out`, a RawSample; accum and
    fb None, one sample) stores the sample for a composite across ranks
    instead (ops/composite.py); rng_salt != 0 re-keys the tracking streams.
    CUDA tensors launch csrc/track_f32.cu; CPU tensors run
    `_render_frame_fast_torch`; anything else raises.  A launch reads
    nothing back from the card: the kernel reads lp's scalars from their
    tensors (`track_frame`), the locator's come from `host_values`."""
    _track_packed("track_f32", _F32Tier, packed, loc, bands, lp, pix, accum,
                  fb, width, height, samples, preserve_cache, cost, rng_salt,
                  out)


def track_wedge(packed: PackedCells, loc: Locator, bands: RadialBands, lp,
                pix, accum, fb, *, width: int, height: int, samples: int = 1,
                preserve_cache: bool = True, cost=None):
    """K9-w wrapper: `track_f32` on the fast wedge tier -- packed from
    `pack_cells_wedge` ((N, 32) test rows), bands from models/shells.py
    `build_radial_bands_wedge`.  CUDA tensors launch csrc/track_wedge.cu;
    CPU tensors run `_track_torch` on `_WedgeTier`; anything else raises.

    Replaces the XLA-fused icon_rt_tpu/ops/fast.py `step_core(flat_vert=
    True)` :451, `_test_and_fill_f32` :703 (its flat branch :722-724),
    `_shade(flat_vert=True)` :1445 and `render_frame_fast(sampler="wedge")`.
    Kernel design: K1's per-lane machine (csrc/track_common.cuh) on the
    storage tier csrc/tier_wedge.cuh, whose cached column also holds n' and
    whose `coord` hook returns dot(P, n') where the f32 tier returns r; no
    fine-map primary.  Bound like K1 by divergence and the dependent reads
    of a cache miss."""
    _track_packed("track_wedge", _WedgeTier, packed, loc, bands, lp, pix,
                  accum, fb, width, height, samples, preserve_cache, cost)


# ===========================================================================
# Frame driver
# ===========================================================================

def render_frame_fast(cells: Cells, packed: PackedCells, loc: Locator,
                      bands: RadialBands, lp, accum, fb, *,
                      width: int, height: int, pixel_perm=None,
                      n_active: int | None = None, samples: int = 1,
                      preserve_cache: bool = True, return_cost: bool = False,
                      sampler: str = "locator"):
    """Full-frame progressive step on the fast path.

    sampler: 'locator' (the f32 tier, K1) or 'wedge' (the reference's
    mode 2 made gather-free, K9-w: packed must come from
    `pack_cells_wedge` and bands from models/shells.py
    `build_radial_bands_wedge`).

    pixel_perm: optional (H*W,) int32 permutation (ops/order.pixel_order);
    when given, lane i renders pixel pixel_perm[i] and accum/fb are in
    PERMUTED order — unpermute with the inverse at present time.

    n_active: optional count of covered positions (with pixel_perm): only
    the first n_active lanes are traced; the tail's accum/fb pass through
    untouched (those rays never write, deviceCode.cu:294).

    samples: progressive samples per call; lp.accum_id is the FIRST sample
    id.  With preserve_cache=False the result equals `samples` sequential
    samples=1 calls bit for bit; the default keeps each lane's column cache
    across its samples (outputs can then differ only on f32 boundary ties
    between adjacent columns).

    return_cost: also return each pixel's measured cost, the tracking steps
    its lane took over the launch's samples, as a (W*H,) int32 tensor in
    NATURAL pixel order, 0 for untraced pixels: ops/order.py
    `refine_order_device` re-sorts the next launch's lanes by it.

    accum (P, 4) f32 and fb (P,) int32 are updated IN PLACE (the JAX
    version donates them) and returned."""
    pix, n_proc = frame_lanes(width, height, pixel_perm, n_active,
                              accum.device)
    if sampler not in ("locator", "wedge"):
        raise ValueError(f"unknown fast sampler {sampler!r}")
    cost = torch.zeros(width * height, dtype=torch.int32,
                       device=accum.device) if return_cost else None
    track = track_wedge if sampler == "wedge" else track_f32
    track(packed, loc, bands, lp, pix, accum[:n_proc], fb[:n_proc],
          width=width, height=height, samples=samples,
          preserve_cache=preserve_cache, cost=cost)
    return (accum, fb, cost) if return_cost else (accum, fb)


def frame_lanes(width: int, height: int, pixel_perm, n_active, device):
    """(pixel ids of the traced lanes, their count): every pixel, or the
    first n_active of pixel_perm (lane i renders pixel pixel_perm[i])."""
    total = width * height
    if pixel_perm is None:
        return torch.arange(total, dtype=torch.int32, device=device), total
    n_proc = total if n_active is None else min(total, max(int(n_active), 1))
    return pixel_perm.to(torch.int32)[:n_proc].contiguous(), n_proc
