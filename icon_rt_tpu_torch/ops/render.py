"""Launch parameters, frame buffers, the progressive-accumulation epilogue
and the reference-parity raygens with their kernel K8.

The reference's OWL name->pointer launch-params registry
(ref: common/pipeline.cu:357-411) becomes a NamedTuple of small tensors
(`LaunchParams`); the accumulation buffer (P, 4) f32 and the packed RGBA8
framebuffer (P,) (int32 holding the u32 bits) live on the render device.

The parity raygens are the renderer's ground truth, held sample for
sample against the reference's CUDA semantics (tests/refimpl.py):
  * `render_frame_ae`    -- woodcockTrackingAE (ref: deviceCode.cu:239-275):
                            Woodcock tracking of the whole camera-box
                            segment at the global majorant 1;
  * `render_frame_accel` -- woodcockTrackingWithAccel (ref:
                            deviceCode.cu:281-341): tracking driven through
                            per-cell majorants by the spherical-shell DDA
                            (accel_mode 'sphere') or the Cartesian 3-DDA
                            ('grid');
each with the brute-force, the locator or the wedge point sampler (the
reference's cuBQL mode: the Newton inversion of the column layers' flat
wedges, models/wedges.py).  One sample per call, over the pixels in
natural order.

Kernel K8 `parity_track` (CUDA C++, csrc/parity.cu) runs one thread per
pixel: ray generation, the box test, the tracking loop with its sampler,
postClassify and the finalize; with the wedge sampler it is K9-p, whose
Newton device functions are csrc/uelems.cuh.  Its plain version is
`_parity_torch` (the lock-step loops of ops/woodcock.py and
ops/traverse.py).  The wrapper
launches the kernel for CUDA tensors and the plain version for CPU
tensors; anything else raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..models.cells import Cells, sample_brute_force
from ..models.locator import Locator, sample_locator
from ..models.transfunc import Transfunc, post_classify
from ..models.wedges import Wedges, sample_wedges
from ..utils import color as colorlib
from ..utils import cuda_build
from ..utils.lcg import lcg_init, lcg_next
from ..utils.vecmath import box_test, sqrt_rn
from .traverse import trace_dda3, trace_sdda
from .woodcock import MAX_ITERS, Work, make_shell_fn, woodcock_track

F32 = torch.float32

#: K8 launches per raygen x sampler (the wrapper adds one per kernel
#: launch; plain-version runs on the CPU do not count)
launches = {f"parity_{g}_{s}{m}": 0 for g in ("ae", "sphere", "grid")
            for s in ("locator", "brute", "wedge") for m in ("", "_raw")}


class LaunchParams(NamedTuple):
    """Per-frame parameters (ref: icon_rt/Params.h:92-119)."""
    cam_org: torch.Tensor        # (3,) f32
    cam_dir00: torch.Tensor      # (3,) f32
    cam_du: torch.Tensor         # (3,) f32
    cam_dv: torch.Tensor         # (3,) f32
    bounds_lo: torch.Tensor      # (3,) f32 volume world bounds
    bounds_hi: torch.Tensor      # (3,) f32
    ambient_color: torch.Tensor  # (3,) f32
    ambient_radiance: torch.Tensor  # () f32
    unit_distance: torch.Tensor  # () f32
    accum_id: torch.Tensor       # () i32


def make_launch_params(camera_basis, bounds_lo, bounds_hi,
                       ambient_color=(1.0, 1.0, 1.0), ambient_radiance=1.0,
                       unit_distance=1.0, accum_id=0,
                       device="cpu") -> LaunchParams:
    org, dir00, du, dv = camera_basis
    f32 = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    return LaunchParams(
        cam_org=f32(org), cam_dir00=f32(dir00), cam_du=f32(du), cam_dv=f32(dv),
        bounds_lo=f32(bounds_lo), bounds_hi=f32(bounds_hi),
        ambient_color=f32(ambient_color),
        ambient_radiance=f32(ambient_radiance),
        unit_distance=f32(unit_distance),
        accum_id=torch.tensor(int(accum_id), dtype=torch.int32,
                              device=device),
    )


def _finalize(wrote, color_alpha, accum, fb, accum_id):
    """Running-average accumulation + sRGB + RGBA8 pack
    (ref: deviceCode.cu:267-274).  Pixels whose rays missed keep their
    previous accum/fb content."""
    s = 1.0 / (accum_id.to(torch.float32) + 1.0)
    new_accum = s * color_alpha + (1.0 - s) * accum  # ref lerp(a,b,x)=x*a+(1-x)*b
    accum_out = torch.where(wrote[..., None], new_accum, accum)
    srgb = colorlib.linear_to_srgb(accum_out[..., :3])
    packed = colorlib.make_rgba(torch.cat([srgb, accum_out[..., 3:]], dim=-1))
    fb_out = torch.where(wrote, packed, fb)
    return accum_out, fb_out


def check_sampler(sampler: str, locator: Locator | None,
                  wedges: Wedges | None = None) -> None:
    """Raise ValueError unless `sampler` is 'brute', 'locator' (with a
    Locator) or 'wedge' (with a Locator and Wedges); reads nothing."""
    if sampler == "locator" and locator is None:
        raise ValueError("sampler='locator' needs a Locator")
    if sampler == "wedge" and (locator is None or wedges is None):
        raise ValueError("sampler='wedge' needs a Locator and Wedges")
    if sampler not in ("brute", "locator", "wedge"):
        raise ValueError(f"unknown sampler {sampler!r}")


def make_sample_fn(cells: Cells, locator: Locator | None, sampler: str,
                   wedges: Wedges | None = None):
    """Volume point-sampler dispatch (ref: deviceCode.cu:58-125), batched
    over lanes: 'brute' is the linear scan (the reference's no-RT
    fallback), 'locator' the grid-of-lists query (the reference's
    user-geometry and triangle modes both resolve to this analytic column
    sampling), 'wedge' the Newton wedge inversion of the cuBQL mode
    (models/wedges.py `sample_wedges`)."""
    check_sampler(sampler, locator, wedges)
    if sampler == "brute":
        return lambda pos: sample_brute_force(cells, pos)
    dims = tuple(int(d) for d in locator.dims.tolist())
    if sampler == "locator":
        return lambda pos: sample_locator(cells, locator, pos, dims)
    return lambda pos: sample_wedges(cells, wedges, locator, pos, dims)


def generate_ray(lp: LaunchParams, x, y, rng):
    """Jittered pinhole rays of the pixels (x, y) ((L,) int tensors;
    ref: icon_rt/deviceCode.cu:36-49).  Returns (org (3,), direction
    (L, 3), rng).

    Reference quirks kept: the raygen passes pixel+0.5 and adds another
    rnd() in [0,1), so the jitter window is [0.5, 1.5) of the pixel; the
    direction is normalised by three divisions; components with
    |d| < 1e-5 become +1e-5, also negative ones."""
    rng, jx = lcg_next(rng)
    rng, jy = lcg_next(rng)
    u = x.to(F32) + 0.5 + jx
    v = y.to(F32) + 0.5 + jy
    d = lp.cam_dir00 + u[:, None] * lp.cam_du + v[:, None] * lp.cam_dv
    n = sqrt_rn(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    d = d / n[:, None]
    d = torch.where(torch.abs(d) < 1e-5, 1e-5, d)
    return lp.cam_org, d, rng


def _pixels(cells: Cells, tf: Transfunc, lp: LaunchParams, xs, ys,
            width: int, height: int, raygen: str, sampler: str,
            locator: Locator | None, accel, work: Work | None = None,
            wedges: Wedges | None = None):
    """One parity sample of the pixels (xs, ys): (wrote (L,), color_alpha
    (L, 4), final rng (L,), loop iterations (L,)).  `wrote` is False
    where the ray misses the volume bounds (the reference returns without
    writing).  `work`, if given, counts the tracking loop's events."""
    sample_fn = make_sample_fn(cells, locator, sampler, wedges)
    classify_fn = lambda value: post_classify(tf, value)
    seed0 = ((lp.accum_id.to(torch.int64) & 0xFFFFFFFF)
             * ((width * height) & 0xFFFFFFFF) + xs) & 0xFFFFFFFF
    rng = lcg_init(seed0, ys)
    org, direction, rng = generate_ray(lp, xs, ys, rng)
    hit_box, t0, t1 = box_test(org, direction, 0.0, 1e10, lp.bounds_lo,
                               lp.bounds_hi)
    if raygen == "ae":
        res = woodcock_track(sample_fn, classify_fn, org, direction, t0, t1,
                             1.0, rng, lp.unit_distance, active=hit_box,
                             work=work, shell_fn=make_shell_fn(
                                 cells, sampler, wedges))
        color = res.albedo
        alpha = torch.where(res.extinction > 0.0, 1.0, 0.0)
    elif raygen == "sphere":
        res = trace_sdda(sample_fn, classify_fn, accel.max_opacities,
                         accel.dims, accel.sph_lo, accel.sph_hi, org,
                         direction, t0, t1, rng, lp.unit_distance,
                         active=hit_box, work=work)
        color, alpha = res.color, res.alpha
    elif raygen == "grid":
        res = trace_dda3(sample_fn, classify_fn, accel.max_opacities,
                         accel.dims, accel.world_lo, accel.world_hi, org,
                         direction, t0, t1, rng, lp.unit_distance,
                         active=hit_box, work=work)
        color, alpha = res.color, res.alpha
    else:
        raise ValueError(f"unknown raygen {raygen!r}")
    rgb = color * lp.ambient_color * lp.ambient_radiance
    return (hit_box, torch.cat([rgb, alpha[:, None]], dim=1), res.rng,
            res.steps)


def frame_pixels_ae(cells: Cells, tf: Transfunc, lp: LaunchParams, xs, ys,
                    width: int, height: int, sampler: str = "brute",
                    locator: Locator | None = None,
                    wedges: Wedges | None = None):
    """The AE raygen over pixel index tensors, plain version: (wrote (P,),
    color_alpha (P, 4))."""
    return _pixels(cells, tf, lp, xs, ys, width, height, "ae", sampler,
                   locator, None, wedges=wedges)[:2]


def frame_pixels_accel(cells: Cells, tf: Transfunc, accel, lp: LaunchParams,
                       xs, ys, width: int, height: int,
                       accel_mode: str = "sphere", sampler: str = "brute",
                       locator: Locator | None = None,
                       wedges: Wedges | None = None):
    """The accel raygen over pixel index tensors, plain version: (wrote
    (P,), color_alpha (P, 4))."""
    if accel_mode not in ("sphere", "grid"):
        raise ValueError(f"unknown accel_mode {accel_mode!r}")
    return _pixels(cells, tf, lp, xs, ys, width, height, accel_mode,
                   sampler, locator, accel, wedges=wedges)[:2]


def _parity_torch(cells: Cells, tf: Transfunc, lp: LaunchParams, pix,
                  accum, fb, debug, width: int, height: int, raygen: str,
                  sampler: str, locator, accel, work: Work | None = None,
                  wedges: Wedges | None = None, out=None):
    """Plain-PyTorch K8 over the lanes of `pix`: one sample, then the
    finalize into accum/fb IN PLACE, or in raw mode (`out`, an ops/fast.py
    RawSample) the sample's wrote and colour (0 where the ray misses the
    box) into out.wrote and out.ca, accum and fb unused and out.t left
    as it is; debug (L, 2) i32 gets each lane's final LCG state (u32 bits)
    and loop iterations; `work`, if given, counts the sample's events
    (ops/woodcock.py `Work`)."""
    pix = pix.long()
    wrote, ca, rng, steps = _pixels(cells, tf, lp, pix % width,
                                    pix // width, width, height, raygen,
                                    sampler, locator, accel, work, wedges)
    if out is not None:
        out.wrote.copy_(wrote)
        out.ca.copy_(torch.where(wrote[:, None], ca, 0.0))
    else:
        acc, pixels = _finalize(wrote, ca, accum, fb, lp.accum_id)
        accum.copy_(acc)
        fb.copy_(pixels)
    if debug is not None:
        debug[:, 0] = colorlib._u32_to_i32(rng)
        debug[:, 1] = steps


# ===========================================================================
# K8 kernel: build, bind, launch
# ===========================================================================

_RAYGENS = {"ae": 0, "sphere": 1, "grid": 2}
_SAMPLERS = {"locator": 0, "brute": 1, "wedge": 2}


@functools.cache
def _parity_params_type():
    """The ctypes mirror of `ParityParams` in csrc/parity.cu (same field
    order); built on first use, as it holds ops/fast.py's `_TrackFrame`
    (fast.py imports this module)."""
    from .fast import _TrackFrame
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fields = [(name, ptr) for name in (
        "planes", "h_bot", "h_top", "heights", "value", "num_layers", "bins",
        "majors", "lut", "pix", "accum", "fb", "dbg")]
    fields += [("frame", _TrackFrame)]
    fields += [(name, ptr) for name in ("blo", "bhi", "vr", "opacity_scale",
                                        "shell")]
    fields += [("win", ptr * 4), ("acc_lo", ptr), ("acc_hi", ptr),
               ("dims", i32 * 3)]
    fields += [(name, i32) for name in (
        "n_cells", "n_lat", "n_lon", "k_cap", "lut_size", "n_lanes", "width",
        "height", "max_iters")]
    fields += [("wverts", ptr), ("wscalars", ptr), ("woffset", ptr),
               ("layer_pad", i32), ("raw_wrote", ptr), ("raw_ca", ptr)]
    return type("_ParityParams", (ctypes.Structure,), {"_fields_": fields})


def build_parity():
    """Compile csrc/parity.cu for sm_90a (utils/cuda_build.py) and bind its
    C entry points; returns the ctypes library."""
    lib = cuda_build.build("parity")
    lib.parity_launch.argtypes = [ctypes.POINTER(_parity_params_type()),
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.parity_launch.restype = ctypes.c_int
    lib.parity_occupancy.argtypes = [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.parity_occupancy.restype = ctypes.c_int
    return lib


def parity_occupancy(raygen: str, sampler: str) -> dict:
    """{'blocks_per_sm', 'registers', 'local_bytes'} of the finalizing
    K8 kernel of raygen x sampler: its resident 128-thread blocks an SM,
    registers and local (stack and spill) bytes a thread."""
    lib = build_parity()
    out = (ctypes.c_int * 3)()
    cuda_build.check("parity_occupancy", lib.parity_occupancy(
        _RAYGENS[raygen], _SAMPLERS[sampler], out))
    return {"blocks_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2]}


def parity_params(cells: Cells, tf: Transfunc, lp: LaunchParams, accum, fb,
                  *, width: int, height: int, raygen: str, sampler: str,
                  locator: Locator | None = None, accel=None, pix=None,
                  debug=None, wedges: Wedges | None = None, out=None,
                  locator_dims=(0, 0), accel_dims=(0, 0, 0)):
    """K8's launch arguments (a `ParityParams` mirror), built without a
    device read: every scalar of the frame, the TF, the cells' shell (the
    wedges' with the wedge sampler), the locator window and the accel
    bounds as the device address of the tensor that holds it, which the
    kernel reads on the card
    (`locator_dims`, `accel_dims`: the host's ints of locator.dims and
    accel.dims).  Raises unless each tensor is contiguous, of its dtype
    and shape, on the lanes' device; on the card the planes' rows must
    start on 16-byte boundaries (the kernel reads them as float4)."""
    from .fast import _check as check, check_raw, check_rows, track_frame
    _check = lambda *a: check(*a, fn="parity_track")
    dev = (accum if out is None else out.ca).device
    n = cells.num_cells
    if pix is not None:
        L = pix.shape[0]
    else:
        L = width * height if out is not None else accum.shape[0]
        if L != width * height:
            raise ValueError("parity_track: without pix, accum must hold "
                             "width * height lanes")
    _check("cells.planes", cells.planes, F32, (n, 3, 4), dev)
    if dev.type == "cuda":
        check_rows("parity_track", "cells.planes",
                   cells.planes.view(n * 3, 4), 16)
    for name in ("h_bot", "h_top"):
        _check(f"cells.{name}", getattr(cells, name), F32, (n,), dev)
    _check("cells.shell", cells.shell, F32, (4,), dev)
    _check("cells.height", cells.height, F32, (n, 32), dev)
    _check("cells.value", cells.value, F32, (n, 32), dev)
    _check("cells.num_layers", cells.num_layers, torch.int32, (n,), dev)
    _check("tf.values", tf.values, F32, (None, 4), dev)
    _check("tf.value_range", tf.value_range, F32, (2,), dev)
    _check("tf.opacity_scale", tf.opacity_scale, F32, (), dev)
    for name in ("bounds_lo", "bounds_hi"):
        _check(f"lp.{name}", getattr(lp, name), F32, (3,), dev)
    check_raw("parity_track", out, accum, fb, L, 1, dev)
    if out is None:
        _check("accum", accum, F32, (L, 4), dev)
        _check("fb", fb, torch.int32, (L,), dev)
    if pix is not None:
        _check("pix", pix, torch.int32, (L,), dev)
    if debug is not None:
        _check("debug", debug, torch.int32, (L, 2), dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    p = _parity_params_type()(
        planes=ptr(cells.planes), h_bot=ptr(cells.h_bot),
        h_top=ptr(cells.h_top), heights=ptr(cells.height),
        value=ptr(cells.value), num_layers=ptr(cells.num_layers),
        lut=ptr(tf.values), pix=ptr(pix),
        accum=0 if out is not None else ptr(accum),
        fb=0 if out is not None else ptr(fb), dbg=ptr(debug),
        frame=track_frame(lp, dev, fn="parity_track"),
        blo=ptr(lp.bounds_lo), bhi=ptr(lp.bounds_hi), vr=ptr(tf.value_range),
        opacity_scale=ptr(tf.opacity_scale), shell=ptr(cells.shell),
        raw_wrote=0 if out is None else ptr(out.wrote),
        raw_ca=0 if out is None else ptr(out.ca),
        n_cells=n, lut_size=tf.values.shape[0], n_lanes=L, width=width,
        height=height, max_iters=MAX_ITERS)
    if sampler in ("locator", "wedge"):
        _check("locator.bins", locator.bins, torch.int32, (None, None), dev)
        win = (locator.lat_lo, locator.lat_hi, locator.lon_lo,
               locator.lon_hi)
        for name, t in zip(("lat_lo", "lat_hi", "lon_lo", "lon_hi"), win):
            _check(f"locator.{name}", t, F32, (), dev)
        p.bins = ptr(locator.bins)
        p.win = (ctypes.c_void_p * 4)(*(ptr(t) for t in win))
        p.n_lat, p.n_lon = locator_dims
        p.k_cap = locator.bins.shape[1]
    if sampler == "wedge":
        nw = wedges.verts.shape[0]
        _check("wedges.verts", wedges.verts, F32, (nw, 6, 3), dev)
        _check("wedges.scalars", wedges.scalars, F32, (nw, 6), dev)
        _check("wedges.cell_offset", wedges.cell_offset, torch.int32, (n,),
               dev)
        _check("wedges.shell", wedges.shell, F32, (4,), dev)
        p.wverts, p.wscalars = ptr(wedges.verts), ptr(wedges.scalars)
        p.woffset, p.layer_pad = ptr(wedges.cell_offset), wedges.layer_pad
        p.shell = ptr(wedges.shell)     # the wedge shell replaces the cells'
    if accel is not None:
        _check("accel.max_opacities", accel.max_opacities, F32, (None,),
               dev)
        lo, hi = ((accel.sph_lo, accel.sph_hi) if raygen == "sphere" else
                  (accel.world_lo, accel.world_hi))
        _check("accel bounds", lo, F32, (3,), dev)
        _check("accel bounds", hi, F32, (3,), dev)
        p.majors = ptr(accel.max_opacities)
        p.acc_lo, p.acc_hi = ptr(lo), ptr(hi)
        p.dims = (ctypes.c_int * 3)(*accel_dims)
    return p


def parity_track(cells: Cells, tf: Transfunc, lp: LaunchParams, accum, fb,
                 *, width: int, height: int, raygen: str = "ae",
                 sampler: str = "brute", locator: Locator | None = None,
                 accel=None, pix=None, debug=None,
                 wedges: Wedges | None = None, out=None):
    """K8 wrapper: one parity sample (raygen 'ae', 'sphere' or 'grid' with
    sampler 'locator', 'brute' or 'wedge', the last K9-p and needing
    `wedges`) for the lanes of `pix` ((L,) int32 pixel ids; None = every
    pixel in natural order), updating accum (L, 4) f32 and fb (L,) int32
    IN PLACE; lanes whose ray misses the volume bounds keep both.  Raw mode
    (`out`, an ops/fast.py RawSample of L lanes; accum and fb None) stores
    the sample instead -- out.wrote the box test, out.ca the colour and
    alpha the finalize would blend, 0 without a box hit -- for K10's mean
    over a samples axis (parallel/sharded.py); out.t is not written.
    debug, optional (L, 2) int32, receives each lane's final LCG state
    (u32 bits) and loop iterations.  CUDA tensors launch csrc/parity.cu,
    reading nothing back once the locator's and the accel's dims have been
    read (`host_values`, once per tensor); CPU tensors run
    `_parity_torch`; anything else raises."""
    from .fast import host_values
    if raygen not in _RAYGENS:
        raise ValueError(f"unknown raygen {raygen!r}")
    check_sampler(sampler, locator, wedges)
    if raygen != "ae" and accel is None:
        raise ValueError(f"raygen {raygen!r} needs an accel")
    dev = (accum if out is None else out.ca).device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"parity_track: unsupported device {dev}")
    kw = dict(width=width, height=height, raygen=raygen, sampler=sampler,
              locator=locator, accel=accel, pix=pix, debug=debug,
              wedges=wedges, out=out)
    if dev.type == "cpu":
        parity_params(cells, tf, lp, accum, fb, **kw)     # checks only
        L = pix.shape[0] if pix is not None else width * height
        _parity_torch(cells, tf, lp,
                      torch.arange(L, dtype=torch.int32) if pix is None
                      else pix, accum, fb, debug, width, height, raygen,
                      sampler, locator, accel, wedges=wedges, out=out)
        return
    if sampler in ("locator", "wedge"):
        kw["locator_dims"] = tuple(host_values(locator.dims))
        if locator.bins.shape[0] != kw["locator_dims"][0] \
                * kw["locator_dims"][1]:
            raise ValueError("parity_track: locator.bins rows != n_lat * "
                             "n_lon")
    if accel is not None:
        dims = tuple(host_values(accel.dims))
        if accel.max_opacities.shape[0] != dims[0] * dims[1] * dims[2]:
            raise ValueError("parity_track: accel.max_opacities size != "
                             "prod(dims)")
        kw["accel_dims"] = dims
    p = parity_params(cells, tf, lp, accum, fb, **kw)
    lib = build_parity()
    cuda_build.check("parity_track", lib.parity_launch(
        ctypes.byref(p), _RAYGENS[raygen], _SAMPLERS[sampler],
        torch.cuda.current_stream(dev).cuda_stream))
    launches[f"parity_{raygen}_{sampler}"
             + ("" if out is None else "_raw")] += 1


def render_frame_ae(cells: Cells, tf: Transfunc, lp: LaunchParams, accum,
                    fb, *, width: int, height: int, sampler: str = "brute",
                    locator: Locator | None = None,
                    wedges: Wedges | None = None):
    """One progressive sample over the whole frame at the global majorant 1
    (reference raygen 'woodcockTrackingAE'), through K8 (K9-p with the
    wedge sampler and `wedges`).  accum (H*W, 4) f32 and fb (H*W,) int32
    in natural pixel order (row 0 = bottom) are updated IN PLACE and
    returned."""
    parity_track(cells, tf, lp, accum, fb, width=width, height=height,
                 raygen="ae", sampler=sampler, locator=locator,
                 wedges=wedges)
    return accum, fb


def render_frame_accel(cells: Cells, tf: Transfunc, accel, lp: LaunchParams,
                       accum, fb, *, width: int, height: int,
                       accel_mode: str = "sphere", sampler: str = "brute",
                       locator: Locator | None = None,
                       wedges: Wedges | None = None):
    """One progressive sample with per-cell majorants driven by a traversal
    (reference raygen 'woodcockTrackingWithAccel'), through K8 (K9-p with
    the wedge sampler and `wedges`).  accel: a ShellAccel (accel_mode
    'sphere') or GridAccel ('grid') whose max_opacities are up to date for
    the transfer function.  accum/fb as `render_frame_ae`."""
    if accel_mode not in ("sphere", "grid"):
        raise ValueError(f"unknown accel_mode {accel_mode!r}")
    parity_track(cells, tf, lp, accum, fb, width=width, height=height,
                 raygen=accel_mode, sampler=sampler, locator=locator,
                 accel=accel, wedges=wedges)
    return accum, fb


def alloc_frame(width: int, height: int, device="cpu"):
    """Cleared accumulation (P, 4) f32 + framebuffer (P,) int32
    (ref: common/pipeline.cu:171-199)."""
    return (torch.zeros((width * height, 4), dtype=torch.float32,
                        device=device),
            torch.zeros((width * height,), dtype=torch.int32, device=device))


def fb_to_image(fb, width: int, height: int, bgcolor=None) -> np.ndarray:
    """Packed framebuffer -> (H, W, 4) uint8, bottom-up row order.

    bgcolor: optional (3,) linear RGB in [0,1] to alpha-composite the image
    over, as the reference presents over a window cleared to --bgcolor
    (ref: common/pipeline.cu:721,760)."""
    if isinstance(fb, torch.Tensor):
        fb = fb.cpu().numpy()
    img = colorlib.unpack_rgba(np.asarray(fb).reshape(height, width))
    if bgcolor is not None:
        b = np.asarray(bgcolor, np.float32)
        bg_srgb = np.where(b <= 0.0031308, 12.92 * b,
                           1.055 * np.power(b, 1.0 / 2.4) - 0.055)
        bg = np.clip(bg_srgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
        a = img[..., 3:4].astype(np.float32) / 255.0
        rgb = img[..., :3].astype(np.float32) * a + bg * (1.0 - a)
        img = np.concatenate([(rgb + 0.5).astype(np.uint8),
                              np.full_like(img[..., 3:4], 255)], axis=-1)
    return img
