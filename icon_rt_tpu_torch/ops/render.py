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
from .woodcock import MAX_ITERS, Work, woodcock_track

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


def make_sample_fn(cells: Cells, locator: Locator | None, sampler: str,
                   wedges: Wedges | None = None):
    """Volume point-sampler dispatch (ref: deviceCode.cu:58-125), batched
    over lanes: 'brute' is the linear scan (the reference's no-RT
    fallback), 'locator' the grid-of-lists query (the reference's
    user-geometry and triangle modes both resolve to this analytic column
    sampling), 'wedge' the Newton wedge inversion of the cuBQL mode
    (models/wedges.py `sample_wedges`)."""
    if sampler == "brute":
        return lambda pos: sample_brute_force(cells, pos)
    if sampler == "locator":
        if locator is None:
            raise ValueError("sampler='locator' needs a Locator")
        dims = tuple(int(d) for d in locator.dims.tolist())
        return lambda pos: sample_locator(cells, locator, pos, dims)
    if sampler == "wedge":
        if locator is None or wedges is None:
            raise ValueError("sampler='wedge' needs a Locator and Wedges")
        dims = tuple(int(d) for d in locator.dims.tolist())
        return lambda pos: sample_wedges(cells, wedges, locator, pos, dims)
    raise ValueError(f"unknown sampler {sampler!r}")


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
                             work=work)
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


class _ParityParams(ctypes.Structure):
    """Mirror of `ParityParams` in csrc/parity.cu (same field order)."""
    _fields_ = [
        ("planes", ctypes.c_void_p), ("h_bot", ctypes.c_void_p),
        ("h_top", ctypes.c_void_p), ("heights", ctypes.c_void_p),
        ("value", ctypes.c_void_p), ("num_layers", ctypes.c_void_p),
        ("bins", ctypes.c_void_p), ("majors", ctypes.c_void_p),
        ("lut", ctypes.c_void_p), ("pix", ctypes.c_void_p),
        ("accum", ctypes.c_void_p), ("fb", ctypes.c_void_p),
        ("dbg", ctypes.c_void_p), ("cam", ctypes.c_float * 12),
        ("blo", ctypes.c_float * 3),
        ("bhi", ctypes.c_float * 3), ("amb", ctypes.c_float * 3),
        ("amb_rad", ctypes.c_float), ("ud", ctypes.c_float),
        ("vr", ctypes.c_float * 2), ("opacity_scale", ctypes.c_float),
        ("win", ctypes.c_float * 4), ("acc_lo", ctypes.c_float * 3),
        ("acc_hi", ctypes.c_float * 3), ("dims", ctypes.c_int * 3),
        ("n_cells", ctypes.c_int), ("n_lat", ctypes.c_int),
        ("n_lon", ctypes.c_int), ("k_cap", ctypes.c_int),
        ("lut_size", ctypes.c_int), ("n_lanes", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("accum_id", ctypes.c_int), ("max_iters", ctypes.c_int),
        ("wverts", ctypes.c_void_p), ("wscalars", ctypes.c_void_p),
        ("woffset", ctypes.c_void_p), ("layer_pad", ctypes.c_int),
        ("raw_wrote", ctypes.c_void_p), ("raw_ca", ctypes.c_void_p),
    ]


def build_parity():
    """Compile csrc/parity.cu for sm_90a (utils/cuda_build.py) and bind its
    C entry point; returns the ctypes library."""
    lib = cuda_build.build("parity")
    lib.parity_launch.argtypes = [ctypes.POINTER(_ParityParams),
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.parity_launch.restype = ctypes.c_int
    return lib


def _host_floats(*tensors):
    """One host read of small f32 tensors, flattened."""
    return torch.cat([t.reshape(-1).to(F32) for t in tensors]).tolist()


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
    (u32 bits) and loop iterations.  CUDA tensors launch csrc/parity.cu;
    CPU tensors run `_parity_torch`; anything else raises."""
    from .fast import _check as check, check_raw   # fast.py imports this
    _check = lambda *a: check(*a, fn="parity_track")
    if raygen not in _RAYGENS:
        raise ValueError(f"unknown raygen {raygen!r}")
    make_sample_fn(cells, locator, sampler, wedges)   # validates it
    if raygen != "ae" and accel is None:
        raise ValueError(f"raygen {raygen!r} needs an accel")
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
    for name in ("h_bot", "h_top"):
        _check(f"cells.{name}", getattr(cells, name), F32, (n,), dev)
    _check("cells.height", cells.height, F32, (n, 32), dev)
    _check("cells.value", cells.value, F32, (n, 32), dev)
    _check("cells.num_layers", cells.num_layers, torch.int32, (n,), dev)
    _check("tf.values", tf.values, F32, (None, 4), dev)
    check_raw("parity_track", out, accum, fb, L, 1, dev)
    if out is None:
        _check("accum", accum, F32, (L, 4), dev)
        _check("fb", fb, torch.int32, (L,), dev)
    if pix is not None:
        _check("pix", pix, torch.int32, (L,), dev)
    if debug is not None:
        _check("debug", debug, torch.int32, (L, 2), dev)
    if sampler in ("locator", "wedge"):
        _check("locator.bins", locator.bins, torch.int32, (None, None), dev)
    if sampler == "wedge":
        nw = wedges.verts.shape[0]
        _check("wedges.verts", wedges.verts, F32, (nw, 6, 3), dev)
        _check("wedges.scalars", wedges.scalars, F32, (nw, 6), dev)
        _check("wedges.cell_offset", wedges.cell_offset, torch.int32, (n,),
               dev)
    if accel is not None:
        _check("accel.max_opacities", accel.max_opacities, F32, (None,),
               dev)
    if dev.type == "cpu":
        if pix is None:
            pix = torch.arange(L, dtype=torch.int32)
        _parity_torch(cells, tf, lp, pix, accum, fb, debug, width, height,
                      raygen, sampler, locator, accel, wedges=wedges,
                      out=out)
        return
    if dev.type != "cuda":
        raise ValueError(f"parity_track: unsupported device {dev}")
    lib = build_parity()
    h = _host_floats(lp.cam_org, lp.cam_dir00, lp.cam_du, lp.cam_dv,
                     lp.bounds_lo, lp.bounds_hi, lp.ambient_color,
                     lp.ambient_radiance, lp.unit_distance, tf.value_range,
                     tf.opacity_scale)
    fa = lambda k, v: (ctypes.c_float * k)(*v)
    p = _ParityParams(
        planes=cells.planes.data_ptr(), h_bot=cells.h_bot.data_ptr(),
        h_top=cells.h_top.data_ptr(), heights=cells.height.data_ptr(),
        value=cells.value.data_ptr(),
        num_layers=cells.num_layers.data_ptr(), lut=tf.values.data_ptr(),
        pix=0 if pix is None else pix.data_ptr(),
        accum=0 if out is not None else accum.data_ptr(),
        fb=0 if out is not None else fb.data_ptr(),
        dbg=0 if debug is None else debug.data_ptr(),
        raw_wrote=0 if out is None else out.wrote.data_ptr(),
        raw_ca=0 if out is None else out.ca.data_ptr(),
        cam=fa(12, h[0:12]), blo=fa(3, h[12:15]), bhi=fa(3, h[15:18]),
        amb=fa(3, h[18:21]), amb_rad=h[21], ud=h[22], vr=fa(2, h[23:25]),
        opacity_scale=h[25], n_cells=n, lut_size=tf.values.shape[0],
        n_lanes=L, width=width, height=height, accum_id=int(lp.accum_id),
        max_iters=MAX_ITERS)
    if sampler in ("locator", "wedge"):
        n_lat, n_lon = (int(d) for d in locator.dims.tolist())
        if locator.bins.shape[0] != n_lat * n_lon:
            raise ValueError("parity_track: locator.bins rows != n_lat * "
                             "n_lon")
        p.bins = locator.bins.data_ptr()
        p.win = fa(4, _host_floats(locator.lat_lo, locator.lat_hi,
                                   locator.lon_lo, locator.lon_hi))
        p.n_lat, p.n_lon, p.k_cap = n_lat, n_lon, locator.bins.shape[1]
    if sampler == "wedge":
        p.wverts, p.wscalars = wedges.verts.data_ptr(), \
            wedges.scalars.data_ptr()
        p.woffset, p.layer_pad = wedges.cell_offset.data_ptr(), \
            wedges.layer_pad
    if accel is not None:
        dims = [int(d) for d in accel.dims.tolist()]
        if accel.max_opacities.shape[0] != dims[0] * dims[1] * dims[2]:
            raise ValueError("parity_track: accel.max_opacities size != "
                             "prod(dims)")
        lohi = _host_floats(*((accel.sph_lo, accel.sph_hi)
                              if raygen == "sphere" else
                              (accel.world_lo, accel.world_hi)))
        p.majors = accel.max_opacities.data_ptr()
        p.acc_lo, p.acc_hi = fa(3, lohi[0:3]), fa(3, lohi[3:6])
        p.dims = (ctypes.c_int * 3)(*dims)
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
