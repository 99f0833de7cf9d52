"""Launch parameters, frame buffers and the progressive-accumulation epilogue.

The reference's OWL name->pointer launch-params registry
(ref: common/pipeline.cu:357-411) becomes a NamedTuple of small tensors
(`LaunchParams`); the accumulation buffer (P, 4) f32 and the packed RGBA8
framebuffer (P,) (int32 holding the u32 bits) live on the render device.

The reference-parity raygens (`ae`, `accel`) of the JAX package are not
ported yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import color as colorlib


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
