"""Color conversion and RGBA8 packing, matching the reference bit-for-bit.

ref: common/dvr_course-common-both.h:30-35 (linear_to_srgb),
     :89-110 (make_8bit / make_rgba).

A packed framebuffer is an int32 tensor holding the u32 bit pattern
R | G<<8 | B<<16 | A<<24 (PyTorch has no usable uint32 arithmetic); read it
back on the host with numpy `.view(np.uint32)`.
"""
from __future__ import annotations

import numpy as np
import torch

_SRGB_EXP = float(np.float32(1.0 / 2.4))


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """sRGB OETF; branch at 0.0031308 exactly as the reference."""
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(x, _SRGB_EXP) - 0.055)


def make_8bit(f: torch.Tensor) -> torch.Tensor:
    """min(255, max(0, int(f*256))) with C truncation-toward-zero (int32)."""
    return torch.clamp((f.to(torch.float32) * 256.0).to(torch.int32), 0, 255)


def make_rgba(color: torch.Tensor) -> torch.Tensor:
    """(..., 4) float RGBA -> int32 holding R|G<<8|B<<16|A<<24."""
    r = make_8bit(color[..., 0])
    g = make_8bit(color[..., 1])
    b = make_8bit(color[..., 2])
    a = make_8bit(color[..., 3])
    # A << 24 overflows int32 for A >= 128: build in int64, then wrap
    packed = (r.to(torch.int64) | (g.to(torch.int64) << 8)
              | (b.to(torch.int64) << 16) | (a.to(torch.int64) << 24))
    return _u32_to_i32(packed)


def _u32_to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor with the same bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def unpack_rgba(packed) -> np.ndarray:
    """Packed u32 framebuffer (...,) -> uint8 (..., 4) RGBA channels.
    Takes an int32 tensor/array holding the u32 bits, or a uint32 array."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    if packed.dtype == np.int32:
        packed = packed.view(np.uint32)
    packed = packed.astype(np.uint32)
    out = np.empty(packed.shape + (4,), np.uint8)
    out[..., 0] = packed & 0xFF
    out[..., 1] = (packed >> 8) & 0xFF
    out[..., 2] = (packed >> 16) & 0xFF
    out[..., 3] = (packed >> 24) & 0xFF
    return out
