"""RGBA transfer function: LUT + value range + opacity scale.

Mirrors the reference's host Transfunc (ref: common/transfunc.h:29-49) and
device-side classification (ref: icon_rt/deviceCode.cu:127-135), including
the reference's asymmetric lerp quirk — the second LUT sample is scaled by
(1, 1, 1, opacityScale) but the first is not — kept for image parity.

The LUT has a fixed size so live transfer-function edits never change
shapes; the reference resamples user LUTs to 300 entries in batch mode
(ref: common/pipeline.cu:469-473).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_LUT_SIZE = 300

# Default 5-point blue-white-red LUT (ref: icon_rt/hostCode.cu:828-834)
DEFAULT_COLORS = np.array([
    [0.149, 0.015, 0.705, 1.00],
    [0.486, 0.603, 0.956, 0.75],
    [0.866, 0.866, 0.866, 0.50],
    [0.996, 0.690, 0.552, 0.25],
    [0.752, 0.298, 0.231, 0.00],
], np.float32)


class Transfunc(NamedTuple):
    """Device transfer function.  `values` has static shape (size, 4)."""
    values: torch.Tensor         # (S, 4) f32 RGBA LUT
    value_range: torch.Tensor    # (2,) f32 absolute data range mapped to [0, 1]
    opacity_scale: torch.Tensor  # () f32
    rel_range: torch.Tensor      # (2,) f32 (kept for .xf parity; editor state)

    @property
    def size(self) -> int:
        return self.values.shape[0]


def resample_lut(src: np.ndarray, dst_size: int) -> np.ndarray:
    """Linear resample of an (S, 4) LUT to (dst_size, 4).

    Matches the reference's resampleLUT including its inverted lerp weight
    (ref: common/dvr_course-common.h:44-70): result = (1-frac)*src[a] +
    frac*src[b]."""
    src = np.asarray(src, np.float32)
    s = src.shape[0]
    out = np.empty((dst_size, 4), np.float32)
    for i in range(dst_size):
        f = np.float32(i) / np.float32(dst_size) * (s - 1)
        a = int(f)
        b = min(a + 1, s - 1)
        frac = np.float32(f - a)
        out[i] = (1.0 - frac) * src[a] + frac * src[b]
    return out


def make_transfunc(colors: np.ndarray | None = None,
                   value_range=(0.0, 1.0),
                   opacity_scale: float = 1.0,
                   rel_range=(0.0, 1.0),
                   size: int = DEFAULT_LUT_SIZE,
                   device="cpu") -> Transfunc:
    if colors is None:
        colors = DEFAULT_COLORS
    colors = np.asarray(colors, np.float32)
    if colors.shape[0] != size:
        colors = resample_lut(colors, size)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return Transfunc(values=f32(colors), value_range=f32(value_range),
                     opacity_scale=f32(opacity_scale),
                     rel_range=f32(rel_range))


def post_classify(tf: Transfunc, v: torch.Tensor) -> torch.Tensor:
    """Scalar -> RGBA (..., 4) via the LUT (ref: icon_rt/deviceCode.cu:127-135):
      v normalized by valueRange; idx = int(v*size) (trunc toward zero);
      frac = v*size - idx;
      result = lut[clamp(idx)] * frac
             + lut[clamp(idx+1)] * (1-frac) * (1, 1, 1, opacityScale)
    """
    size = tf.size
    vn = (v - tf.value_range[0]) / (tf.value_range[1] - tf.value_range[0])
    vs = vn * float(size)
    idx = vs.to(torch.int32)    # C int cast: trunc toward zero
    frac = vs - idx.to(torch.float32)
    v1 = tf.values[torch.clamp(idx, 0, size - 1).long()]
    v2 = tf.values[torch.clamp(idx + 1, 0, size - 1).long()]
    one = torch.ones((), dtype=torch.float32, device=v.device)
    scale = torch.stack([one, one, one, tf.opacity_scale.to(torch.float32)])
    return v1 * frac[..., None] + v2 * (1.0 - frac)[..., None] * scale
