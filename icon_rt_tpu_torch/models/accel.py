"""Majorant helpers shared by the empty-space accelerators: the host-side
range rasterizer and the TF-edit range-max pass (kernel K5b).

K5b `max_opacity` (Triton) maps per-bin value ranges through the LUT's
alpha channel to per-bin majorants — the reference's computeMaxOpacities
(ref: hostCode.cu:362-434).  It replaces the XLA-fused
icon_rt_tpu/models/accel.py `compute_max_opacities` (a sparse-table
range-max) and runs on every TF edit.  On the H100 it is bound by launch
latency at the 64 radial bands of the fast path, and by reading the
(M, 2) ranges (8 bytes per row) at the >= 1M-bin accel grids that reuse
it: each program keeps the whole alpha column (<= 512 floats) in registers
and reduces one masked (rows, LUT) tile per block of rows, so the LUT is
read once per program and the ranges once in total.
"""
from __future__ import annotations

import numpy as np
import torch

F = np.float32

#: K5b launches (the wrapper adds one per kernel launch; plain-version runs
#: on the CPU do not count)
launches = 0

tl = None          # triton.language, bound on first launch
_KERNEL = None


# ---------------------------------------------------------------------------
# Host-side build helper (numpy scatter-min/max)
# ---------------------------------------------------------------------------

def _rasterize(vr_lo, vr_hi, lo_idx, up_idx, val_lo, val_hi, dims):
    """Scatter (val_lo, val_hi) min/max into every bin of [lo_idx, up_idx]
    boxes.  Prefers the C++ host module; the numpy fallback uses a
    vectorized offset loop for small footprints and a per-item loop for
    the rare huge ones."""
    from ..utils.native import native_rasterize
    if native_rasterize(np.ascontiguousarray(lo_idx),
                        np.ascontiguousarray(up_idx),
                        val_lo, val_hi, dims, vr_lo, vr_hi):
        return
    ext = up_idx - lo_idx + 1
    small = np.all(ext <= 8, axis=1)
    sx, sy = dims[0], dims[1]

    def flat(ix, iy, iz):
        return iz * sx * sy + iy * sx + ix

    li, ui = lo_idx[small], up_idx[small]
    vl, vh = val_lo[small], val_hi[small]
    if li.shape[0]:
        me = ui - li + 1
        for dz in range(int(me[:, 2].max())):
            for dy in range(int(me[:, 1].max())):
                for dx in range(int(me[:, 0].max())):
                    m = (dx < me[:, 0]) & (dy < me[:, 1]) & (dz < me[:, 2])
                    ids = flat(li[m, 0] + dx, li[m, 1] + dy, li[m, 2] + dz)
                    np.minimum.at(vr_lo, ids, vl[m])
                    np.maximum.at(vr_hi, ids, vh[m])
    for j in np.nonzero(~small)[0]:
        zz, yy, xx = np.meshgrid(
            np.arange(lo_idx[j, 2], up_idx[j, 2] + 1),
            np.arange(lo_idx[j, 1], up_idx[j, 1] + 1),
            np.arange(lo_idx[j, 0], up_idx[j, 0] + 1), indexing="ij")
        ids = flat(xx.ravel(), yy.ravel(), zz.ravel())
        np.minimum.at(vr_lo, ids, val_lo[j])
        np.maximum.at(vr_hi, ids, val_hi[j])


# ---------------------------------------------------------------------------
# K5b: majorants from the transfer function
# ---------------------------------------------------------------------------

def _lut_index_range(value_ranges, size: int, tf_value_range):
    """(ilo, ihi) LUT index range of each value range, derived exactly as
    the reference: ilo = clamp(int(lo_n*(S-1))), ihi = clamp(int(hi_n*(S-1))+1)."""
    span = tf_value_range[1] - tf_value_range[0]
    lo_n = (value_ranges[:, 0] - tf_value_range[0]) / span
    hi_n = (value_ranges[:, 1] - tf_value_range[0]) / span
    ilo = torch.clamp((lo_n * float(size - 1)).to(torch.int32), 0, size - 1)
    ihi = torch.clamp((hi_n * float(size - 1)).to(torch.int32) + 1,
                      0, size - 1)
    return ilo.long(), ihi.long()


def compute_max_opacities_torch(value_ranges, lut, tf_value_range):
    """Plain-PyTorch K5b: range-max of LUT alpha over [ilo, ihi] through a
    sparse table (levels[k][i] = max(alpha[i : i + 2^k])), O(1) per row.
    Empty rows (upper < lower) get majorant 0."""
    size = lut.shape[0]
    ilo, ihi = _lut_index_range(value_ranges, size, tf_value_range)
    alpha = lut[:, 3]
    levels = [alpha]
    k = 1
    while (1 << k) <= size:
        prev = levels[-1]
        half = 1 << (k - 1)
        shifted = torch.cat([prev[half:], prev[-1:].repeat(half)])
        levels.append(torch.maximum(prev, shifted))
        k += 1
    length = ihi - ilo + 1
    kk = torch.zeros_like(length)
    for j in range(1, len(levels)):
        kk = torch.where(length >= (1 << j), j, kk)
    table = torch.stack(levels)                       # (K, S)
    a = table[kk, ilo]
    b = table[kk, torch.clamp(ihi - (1 << kk) + 1, min=0)]
    mo = torch.maximum(a, b)
    empty = value_ranges[:, 1] < value_ranges[:, 0]
    return torch.where(empty, 0.0, mo).to(torch.float32)


def _max_opacity_kernel(vr_ptr, lut_ptr, tfr_ptr, out_ptr, M, S, s_m1,
                        BLOCK_M: tl.constexpr, BLOCK_S: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    rm = rows < M
    lo = tl.load(vr_ptr + rows * 2, mask=rm, other=0.0)
    hi = tl.load(vr_ptr + rows * 2 + 1, mask=rm, other=0.0)
    v0 = tl.load(tfr_ptr)
    span = tl.load(tfr_ptr + 1) - v0
    lo_n = tl.math.div_rn(lo - v0, span)
    hi_n = tl.math.div_rn(hi - v0, span)
    ilo = tl.minimum(tl.maximum((lo_n * s_m1).to(tl.int32), 0), S - 1)
    ihi = tl.minimum(tl.maximum((hi_n * s_m1).to(tl.int32) + 1, 0), S - 1)
    cols = tl.arange(0, BLOCK_S)
    alpha = tl.load(lut_ptr + cols * 4 + 3, mask=cols < S,
                    other=-float("inf"))
    inr = (cols[None, :] >= ilo[:, None]) & (cols[None, :] <= ihi[:, None])
    mo = tl.max(tl.where(inr, alpha[None, :], -float("inf")), axis=1)
    # an inverted range reads the sparse table's two end entries
    a_lo = tl.load(lut_ptr + ilo * 4 + 3, mask=rm, other=0.0)
    a_hi = tl.load(lut_ptr + ihi * 4 + 3, mask=rm, other=0.0)
    mo = tl.where(ihi < ilo, tl.maximum(a_lo, a_hi), mo)
    mo = tl.where(hi < lo, 0.0, mo)
    tl.store(out_ptr + rows, mo, mask=rm)


def max_opacity(value_ranges, lut, tf_value_range):
    """K5b wrapper: map per-bin value ranges through the LUT and the TF
    value range to majorants (ref: hostCode.cu:362-434); empty bins get 0.
    The Triton kernel runs for CUDA tensors, the plain version for CPU
    tensors.  value_ranges (M, 2) f32, lut (S, 4) f32, tf_value_range
    (2,) f32, all contiguous on one device.  Returns (M,) f32."""
    global launches, _KERNEL, tl
    for name, x, nd in (("value_ranges", value_ranges, 2), ("lut", lut, 2),
                        ("tf_value_range", tf_value_range, 1)):
        if x.dtype != torch.float32 or x.dim() != nd or not x.is_contiguous():
            raise ValueError(f"max_opacity: {name} must be a contiguous "
                             f"{nd}-D float32 tensor")
        if x.device != value_ranges.device:
            raise ValueError("max_opacity: tensors on different devices")
    if value_ranges.shape[1] != 2 or lut.shape[1] != 4 \
            or tf_value_range.shape[0] != 2:
        raise ValueError("max_opacity: expected shapes (M, 2), (S, 4), (2,)")
    dev = value_ranges.device
    if dev.type == "cpu":
        return compute_max_opacities_torch(value_ranges, lut, tf_value_range)
    if dev.type != "cuda":
        raise ValueError(f"max_opacity: unsupported device {dev}")
    if _KERNEL is None:
        import triton
        import triton.language as tl
        _KERNEL = triton.jit(_max_opacity_kernel)
    m, s = value_ranges.shape[0], lut.shape[0]
    out = torch.empty(m, dtype=torch.float32, device=dev)
    block_m = 32
    block_s = max(16, 1 << (s - 1).bit_length())
    _KERNEL[(max(1, -(-m // block_m)),)](
        value_ranges, lut, tf_value_range, out, m, s, float(s - 1),
        BLOCK_M=block_m, BLOCK_S=block_s, enable_fp_fusion=False)
    launches += 1
    return out
