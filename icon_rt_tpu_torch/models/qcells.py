"""Quantized device cells — the storage tier of the big scenes, and K5c-q,
its transfer-function (TF) alpha bake.

The f32 fast-path tables (ops/fast.PackedCells) cost 64 + 640 bytes per
cell; this tier stores the same columns quantized:

  test12   (N, 12) f32 — 3 side-plane NORMALS (the planes pass through the
           origin because column edges are radial, so w == 0 and is not
           stored) + h_bot + h_top + num_layers.              48 B/cell
  h_frac   (N, Lm) or (1, Lm) f32 — per-layer ceiling heights normalized to
           [h_bot, h_top] on the 0..65535 grid (exact in f32); one shared
           row when every column has the same layer spacing.
  value_q  (N, Lm) u8 — layer scalars on a 256-level grid of the global
           data range; TF-independent.                         Lm B/cell
  alpha_q  (N, Lm) u8 — classified alpha (opacity scale included),
           normalized by alpha_max and FLOOR-quantized, so a stored alpha
           never exceeds the true one (the Woodcock majorants stay
           conservative).                                      Lm B/cell

Lm trims the 32-layer padding to the next multiple of 8 >= the layer
count.  A TF edit re-bakes only alpha_q, through a 256-entry table (one
entry per value level); RGB is classified at shade time from the value.

K5c-q (Triton): `bake_lookup` (out = tab[value_q]) and `bake_patch`
(alpha_q rewritten where value_q hits one of <= 32 changed levels), each
beside its plain version `_bake_lookup_torch` / `_bake_patch_torch`.  They
replace the XLA-fused icon_rt_tpu/models/qcells.py `_bake_lookup` and
`_bake_patch`, which avoided gathers with 256- or 32-way compare-select
reduces because a TPU gather from a small table lowers to scalar loads.  On
the H100 each is one pass over the u8 table (21 MB read, 21 MB written at
subdiv 8 x 16 layers), bound by device-memory bandwidth: the 256-byte table
is a cached gather, the patch 32 compare-selects per byte in registers.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..data.icfile import ICDataset, MAX_LAYERS
from .cells import _corner_xyz, _np_plane
from .transfunc import Transfunc

F = np.float32
F32 = torch.float32

#: K5c-q kernel launches (the wrappers count only Triton launches)
launches = {"bake_lookup": 0, "bake_patch": 0}

tl = None          # triton.language, bound on first launch
_KERNELS = {}

#: changed levels up to which a re-bake patches instead of re-looking-up
PATCH_LEVELS = 32


class QuantizedCells(NamedTuple):
    test12: torch.Tensor    # (N, 12) f32
    h_frac: torch.Tensor    # (1, Lm) or (N, Lm) f32 on the u16 grid
    value_q: torch.Tensor   # (N, Lm) u8
    alpha_q: torch.Tensor   # (N, Lm) u8
    value_lo: torch.Tensor  # () f32
    value_hi: torch.Tensor  # () f32
    alpha_max: torch.Tensor  # () f32 dequant scale of alpha_q
    alpha_tab: np.ndarray | None = None  # (256,) u8 host copy of the
    # normalized table alpha_q was baked from (None = unknown); invariant:
    # alpha_q == alpha_tab[value_q]

    @property
    def num_cells(self) -> int:
        return self.test12.shape[0]

    @property
    def lm(self) -> int:
        return self.h_frac.shape[1]


def check_q_ceilings(h_frac, test12):
    """Raise ValueError naming the first column whose dequantized ceilings
    h_bot + hf[k] * s (k < num_layers, s = (h_top - h_bot) / 65535) do not
    ascend: its h_frac row (or the shared one) descends somewhere below its
    num_layers, or h_top < h_bot.  IEEE rounding is monotone, so the two
    conditions are enough.  The quantized tracker K2 finds a layer by
    binary search over these ceilings and keeps its bracket
    (csrc/tier_q.cuh).  h_frac (1 or N, Lm) and test12 (N, 12) f32 tensors
    on any device; one host read."""
    nl = test12[:, 11]
    desc = ~(h_frac[:, 1:] >= h_frac[:, :-1])          # pair (k - 1, k)
    k = torch.arange(1, h_frac.shape[1], device=h_frac.device,
                     dtype=nl.dtype)
    if h_frac.shape[0] == 1:
        first = k[desc[0]]
        bad = nl > first[0] if first.numel() else torch.zeros_like(
            nl, dtype=torch.bool)
    else:
        bad = (desc & (k[None, :] < nl[:, None])).any(1)
    bad = bad | ~(test12[:, 10] >= test12[:, 9])
    if bool(bad.any()):
        cols = torch.nonzero(bad)[:, 0]
        raise ValueError(f"column {int(cols[0])}: its quantized layer "
                         f"ceilings do not ascend ({cols.numel()} such "
                         f"columns)")


def quantize_dataset_values(ds: ICDataset) -> tuple[ICDataset, float, float]:
    """Round ds.value to the 256-level grid IN the dataset, so every
    consumer (band value ranges, stats, renders) sees the field the
    quantized renderer samples.  Returns (dataset, lo, hi)."""
    mask = np.arange(MAX_LAYERS)[None, :] < ds.num_layers[:, None]
    if ds.num_cells:
        lo = float(np.where(mask, ds.value, np.float32(np.inf)).min())
        hi = float(np.where(mask, ds.value, np.float32(-np.inf)).max())
    else:
        lo, hi = 0.0, 1.0
    if not hi > lo:
        hi = lo + 1.0
    q = np.clip(np.rint((ds.value - lo) / (hi - lo) * 255.0), 0, 255)
    value = (lo + q * ((hi - lo) / 255.0)).astype(F)
    ds_q = dataclasses.replace(ds, value=np.where(mask, value, 0.0).astype(F))
    return ds_q, lo, hi


def quantize_cells(ds: ICDataset,
                   value_range: tuple[float, float] | None = None,
                   device="cpu") -> QuantizedCells:
    """Host-side quantization (numpy), tables moved to `device`; alpha_q
    starts at 0 — bake it with `bake_alpha_q` before rendering.

    value_range: the (lo, hi) of an earlier quantize_dataset_values, to
    skip the re-snap pass."""
    n = ds.num_cells
    idx = np.arange(n)
    h_bot = ds.height[:, 0].astype(F)
    h_top = ds.height[idx, ds.num_layers].astype(F)
    lm = int(ds.num_layers.max()) if n else 1
    lm = max(8, -(-lm // 8) * 8)

    bv = _corner_xyz(ds, h_bot)
    tv = _corner_xyz(ds, h_top)
    # planes through (bv_i, bv_j, tv_j), CCW (ref: icon_rt/ICONGrid.h:197-199)
    p1 = _np_plane(bv[:, 0], bv[:, 1], tv[:, 1])
    p2 = _np_plane(bv[:, 1], bv[:, 2], tv[:, 2])
    p3 = _np_plane(bv[:, 2], bv[:, 0], tv[:, 0])

    test12 = np.zeros((n, 12), F)
    test12[:, 0:3] = p1[:, :3]
    test12[:, 3:6] = p2[:, :3]
    test12[:, 6:9] = p3[:, :3]
    test12[:, 9] = h_bot
    test12[:, 10] = h_top
    test12[:, 11] = ds.num_layers.astype(F)

    # per-layer CEILING heights h[1..lm] normalized to [h_bot, h_top]
    span = np.maximum(h_top - h_bot, 1e-6).astype(F)
    ceil_h = ds.height[:, 1:lm + 1].astype(F)  # (N, lm); garbage past nl
    hf = np.clip(np.rint((ceil_h - h_bot[:, None]) / span[:, None] * 65535.0),
                 0, 65535).astype(np.uint16)
    k = np.arange(1, lm + 1)
    valid = k[None, :] <= ds.num_layers[:, None]
    hf = np.where(valid, hf, np.uint16(65535))
    if n and bool((hf == hf[0]).all()):
        hf = hf[:1]   # uniform layer spacing: one shared row

    if value_range is None:
        ds_q, lo, hi = quantize_dataset_values(ds)
    else:
        ds_q, (lo, hi) = ds, value_range
    vq = np.clip(np.rint((ds_q.value[:, :lm] - lo)
                         * (np.float32(255.0) / np.float32(hi - lo))),
                 0, 255).astype(np.uint8)

    check_q_ceilings(torch.from_numpy(hf.astype(F)),
                     torch.from_numpy(test12))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    f32 = lambda v: torch.tensor(v, dtype=F32, device=device)
    return QuantizedCells(
        test12=t(test12), h_frac=t(hf.astype(F)), value_q=t(vq),
        alpha_q=torch.zeros((n, lm), dtype=torch.uint8, device=device),
        value_lo=f32(lo), value_hi=f32(hi), alpha_max=f32(1.0))


def _classify_alpha_table(tf: Transfunc, value_lo, value_hi) -> torch.Tensor:
    """(256,) classified alpha of each dequantized value level — the exact
    postClassify arithmetic (ref: deviceCode.cu:127-135), alpha channel,
    with the reference's asymmetric lerp (only the second LUT sample is
    scaled by the opacity scale)."""
    dev = tf.values.device
    levels = value_lo + torch.arange(256, dtype=F32, device=dev) / 255.0 \
        * (value_hi - value_lo)
    size = tf.size
    vn = (levels - tf.value_range[0]) \
        / (tf.value_range[1] - tf.value_range[0])
    vs = vn * float(size)
    idx = vs.to(torch.int32)
    frac = vs - idx.to(F32)
    i1 = torch.clamp(idx, 0, size - 1).long()
    i2 = torch.clamp(idx + 1, 0, size - 1).long()
    lut_a = tf.values[:, 3]
    return lut_a[i1] * frac + lut_a[i2] * (1.0 - frac) \
        * tf.opacity_scale.to(F32)


def bake_alpha_q(q: QuantizedCells, tf: Transfunc) -> QuantizedCells:
    """TF-edit hook of the quantized tier (the f32 path's full re-bake,
    ref: hostCode.cu:878-909): the 256-entry table, then

      * the normalized u8 table equals the one alpha_q was baked from:
        only alpha_max moves (alpha_q is already right);
      * at most PATCH_LEVELS levels changed: `bake_patch` rewrites the
        cells whose value hits one of them;
      * otherwise `bake_lookup` re-bakes the whole table.

    Floor quantization keeps every stored alpha <= the true alpha."""
    a_tab = _classify_alpha_table(tf, q.value_lo, q.value_hi)
    a_max = torch.clamp(torch.max(a_tab), min=1e-8)
    q_tab = torch.floor(a_tab / a_max * 255.0).to(torch.uint8)
    tab_host = q_tab.cpu().numpy()
    if q.alpha_tab is not None and np.array_equal(tab_host, q.alpha_tab):
        return q._replace(alpha_max=a_max)
    if q.alpha_tab is not None:
        changed = np.nonzero(tab_host != q.alpha_tab)[0]
        if changed.size <= PATCH_LEVELS:
            lev = np.full(PATCH_LEVELS, -1, np.int32)   # -1 never matches
            lev[:changed.size] = changed
            dev = q.value_q.device
            alpha_q = bake_patch(
                q.value_q, q.alpha_q, torch.from_numpy(lev).to(dev),
                torch.from_numpy(tab_host[np.maximum(lev, 0)]).to(dev))
            return q._replace(alpha_q=alpha_q, alpha_max=a_max,
                              alpha_tab=tab_host)
    return q._replace(alpha_q=bake_lookup(q.value_q, q_tab),
                      alpha_max=a_max, alpha_tab=tab_host)


# ---------------------------------------------------------------------------
# K5c-q: the u8 table passes
# ---------------------------------------------------------------------------

def _bake_lookup_torch(vq, tab):
    """Plain K5c-q lookup: tab[vq] over the (N, Lm) u8 table."""
    return tab[vq.long()]


def _bake_patch_torch(vq, aq_old, lev, new):
    """Plain K5c-q patch: new[j] where vq == lev[j], else aq_old (lev is
    -1 padded and its entries distinct)."""
    hit = vq.to(torch.int32)[..., None] == lev
    sel = torch.where(hit, new.to(torch.int32), 0).sum(-1).to(torch.uint8)
    return torch.where(hit.any(-1), sel, aq_old)


def _bake_lookup_kernel(vq_ptr, tab_ptr, out_ptr, n, BLOCK: tl.constexpr):
    # int64 offsets: value_q has 1.34e9 entries at subdiv 11 x 16 layers
    i = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    v = tl.load(vq_ptr + i, mask=m, other=0).to(tl.int32)
    tl.store(out_ptr + i, tl.load(tab_ptr + v, mask=m), mask=m)


def _bake_patch_kernel(vq_ptr, aq_ptr, lev_ptr, new_ptr, out_ptr, n,
                       BLOCK: tl.constexpr, NLEV: tl.constexpr):
    i = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    v = tl.load(vq_ptr + i, mask=m, other=0).to(tl.int32)
    out = tl.load(aq_ptr + i, mask=m, other=0)
    for j in tl.static_range(NLEV):
        out = tl.where(v == tl.load(lev_ptr + j), tl.load(new_ptr + j), out)
    tl.store(out_ptr + i, out, mask=m)


def _kernel(name):
    global tl
    if name not in _KERNELS:
        import triton
        import triton.language as tl
        fn = {"bake_lookup": _bake_lookup_kernel,
              "bake_patch": _bake_patch_kernel}[name]
        _KERNELS[name] = triton.jit(fn)
    return _KERNELS[name]


def _check_u8(fn, name, x, like):
    if x.dtype != torch.uint8 or not x.is_contiguous() \
            or x.shape != like.shape or x.device != like.device:
        raise ValueError(f"{fn}: {name} must be a contiguous uint8 tensor "
                         f"of shape {tuple(like.shape)} on {like.device}")


def bake_lookup(vq, tab):
    """K5c-q wrapper, full bake: tab[vq] for the (N, Lm) u8 value table and
    a (256,) u8 table.  The Triton kernel runs for CUDA tensors, the plain
    version for CPU tensors; anything else raises."""
    if vq.dtype != torch.uint8 or not vq.is_contiguous():
        raise ValueError("bake_lookup: vq must be a contiguous uint8 tensor")
    if tab.dtype != torch.uint8 or tab.shape != (256,) \
            or tab.device != vq.device:
        raise ValueError("bake_lookup: tab must be (256,) uint8 on vq's "
                         "device")
    if vq.device.type == "cpu":
        return _bake_lookup_torch(vq, tab)
    if vq.device.type != "cuda":
        raise ValueError(f"bake_lookup: unsupported device {vq.device}")
    out = torch.empty_like(vq)
    n, block = vq.numel(), 2048
    if n:
        _kernel("bake_lookup")[(-(-n // block),)](vq, tab.contiguous(), out,
                                                 n, BLOCK=block)
        launches["bake_lookup"] += 1
    return out


def bake_patch(vq, aq_old, lev, new):
    """K5c-q wrapper, patch: aq_old with new[j] wherever vq == lev[j], for
    PATCH_LEVELS (-1 padded, distinct) i32 levels and their u8 values.
    Returns a new table; aq_old stays valid (successive edits may start
    from one base).  Triton for CUDA tensors, plain version for CPU ones."""
    if vq.dtype != torch.uint8 or not vq.is_contiguous():
        raise ValueError("bake_patch: vq must be a contiguous uint8 tensor")
    _check_u8("bake_patch", "aq_old", aq_old, vq)
    if lev.dtype != torch.int32 or lev.shape != (PATCH_LEVELS,) \
            or new.dtype != torch.uint8 or new.shape != (PATCH_LEVELS,) \
            or lev.device != vq.device or new.device != vq.device:
        raise ValueError(f"bake_patch: lev ({PATCH_LEVELS},) int32 and new "
                         f"({PATCH_LEVELS},) uint8 on vq's device")
    if vq.device.type == "cpu":
        return _bake_patch_torch(vq, aq_old, lev, new)
    if vq.device.type != "cuda":
        raise ValueError(f"bake_patch: unsupported device {vq.device}")
    out = torch.empty_like(vq)
    n, block = vq.numel(), 2048
    if n:
        _kernel("bake_patch")[(-(-n // block),)](
            vq, aq_old, lev.contiguous(), new.contiguous(), out, n,
            BLOCK=block, NLEV=PATCH_LEVELS)
        launches["bake_patch"] += 1
    return out
