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

K5c-q (CUDA C++, csrc/bake_q.cu): `bake_lookup` (out = tab[value_q], into
a new table or in place), beside its plain version `_bake_lookup_torch`.
It replaces the XLA-fused icon_rt_tpu/models/qcells.py `_bake_lookup` and
`_bake_patch`, which avoided gathers with 256- or 32-way compare-select
reduces because a TPU gather from a small table lowers to scalar loads.
Since alpha_q == alpha_tab[value_q], JAX's patch of the changed levels
equals the lookup of the new table; on the H100 the lookup is one pass
bound by device-memory bytes (reads value_q, writes the table: 2n), where
a patch into a new table moves 3n and an in-place patch, measured at R2B9,
beat it only on edits of rare levels, which the app does not make (PERF.md
§6).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..data.icfile import ICDataset, MAX_LAYERS
from ..utils import cuda_build
from .cells import _corner_xyz, _np_plane
from .transfunc import Transfunc

F = np.float32
F32 = torch.float32

#: K5c-q kernel launches (the wrapper counts only CUDA launches)
launches = {"bake_lookup": 0}


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

    # per-layer CEILING heights h[1..lm] normalized to [h_bot, h_top]; a
    # dataset holds MAX_LAYERS - 1 ceilings, so at 25-31 layers (Lm 32) the
    # last column is padding, masked to 65535 below with the others past nl
    span = np.maximum(h_top - h_bot, 1e-6).astype(F)
    ceil_h = ds.height[:, 1:lm + 1].astype(F)  # (N, <= lm); garbage past nl
    ceil_h = np.pad(ceil_h, ((0, 0), (0, lm - ceil_h.shape[1])))
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


def bake_alpha_q(q: QuantizedCells, tf: Transfunc, *,
                 donate: bool = False) -> QuantizedCells:
    """TF-edit hook of the quantized tier (the f32 path's full re-bake,
    ref: hostCode.cu:878-909): the 256-entry table, then

      * the normalized u8 table equals the one alpha_q was baked from:
        only alpha_max moves (alpha_q is already right);
      * otherwise `bake_lookup` re-bakes the whole table, into q.alpha_q
        when `donate` (the caller gives up q.alpha_q, as the app's get_q
        does), else into a new one.  By the invariant alpha_q ==
        alpha_tab[value_q] it equals JAX's patch of the changed levels.

    Without `donate` q.alpha_q is never written (callers may edit again
    from q).  Floor quantization keeps every stored alpha <= the true
    alpha."""
    a_tab = _classify_alpha_table(tf, q.value_lo, q.value_hi)
    a_max = torch.clamp(torch.max(a_tab), min=1e-8)
    q_tab = torch.floor(a_tab / a_max * 255.0).to(torch.uint8)
    tab_host = q_tab.cpu().numpy()
    if q.alpha_tab is not None and np.array_equal(tab_host, q.alpha_tab):
        return q._replace(alpha_max=a_max)
    return q._replace(alpha_max=a_max, alpha_tab=tab_host,
                      alpha_q=bake_lookup(q.value_q, q_tab,
                                          out=q.alpha_q if donate else None))


# ---------------------------------------------------------------------------
# K5c-q: the u8 table pass
# ---------------------------------------------------------------------------

class _BakeParams(ctypes.Structure):
    """Mirror of `BakeParams` in csrc/bake_q.cu (same field order)."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("vq", "tab", "out")] + [
        ("n", ctypes.c_longlong)]


def build_bake_q():
    """Compile csrc/bake_q.cu for sm_90a (utils/cuda_build.py) and bind its
    C entry points; returns the ctypes library."""
    lib = cuda_build.build("bake_q")
    lib.bake_lookup_launch.argtypes = [ctypes.POINTER(_BakeParams),
                                       ctypes.c_void_p]
    lib.bake_lookup_launch.restype = ctypes.c_int
    lib.bake_q_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.bake_q_occupancy.restype = ctypes.c_int
    return lib


def bake_q_occupancy() -> dict:
    """{'blocks_per_sm', 'registers', 'local_bytes'} of K5c-q's lookup at
    its 256 threads a block."""
    out = (ctypes.c_int * 3)()
    cuda_build.check("bake_q_occupancy",
                     build_bake_q().bake_q_occupancy(out))
    return {"blocks_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2]}


def _bake_lookup_torch(vq, tab):
    """Plain K5c-q lookup: tab[vq] over the (N, Lm) u8 table."""
    return tab[vq.long()]


def _check_u8(name, x, like):
    if x.dtype != torch.uint8 or not x.is_contiguous() \
            or x.shape != like.shape or x.device != like.device:
        raise ValueError(f"bake_lookup: {name} must be a contiguous uint8 "
                         f"tensor of shape {tuple(like.shape)} on "
                         f"{like.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"bake_lookup: {name} must start on a 16-byte "
                         f"boundary (the kernel moves 16 bytes a load)")


def bake_lookup(vq, tab, out=None):
    """K5c-q wrapper: tab[vq] for the (N, Lm) u8 value table and a (256,)
    u8 table, into a new table, or into `out` (a contiguous u8 tensor of
    vq's shape, e.g. the alpha_q it replaces) when given.  CUDA tensors
    launch csrc/bake_q.cu, CPU tensors run the plain version; anything
    else raises."""
    if vq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bake_lookup: unsupported device {vq.device}")
    if tab.dtype != torch.uint8 or tab.shape != (256,) \
            or tab.device != vq.device:
        raise ValueError("bake_lookup: tab must be (256,) uint8 on vq's "
                         "device")
    _check_u8("vq", vq, vq)
    if out is not None:
        _check_u8("out", out, vq)
    if vq.device.type == "cpu":
        got = _bake_lookup_torch(vq, tab)
        return got if out is None else out.copy_(got)
    out = torch.empty_like(vq) if out is None else out
    if vq.numel():
        p = _BakeParams(vq=vq.data_ptr(), tab=tab.contiguous().data_ptr(),
                        out=out.data_ptr(), n=vq.numel())
        cuda_build.check("bake_lookup", build_bake_q().bake_lookup_launch(
            ctypes.byref(p),
            torch.cuda.current_stream(vq.device).cuda_stream))
        launches["bake_lookup"] += 1
    return out
