"""Quantized fast raygen — the tracker of the quantized storage tier.

The same Woodcock tracking machine as ops/fast.py (radial bands, two-slot
column cache, in-lane sample restarts), on models/qcells.QuantizedCells:
a cache miss locates through the fine map first (models/finemap.py) and
falls back to the full coarse query, the u8/u16 tables are dequantized at
the point of use, and the accepted sample's dequantized value is
classified through the LIVE transfer function at shade time, so a TF edit
re-bakes only alpha_q (models/qcells.bake_alpha_q).

Kernel of this module:

  K2 `track_q` (CUDA C++, csrc/track_q.cu + csrc/track_common.cuh) — one
     thread per lane, as K1.  Plain version: `_render_frame_fast_q_torch`,
     the lock-step machine of ops/fast.py `_track_torch` on `_QTier`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..models.finemap import FineMap, K_CAND, slots_to_cells
from ..models.locator import Locator
from ..models.qcells import QuantizedCells
from ..models.shells import RadialBands
from ..models.transfunc import Transfunc, post_classify
from ..utils import cuda_build
from .fast import (F32, RawSample, _check, _first_inside, _grid_bin,
                   _locate_torch, _TrackCommon, _track_torch, check_raw,
                   check_rows, frame_lanes, frame_on, host_values,
                   track_common)

#: K2 kernel launches (the wrapper counts only CUDA launches)
launches = 0


# ===========================================================================
# K2 plain version
# ===========================================================================

class _QTier:
    """The quantized storage tier of the plain tracker (ops/fast.py
    `_track_torch`) and march (ops/march.py `_march_torch`): cached test
    rows are the 12-float storage rows laid out as the f32 tier's 16-float
    rows (w = 0); heights, alpha and values are dequantized from the cell
    id, in the order of icon_rt_tpu/ops/fastq.py `_test_and_fill`."""

    #: the march's candidate rows are the 12-float storage rows (w = 0)
    w_cols = False
    #: width of a cached test row (the storage row laid out as 16 floats)
    test_w = 16
    #: the layers are looked up by the radius
    coord = staticmethod(lambda rows, px, py, pz, r: r)

    def __init__(self, q: QuantizedCells, loc: Locator, tf: Transfunc,
                 fm: FineMap | None):
        self.q, self.loc, self.tf, self.fm = q, loc, tf, fm
        self.ml = q.lm
        self.dims = tuple(int(d) for d in loc.dims.tolist())
        one = torch.ones((), dtype=F32, device=q.test12.device)
        self.inv65535 = one * np.float32(1.0 / 65535.0)
        # divided by a tensor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which rounds differently
        self.a_scale = q.alpha_max / (one * 255.0)
        self.v_scale = (q.value_hi - q.value_lo) / (one * 255.0)

    @functools.cached_property
    def test16(self):
        t = self.q.test12
        z = torch.zeros_like(t[:, :1])
        return torch.cat([t[:, 0:3], z, t[:, 3:6], z, t[:, 6:9], z,
                          t[:, 9:12], z], dim=1)

    def test_rows(self, cid):
        return self.test16[cid]

    def locate(self, px, py, pz, r, return_rows: bool = False):
        """Fine map first (the first of the fine bin's 4 candidates whose
        column contains the point), then the full coarse query for the
        misses: the two-stage locate, per lane.  Returns (cid, hit); with
        return_rows also the coarse bin's (M, K, 12) storage rows, their
        validity and the bin (bl, bo), filled for the lanes that ran the
        full query (the others are hits and need no gap skip)."""
        M, dev = px.shape[0], px.device
        cid = torch.zeros(M, dtype=torch.int64, device=dev)
        hit = torch.zeros(M, dtype=torch.bool, device=dev)
        if self.fm is not None:
            f_lat, f_lon = (int(d) for d in self.fm.dims.tolist())
            lat = torch.asin(torch.clamp(pz / r, -1.0, 1.0))
            lon = torch.atan2(py, px)
            fbid = _grid_bin(lat, self.fm.lat_lo, self.fm.lat_hi, f_lat) \
                * f_lon + _grid_bin(lon, self.fm.lon_lo, self.fm.lon_hi,
                                    f_lon)
            fbid = fbid.long()
            cand = slots_to_cells(self.fm, self.loc, fbid, self.fm.slots[fbid])
            cid, hit = _first_inside(self.test_rows, cand, px, py, pz, r)
        miss = torch.nonzero(~hit).squeeze(1)
        if return_rows:
            k_cap = self.loc.bins.shape[1]
            rows = torch.zeros((M, k_cap, 12), dtype=F32, device=dev)
            valid = torch.zeros((M, k_cap), dtype=torch.bool, device=dev)
            bl = torch.zeros(M, dtype=torch.int32, device=dev)
            bo = torch.zeros_like(bl)
        if miss.numel():
            out = _locate_torch(self.loc, self.dims, self.test_rows,
                                px[miss], py[miss], pz[miss], r[miss],
                                return_rows)
            cid[miss] = out[0]
            hit[miss] = out[1]
            if return_rows:
                rows[miss] = out[2][..., _STORAGE_COLS]
                valid[miss] = out[3]
                bl[miss] = out[4]
                bo[miss] = out[5]
        return (cid, hit, rows, valid, bl, bo) if return_rows else (cid, hit)

    def _heights(self, cid):
        """(M, Lm) dequantized ceilings of columns cid, +inf past their
        num_layers."""
        q = self.q
        t = q.test12[cid]
        h_bot, h_top = t[:, 9], t[:, 10]
        nl = t[:, 11].to(torch.int32)
        hf = q.h_frac[torch.clamp(cid, max=q.h_frac.shape[0] - 1)]
        heights = h_bot[:, None] + hf * ((h_top - h_bot)[:, None]
                                         * self.inv65535)
        k1 = torch.arange(1, q.lm + 1, device=cid.device)
        return torch.where(k1[None, :] <= nl[:, None], heights,
                           float("inf"))

    def _layer(self, cid, r):
        """(layer of r, its clamped index) in columns cid: the layer is
        #(h < r) over the Lm ceilings; Lm means above the top layer."""
        layer = (r[:, None] > self._heights(cid)).sum(1)
        return layer, torch.clamp(layer, max=self.q.lm - 1)[:, None]

    def _alphas(self, cid):
        return self.q.alpha_q[cid].to(F32) * self.a_scale

    def _values(self, cid):
        return self.q.value_lo + self.q.value_q[cid].to(F32) * self.v_scale

    def alpha(self, cid, r):
        layer, idx = self._layer(cid, r)
        aa = self._alphas(cid).gather(1, idx)[:, 0]
        return torch.where(layer < self.q.lm, aa, 0.0)

    def shade(self, cid, r):
        layer, idx = self._layer(cid, r)
        vv = self._values(cid).gather(1, idx)[:, 0]
        v = torch.where(layer < self.q.lm, vv, 0.0)
        rgba = post_classify(self.tf, v)
        return [rgba[:, 0], rgba[:, 1], rgba[:, 2]]

    def march_prof(self, cid):
        """(M, 3 Lm) dequantized ceilings | alpha | values of columns cid
        (JAX's cached h|A|V rows)."""
        return torch.cat([self._heights(cid), self._alphas(cid),
                          self._values(cid)], dim=1)

    def march_colors(self, cid, prof):
        """Per-layer (R, G, B), each (M, Lm): a layer's value re-quantized
        to its u8 code (icon_rt_tpu/ops/march.py:478-482, in that
        expression order) and looked up in `code_table`."""
        lm, q = self.q.lm, self.q
        code = torch.clamp(torch.round((prof[:, 2 * lm:] - q.value_lo)
                                       * self.inv_span), 0, 255).long()
        rgba = self.code_table[code]                    # (M, Lm, 4)
        return rgba[..., 0], rgba[..., 1], rgba[..., 2]

    @functools.cached_property
    def inv_span(self):
        """255 / max(value_hi - value_lo, 1e-30), divided as a tensor."""
        one = torch.ones((), dtype=F32, device=self.q.value_lo.device)
        return (one * 255.0) / torch.clamp(self.q.value_hi - self.q.value_lo,
                                           min=1e-30)

    @functools.cached_property
    def code_table(self):
        """(256, 4) RGBA of every dequantized u8 value code through the live
        TF (icon_rt_tpu/ops/march.py `_vq_rgb_table`): 256 postClassify
        evaluations per march call, so TF edits need no extra bake."""
        codes = torch.arange(256, dtype=F32, device=self.q.value_lo.device)
        return post_classify(self.tf, self.q.value_lo + codes * self.v_scale)


#: the 12 storage columns of a (..., 16) expanded test row (w dropped)
_STORAGE_COLS = [0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14]


def _render_frame_fast_q_torch(q: QuantizedCells, loc: Locator,
                               bands: RadialBands, tf: Transfunc, lp, pix,
                               accum, fb, width: int, height: int,
                               samples: int, preserve_cache: bool,
                               fm: FineMap | None, cost=None,
                               rng_salt: int = 0, out=None):
    """Plain-PyTorch K2 over the lanes of `pix`: the tracking machine
    `_track_torch` on the quantized tier; updates accum and fb in place (or,
    in raw mode, fills `out`)."""
    _track_torch(_QTier(q, loc, tf, fm), bands, lp, pix, accum, fb, width,
                 height, samples, preserve_cache, cost, rng_salt, out)


# ===========================================================================
# K2 kernel: build, bind, launch
# ===========================================================================

class _TrackQParams(ctypes.Structure):
    """Mirror of `TrackQParams` in csrc/tier_q.cuh (same field order)."""
    _fields_ = [
        ("c", _TrackCommon),
        ("test12", ctypes.c_void_p), ("hfrac", ctypes.c_void_p),
        ("vq", ctypes.c_void_p), ("aq", ctypes.c_void_p),
        ("bins", ctypes.c_void_p), ("fslots", ctypes.c_void_p),
        ("lut", ctypes.c_void_p),
        ("value_lo", ctypes.c_float), ("value_hi", ctypes.c_float),
        ("alpha_max", ctypes.c_float), ("tf_lo", ctypes.c_float),
        ("tf_hi", ctypes.c_float),
        ("lat_lo", ctypes.c_float), ("lat_hi", ctypes.c_float),
        ("lon_lo", ctypes.c_float), ("lon_hi", ctypes.c_float),
        ("f_lat_lo", ctypes.c_float), ("f_lat_hi", ctypes.c_float),
        ("f_lon_lo", ctypes.c_float), ("f_lon_hi", ctypes.c_float),
        ("hf_stride", ctypes.c_int), ("lm", ctypes.c_int),
        ("lut_size", ctypes.c_int),
        ("n_lat", ctypes.c_int), ("n_lon", ctypes.c_int),
        ("k_cap", ctypes.c_int),
        ("f_lat", ctypes.c_int), ("f_lon", ctypes.c_int),
        ("factor", ctypes.c_int), ("use_fine", ctypes.c_int),
    ]


def build_track_q():
    """Compile csrc/track_q.cu for sm_90a (utils/cuda_build.py) and bind
    its C entry point; returns the ctypes library."""
    lib = cuda_build.build("track_q")
    lib.track_q_launch.argtypes = [ctypes.POINTER(_TrackQParams),
                                   ctypes.c_void_p]
    lib.track_q_launch.restype = ctypes.c_int
    return lib


def check_q_tables(fn, q: QuantizedCells, loc: Locator, tf: Transfunc,
                   finemap: FineMap | None, dev):
    """Raise ValueError unless the quantized tier's tables are what K2 and
    K3 take."""
    n, lm = q.num_cells, q.lm
    n_lat, n_lon = host_values(loc.dims)
    ck = lambda name, x, dt, shape: _check(name, x, dt, shape, dev, fn=fn)
    ck("q.test12", q.test12, F32, (n, 12))
    check_rows(fn, "q.test12", q.test12, 16)
    ck("q.h_frac", q.h_frac, F32, (None, lm))
    if q.h_frac.shape[0] not in (1, n):
        raise ValueError(f"{fn}: q.h_frac must have 1 or N rows")
    ck("q.value_q", q.value_q, torch.uint8, (n, lm))
    ck("q.alpha_q", q.alpha_q, torch.uint8, (n, lm))
    for name in ("value_lo", "value_hi", "alpha_max"):
        ck(f"q.{name}", getattr(q, name), F32, ())
    ck("loc.bins", loc.bins, torch.int32, (n_lat * n_lon, loc.bins.shape[1]))
    ck("tf.values", tf.values, F32, (tf.size, 4))
    ck("tf.value_range", tf.value_range, F32, (2,))
    if finemap is None:
        return
    f_lat, f_lon = host_values(finemap.dims)
    ck("finemap.slots", finemap.slots, torch.uint8, (f_lat * f_lon, K_CAND))
    check_rows(fn, "finemap.slots", finemap.slots, 4)
    factor = f_lat // n_lat
    if factor < 1 or f_lat != factor * n_lat or f_lon != factor * n_lon:
        raise ValueError(f"{fn}: the fine map must refine the locator's "
                         "grid by an integer factor")


def track_q_params(q: QuantizedCells, loc: Locator, tf: Transfunc,
                   finemap: FineMap | None,
                   c: _TrackCommon) -> _TrackQParams:
    """The quantized tier's launch arguments of K2 and K3
    (csrc/tier_q.cuh): the scalars from their host copies (`host_values`,
    read again only after the tensors change)."""
    n_lat, n_lon = host_values(loc.dims)
    f_lat = f_lon = factor = 0
    if finemap is not None:
        f_lat, f_lon = host_values(finemap.dims)
        factor = f_lat // n_lat
    fm = finemap if finemap is not None else loc
    host = [host_values(x) for x in (
        q.value_lo, q.value_hi, q.alpha_max)] + host_values(
        tf.value_range) + [host_values(x) for x in (
            loc.lat_lo, loc.lat_hi, loc.lon_lo, loc.lon_hi, fm.lat_lo,
            fm.lat_hi, fm.lon_lo, fm.lon_hi)]
    return _TrackQParams(
        c=c, test12=q.test12.data_ptr(), hfrac=q.h_frac.data_ptr(),
        vq=q.value_q.data_ptr(), aq=q.alpha_q.data_ptr(),
        bins=loc.bins.data_ptr(),
        fslots=finemap.slots.data_ptr() if finemap is not None else None,
        lut=tf.values.data_ptr(), value_lo=host[0], value_hi=host[1],
        alpha_max=host[2], tf_lo=host[3], tf_hi=host[4], lat_lo=host[5],
        lat_hi=host[6], lon_lo=host[7], lon_hi=host[8], f_lat_lo=host[9],
        f_lat_hi=host[10], f_lon_lo=host[11], f_lon_hi=host[12],
        hf_stride=0 if q.h_frac.shape[0] == 1 else q.lm, lm=q.lm,
        lut_size=tf.size, n_lat=n_lat, n_lon=n_lon,
        k_cap=loc.bins.shape[1], f_lat=f_lat, f_lon=f_lon, factor=factor,
        use_fine=int(finemap is not None))


def track_q(q: QuantizedCells, loc: Locator, bands: RadialBands,
            tf: Transfunc, lp, pix, accum, fb, *, width: int, height: int,
            samples: int = 1, preserve_cache: bool = True,
            finemap: FineMap | None = None, cost=None, rng_salt: int = 0,
            out: RawSample | None = None):
    """K2 wrapper: trace `samples` progressive samples for the lanes of
    `pix` ((L,) int32 pixel ids) on the quantized tier and update accum
    (L, 4) f32 and fb (L,) int32 IN PLACE; with `cost` ((W*H,) int32) also
    store each lane's tracking steps at its pixel.  With `finemap` a cache
    miss locates through the fine map first.  Raw mode (`out`, a
    RawSample; accum and fb None, one sample) stores the sample, with its
    collision's t, for a composite across ranks instead (ops/composite.py);
    rng_salt != 0 re-keys the tracking streams (the scene shard's slabs).
    CUDA tensors launch csrc/track_q.cu; CPU tensors run
    `_render_frame_fast_q_torch`; anything else raises.  A launch reads
    nothing back from the card: the kernel reads lp's scalars from their
    tensors (ops/fast.py `track_frame`), the tables', the locator's, the
    fine map's and the TF's come from `host_values`."""
    global launches
    dev = pix.device
    nb = bands.max_opacities.shape[0]
    L = pix.shape[0]
    check_q_tables("track_q", q, loc, tf, finemap, dev)
    ck = lambda name, x, dt, shape: _check(name, x, dt, shape, dev,
                                           fn="track_q")
    ck("bands.edges", bands.edges, F32, (nb + 1,))
    ck("bands.max_opacities", bands.max_opacities, F32, (nb,))
    ck("pix", pix, torch.int32, (L,))
    check_raw("track_q", out, accum, fb, L, samples, dev)
    if out is None:
        ck("accum", accum, F32, (L, 4))
        ck("fb", fb, torch.int32, (L,))
    if cost is not None:
        ck("cost", cost, torch.int32, (width * height,))
    if samples < 1:
        raise ValueError("track_q: samples must be >= 1")
    if dev.type == "cpu":
        _render_frame_fast_q_torch(q, loc, bands, tf, lp, pix, accum, fb,
                                   width, height, samples, preserve_cache,
                                   finemap, cost, rng_salt, out)
        return
    if dev.type != "cuda":
        raise ValueError(f"track_q: unsupported device {dev}")
    lib = build_track_q()
    lp = frame_on(lp, dev)
    p = track_q_params(q, loc, tf, finemap, track_common(
        bands, lp, pix, accum, fb, width=width, height=height,
        samples=samples, preserve_cache=preserve_cache, cost=cost,
        rng_salt=rng_salt, out=out, fn="track_q"))
    cuda_build.check("track_q", lib.track_q_launch(
        ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream))
    launches += 1


# ===========================================================================
# Frame driver
# ===========================================================================

def render_frame_fast_q(q: QuantizedCells, loc: Locator, bands: RadialBands,
                        tf: Transfunc, lp, accum, fb, *, width: int,
                        height: int, pixel_perm=None,
                        n_active: int | None = None, samples: int = 1,
                        preserve_cache: bool = True,
                        finemap: FineMap | None = None,
                        return_cost: bool = False):
    """Full-frame progressive step on the quantized tier — the peer of
    ops/fast.render_frame_fast (same pixel_perm / n_active / samples /
    preserve_cache / return_cost contract); `finemap` turns the two-stage
    locate on.  accum (P, 4) f32 and fb (P,) int32 are updated IN PLACE and
    returned, with the (W*H,) int32 cost when return_cost is set."""
    pix, n_proc = frame_lanes(width, height, pixel_perm, n_active,
                              accum.device)
    cost = torch.zeros(width * height, dtype=torch.int32,
                       device=accum.device) if return_cost else None
    track_q(q, loc, bands, tf, lp, pix, accum[:n_proc], fb[:n_proc],
            width=width, height=height, samples=samples,
            preserve_cache=preserve_cache, finemap=finemap, cost=cost)
    return (accum, fb, cost) if return_cost else (accum, fb)
