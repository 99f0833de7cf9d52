"""ctypes loader for the native host module (native/icon_host.cpp), shared
with the JAX package: the same source, the same g++ build, the same .so.

Builds on demand with g++ if the shared object is missing; every caller
has a pure-numpy fallback, so absence of a toolchain only costs speed.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libicon_host.so")


def _build() -> bool:
    src = os.path.join(_NATIVE_DIR, "icon_host.cpp")
    if not os.path.exists(src):
        return False
    try:
        # -ffp-contract=off: the edge-extrema mirror must be bit-equal to
        # the numpy oracle (FMA contraction shifts last-ulp results, and
        # an atan2 at exactly +-pi flips dateline bin assignment)
        # build to a private name and rename: concurrent first users
        # (test workers, the JAX package's loader) never load a partial file
        tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-ffp-contract=off", "-fPIC",
                        "-shared", "-fopenmp", "-o", tmp, src],
                       check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, _SO_PATH)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded library or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ih_locator_count.argtypes = [c_i64p, ctypes.c_int64, ctypes.c_int,
                                     c_i64p]
    lib.ih_locator_fill.argtypes = [c_i64p, ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int, c_i64p, c_i32p]
    lib.ih_rasterize_ranges.argtypes = [c_i64p, c_i64p, c_f32p, c_f32p,
                                        ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_int64,
                                        c_f32p, c_f32p]
    lib.ih_crop_mask.argtypes = [c_f32p, c_f32p, ctypes.c_int64,
                                 ctypes.c_float, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_float, c_u8p]
    c_f64p = ctypes.POINTER(ctypes.c_double)
    c_i8p = ctypes.POINTER(ctypes.c_int8)
    lib.ih_edge_extrema.argtypes = [c_f32p, c_f32p, ctypes.c_int64,
                                    c_f64p, c_f64p, c_f64p, c_i8p]
    lib.ih_version.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_locator_bins(rec, n_lat, n_lon):
    """Scatter (R, 5) i64 bin-rectangle records (cell, la0, la1, lb0, lb1)
    — from models.locator._range_records, sorted by cell id — into a
    grid-of-lists.  Returns (bins (n_bins, k) int32, k) or None if the
    native module is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rec = np.ascontiguousarray(rec, np.int64)
    n_rec = rec.shape[0]
    counts = np.zeros(n_lat * n_lon, np.int64)
    lib.ih_locator_count(_ptr(rec, ctypes.c_int64), n_rec, n_lon,
                         _ptr(counts, ctypes.c_int64))
    k = max(int(counts.max()) if n_rec else 0, 1)
    bins = np.full((n_lat * n_lon, k), -1, np.int32)
    counts[:] = 0
    lib.ih_locator_fill(_ptr(rec, ctypes.c_int64), n_rec, n_lon, k,
                        _ptr(counts, ctypes.c_int64),
                        _ptr(bins, ctypes.c_int32))
    return bins, k


def native_edge_extrema(lat, lon):
    """Great-circle edge-bulge extrema per cell (mirror of the numpy
    oracle models.locator._edge_extrema, same f64 formula order).
    Returns (lat_min (n,) f64, lat_max (n,) f64, lon_ext (n, 3) f64,
    pole (n,) i8) or None if the native module is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    lat = np.ascontiguousarray(lat, np.float32)
    lon = np.ascontiguousarray(lon, np.float32)
    n = lat.shape[0]
    lat_min = np.empty(n, np.float64)
    lat_max = np.empty(n, np.float64)
    lon_ext = np.empty((n, 3), np.float64)
    pole = np.empty(n, np.int8)
    lib.ih_edge_extrema(_ptr(lat, ctypes.c_float), _ptr(lon, ctypes.c_float),
                        n, _ptr(lat_min, ctypes.c_double),
                        _ptr(lat_max, ctypes.c_double),
                        _ptr(lon_ext, ctypes.c_double),
                        _ptr(pole, ctypes.c_int8))
    return lat_min, lat_max, lon_ext, pole


def native_rasterize(lo_idx, up_idx, val_lo, val_hi, dims, vr_lo, vr_hi):
    """In-place scatter min/max; returns True if the native path ran."""
    lib = get_lib()
    if lib is None:
        return False
    lo_idx = np.ascontiguousarray(lo_idx, np.int64)
    up_idx = np.ascontiguousarray(up_idx, np.int64)
    val_lo = np.ascontiguousarray(val_lo, np.float32)
    val_hi = np.ascontiguousarray(val_hi, np.float32)
    lib.ih_rasterize_ranges(_ptr(lo_idx, ctypes.c_int64),
                            _ptr(up_idx, ctypes.c_int64),
                            _ptr(val_lo, ctypes.c_float),
                            _ptr(val_hi, ctypes.c_float),
                            lo_idx.shape[0], int(dims[0]), int(dims[1]),
                            int(dims[2]),
                            _ptr(vr_lo, ctypes.c_float),
                            _ptr(vr_hi, ctypes.c_float))
    return True


def native_crop_mask(lat, lon, lat_range, lon_range):
    """(n,) bool keep-mask or None."""
    lib = get_lib()
    if lib is None:
        return None
    lat = np.ascontiguousarray(lat, np.float32)
    lon = np.ascontiguousarray(lon, np.float32)
    keep = np.zeros(lat.shape[0], np.uint8)
    lib.ih_crop_mask(_ptr(lat, ctypes.c_float), _ptr(lon, ctypes.c_float),
                     lat.shape[0], lat_range[0], lat_range[1],
                     lon_range[0], lon_range[1], _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool)
