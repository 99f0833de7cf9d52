"""Binary .ic dataset IO (structure-of-arrays), bit-compatible with the
reference engine's on-disk format.

One record per ICON column (triangular prism stack):
  lat[3] f32, lon[3] f32 (radians, CCW corners), numLayers i32,
  height[32] f32 (radii, [0:numLayers] right-closed),
  value[32] f32  (per-layer scalar, [0:numLayers) right-open)
= 284 bytes (ref: icon_rt/ICONGrid.h:57-76, tools/convert_icon.cpp:383-387).

The reference reads the whole file as an array of structs
(ref: icon_rt/hostCode.cu:717-734) and crops by lat/lon ranges in degrees
(ref: icon_rt/hostCode.cu:736-757).  We load into SoA numpy arrays, the
layout the renderer's builders want.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MAX_LAYERS = 32

IC_DTYPE = np.dtype([
    ("lat", "<f4", (3,)),
    ("lon", "<f4", (3,)),
    ("numLayers", "<i4"),
    ("height", "<f4", (MAX_LAYERS,)),
    ("value", "<f4", (MAX_LAYERS,)),
])
assert IC_DTYPE.itemsize == 284


@dataclasses.dataclass
class ICDataset:
    """Host-side SoA view of an .ic file."""
    lat: np.ndarray          # (N, 3) f32, radians
    lon: np.ndarray          # (N, 3) f32, radians
    num_layers: np.ndarray   # (N,)   i32
    height: np.ndarray       # (N, 32) f32
    value: np.ndarray        # (N, 32) f32

    @property
    def num_cells(self) -> int:
        return self.lat.shape[0]

    def crop(self, lat_range=None, lon_range=None) -> "ICDataset":
        """Drop cells with any corner outside the given ranges (degrees).

        Mirrors the reference's remove_if predicate
        (ref: icon_rt/hostCode.cu:741-757).
        """
        keep = np.ones(self.num_cells, bool)
        if lat_range is not None:
            lo, hi = np.deg2rad(lat_range[0]), np.deg2rad(lat_range[1])
            keep &= np.all(self.lat >= lo, axis=1) & np.all(self.lat <= hi, axis=1)
        if lon_range is not None:
            lo, hi = np.deg2rad(lon_range[0]), np.deg2rad(lon_range[1])
            keep &= np.all(self.lon >= lo, axis=1) & np.all(self.lon <= hi, axis=1)
        return ICDataset(self.lat[keep], self.lon[keep], self.num_layers[keep],
                         self.height[keep], self.value[keep])

    def head(self, n: int) -> "ICDataset":
        """Keep only the first n cells (--num-cells in the reference CLI)."""
        return ICDataset(self.lat[:n], self.lon[:n], self.num_layers[:n],
                         self.height[:n], self.value[:n])


def from_records(rec: np.ndarray) -> ICDataset:
    return ICDataset(
        lat=np.ascontiguousarray(rec["lat"], np.float32),
        lon=np.ascontiguousarray(rec["lon"], np.float32),
        num_layers=np.ascontiguousarray(rec["numLayers"], np.int32),
        height=np.ascontiguousarray(rec["height"], np.float32),
        value=np.ascontiguousarray(rec["value"], np.float32),
    )


def to_records(ds: ICDataset) -> np.ndarray:
    rec = np.zeros(ds.num_cells, IC_DTYPE)
    rec["lat"] = ds.lat
    rec["lon"] = ds.lon
    rec["numLayers"] = ds.num_layers
    rec["height"] = ds.height
    rec["value"] = ds.value
    return rec


def read_ic(path: str, max_num_cells: int | None = None) -> ICDataset:
    if max_num_cells is not None and max_num_cells >= 0:
        rec = np.fromfile(path, IC_DTYPE, count=max_num_cells)
    else:
        rec = np.fromfile(path, IC_DTYPE)
    return from_records(rec)


def write_ic(path: str, ds: ICDataset) -> None:
    to_records(ds).tofile(path)
