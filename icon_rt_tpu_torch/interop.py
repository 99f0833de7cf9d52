"""Carry state from the JAX package into this one, as numpy arrays.

Each function takes an object of the JAX package (or anything with the
same field names) whose leaves `np.asarray` accepts, and builds this
package's NamedTuple on `device`.  The tests hand both packages the same
scene and tables through these; nothing here imports jax — the caller
passes the objects in.
"""
from __future__ import annotations

import numpy as np
import torch

from .data.icfile import ICDataset
from .models.cells import Cells
from .models.locator import Locator
from .models.shells import RadialBands
from .models.transfunc import Transfunc
from .ops.fast import PackedCells
from .ops.render import LaunchParams


def to_tensor(a, device="cpu") -> torch.Tensor:
    """np.asarray(a) as a tensor on `device`; uint32 arrays (framebuffers)
    become int32 tensors holding the same bits."""
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _convert(obj, cls, device):
    return cls(**{f: to_tensor(getattr(obj, f), device) for f in cls._fields})


def dataset(ds) -> ICDataset:
    """A JAX-package ICDataset (numpy already) as this package's ICDataset."""
    return ICDataset(*(np.asarray(getattr(ds, f)) for f in
                       ("lat", "lon", "num_layers", "height", "value")))


def cells(c, device="cpu") -> Cells:
    return _convert(c, Cells, device)


def locator(loc, device="cpu") -> Locator:
    return _convert(loc, Locator, device)


def radial_bands(b, device="cpu") -> RadialBands:
    return _convert(b, RadialBands, device)


def transfunc(tf, device="cpu") -> Transfunc:
    return _convert(tf, Transfunc, device)


def packed_cells(p, device="cpu") -> PackedCells:
    return _convert(p, PackedCells, device)


def launch_params(lp, device="cpu") -> LaunchParams:
    return _convert(lp, LaunchParams, device)
