"""On-disk cache of the fine map (models/finemap.py), keyed by scene.

A viewer session or a batch of renders of one dataset builds its fine map
once: the map's slots are relative to the coarse locator rows, which are a
function of the scene alone, so (scene key, factor) names a map.  The cache holds this package's unpacked (n_fine, 4) u8 slots, so it is
not shared with the JAX package's cache of packed maps.

`CACHE_DIR` is a module attribute: point it elsewhere (chip_smoke.py uses an
empty directory, so the build really runs) before the first call.
"""
from __future__ import annotations

import os

import numpy as np
import torch

#: npz cache directory (inside the package's gitignored build directory)
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "scenes")


def finemap_cache_path(cache_key: str, factor: int) -> str:
    return os.path.join(CACHE_DIR, f"fmap_{cache_key}_f{factor}.npz")


def build_finemap_cached(loc, test12, factor: int,
                         cache_key: str | None = None):
    """models/finemap.build_finemap through the npz cache: a hit loads the
    map onto the locator's device, a miss builds it (K7-fm on a CUDA
    locator) and stores it.  Without a cache_key it always builds."""
    from ..models.finemap import FineMap, build_finemap

    dev = loc.bins.device
    path = finemap_cache_path(cache_key, factor) if cache_key else None
    if path and os.path.exists(path):
        z = np.load(path)
        f32 = lambda k: torch.tensor(float(z[k]), dtype=torch.float32,
                                     device=dev)
        return FineMap(slots=torch.from_numpy(z["slots"]).to(dev),
                       lat_lo=f32("lat_lo"), lat_hi=f32("lat_hi"),
                       lon_lo=f32("lon_lo"), lon_hi=f32("lon_hi"),
                       dims=torch.from_numpy(z["dims"]).to(dev))
    fm = build_finemap(loc, test12, factor=factor)
    if path:
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, slots=fm.slots.cpu().numpy(),
                 dims=fm.dims.cpu().numpy(),
                 **{k: float(getattr(fm, k))
                    for k in ("lat_lo", "lat_hi", "lon_lo", "lon_hi")})
        os.replace(tmp, path)
    return fm
