"""PyTorch port, the fine map (models/finemap.py, K7-fm plain version):
the slots against JAX build_finemap on the same locator and test rows at
factors 1-3, the sampled-bin plain version against the whole image, the
invariants of tests/test_finemap.py, and the npz cache."""
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models.finemap import build_finemap as jbuild_finemap
from icon_rt_tpu.models.finemap import unpack_candidates as junpack
from icon_rt_tpu.models.locator import build_locator_csr as jcsr
from icon_rt_tpu.models.locator import densify_csr as jdensify
from icon_rt_tpu.models.qcells import quantize_cells as jquantize
from icon_rt_tpu.models.qcells import quantize_dataset_values as jqvalues
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.data import bigscene
from icon_rt_tpu_torch.models import finemap
from icon_rt_tpu_torch.models.finemap import (K_CAND, build_finemap,
                                              unpack_candidates)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[(2, 5), (3, 6)])
def scene(request):
    ds_q, lo, hi = jqvalues(jsyn.icosphere(*request.param))
    jq = jquantize(ds_q, value_range=(lo, hi))
    csr, k_cap = jcsr(ds_q)
    jloc = jdensify(csr, k_cap)
    jfm = jbuild_finemap(jloc, jq.test12, k_cap, factor=2)
    n = ds_q.num_cells
    tq = interop.quantized_cells(jq, n=n)
    tloc = interop.locator_packed(jloc, k_cap)
    return dict(jloc=jloc, k_cap=k_cap, jfm=jfm, jq=jq, tq=tq, tloc=tloc,
                fm=build_finemap(tloc, tq.test12, factor=2), n=n)


def test_torch_finemap_matches_jax(scene):
    """_build_finemap_torch (through build_finemap on CPU tensors): the u8
    slots byte-equal to JAX's, and the decoded candidates equal through
    unpack_candidates; the same window and dims."""
    fm, jfm = scene["fm"], scene["jfm"]
    ifm = interop.finemap(jfm)
    np.testing.assert_array_equal(fm.slots.numpy(), ifm.slots.numpy())
    np.testing.assert_array_equal(
        unpack_candidates(fm, scene["tloc"]),
        junpack(jfm, scene["jloc"], scene["k_cap"]))
    for f in ("lat_lo", "lat_hi", "lon_lo", "lon_hi", "dims"):
        np.testing.assert_array_equal(getattr(fm, f).numpy(),
                                      getattr(ifm, f).numpy())


@pytest.mark.parametrize("factor", [1, 3])
def test_torch_finemap_factor_matches_jax(scene, factor):
    """_build_finemap_torch at factors 1 and 3 (the fixture holds 2): the
    u8 slots byte-equal to JAX's build_finemap at the same factor, and the
    same dims."""
    jfm = jbuild_finemap(scene["jloc"], scene["jq"].test12, scene["k_cap"],
                         factor=factor)
    fm = build_finemap(scene["tloc"], scene["tq"].test12, factor=factor)
    ifm = interop.finemap(jfm)
    np.testing.assert_array_equal(fm.slots.numpy(), ifm.slots.numpy())
    np.testing.assert_array_equal(fm.dims.numpy(), ifm.dims.numpy())


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_torch_finemap_bins_equal_whole_image(scene, factor):
    """_finemap_bins_torch (the slots of chosen fine bins, the card's
    check at R2B9) on every fine bin, in a shuffled order, equals the
    whole-image _build_finemap_torch row for row: the first and last
    fine rows (latitude clamps) and the seam columns (longitude wraps)
    included."""
    loc, test12 = scene["tloc"], scene["tq"].test12
    want = finemap._build_finemap_torch(loc, test12, factor)
    fb = torch.from_numpy(np.random.default_rng(factor).permutation(
        want.shape[0]))
    got = finemap._finemap_bins_torch(loc, test12, factor, fb)
    assert got.dtype == torch.uint8
    assert torch.equal(got, want[fb])


def _planes(scene):
    return scene["tq"].test12.numpy()[:, :9].astype(np.float64) \
        .reshape(-1, 3, 3)


def _inside(planes, p):
    return (np.einsum("nwk,k->nw", planes, p) <= 0.0).all(axis=1)


def _window(scene):
    loc = scene["tloc"]
    return (float(loc.lat_lo), float(loc.lat_hi), float(loc.lon_lo),
            float(loc.lon_hi))


def test_torch_finemap_slots_cover_subcenters(scene):
    """The container of each of a fine bin's 4 sub-quadrant centers is
    among the bin's candidates (test_finemap.py:53)."""
    fm = scene["fm"]
    f_lat, f_lon = (int(v) for v in fm.dims)
    cand = unpack_candidates(fm, scene["tloc"])
    planes = _planes(scene)
    lat_lo, lat_hi, lon_lo, lon_hi = _window(scene)
    s_lat, s_lon = 2 * f_lat, 2 * f_lon
    rng = np.random.default_rng(7)
    for b in rng.choice(f_lat * f_lon, size=256, replace=False):
        fl, fo = divmod(int(b), f_lon)
        row = set(int(c) for c in cand[b] if c >= 0)
        for dl in (0, 1):
            for do in (0, 1):
                lat = lat_lo + (2 * fl + dl + 0.5) * (lat_hi - lat_lo) / s_lat
                lon = lon_lo + (2 * fo + do + 0.5) * (lon_hi - lon_lo) / s_lon
                p = np.array([np.cos(lat) * np.cos(lon),
                              np.cos(lat) * np.sin(lon), np.sin(lat)])
                winners = np.nonzero(_inside(planes, p))[0]
                if winners.size:
                    assert row & set(winners.tolist()), (b, winners, row)


def test_torch_finemap_slots_distinct(scene):
    """Filled slots of a bin name distinct cells; sub-center 0's container
    is nearly always found (test_finemap.py:84)."""
    cand = unpack_candidates(scene["fm"], scene["tloc"])
    filled = cand >= 0
    assert filled[:, 0].mean() > 0.99
    for a in range(K_CAND):
        for b in range(a + 1, K_CAND):
            both = filled[:, a] & filled[:, b]
            assert (cand[both, a] != cand[both, b]).all()


def test_torch_finemap_primary_hit_rate(scene):
    """Random unit-sphere points: the 4 candidates resolve >= 0.85 of them
    laterally (test_finemap.py:96; the design measured ~0.95)."""
    fm = scene["fm"]
    f_lat, f_lon = (int(v) for v in fm.dims)
    cand = unpack_candidates(fm, scene["tloc"])
    planes = _planes(scene)
    lat_lo, lat_hi, lon_lo, lon_hi = _window(scene)
    rng = np.random.default_rng(3)
    m = 4000
    lat = np.arcsin(rng.uniform(-1, 1, m))
    lon = rng.uniform(-np.pi, np.pi, m)
    pts = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                    np.sin(lat)], axis=1)
    fl = np.clip(((lat - lat_lo) / (lat_hi - lat_lo) * f_lat).astype(int),
                 0, f_lat - 1)
    fo = np.clip(((lon - lon_lo) / (lon_hi - lon_lo) * f_lon).astype(int),
                 0, f_lon - 1)
    hits = 0
    for i in range(m):
        c = cand[fl[i] * f_lon + fo[i]]
        c = c[c >= 0]
        hits += bool(c.size) and bool(_inside(planes[c], pts[i]).any())
    assert hits / m >= 0.85, hits / m


def test_torch_finemap_cache_roundtrip(scene, tmp_path, monkeypatch):
    """build_finemap_cached: the npz round trip restores the map exactly,
    and a cache hit never calls the builder."""
    monkeypatch.setattr(bigscene, "CACHE_DIR", str(tmp_path))
    tloc, test12 = scene["tloc"], scene["tq"].test12
    fm1 = bigscene.build_finemap_cached(tloc, test12, factor=2,
                                        cache_key="t_q")
    assert (tmp_path / "fmap_t_q_f2.npz").exists()

    def boom(*a, **k):
        raise AssertionError("cache miss: builder called on second load")

    monkeypatch.setattr(finemap, "build_finemap", boom)
    fm2 = bigscene.build_finemap_cached(tloc, test12, factor=2,
                                        cache_key="t_q")
    for f in finemap.FineMap._fields:
        a, b, c = (getattr(x, f) for x in (scene["fm"], fm1, fm2))
        assert a.dtype == c.dtype
        assert torch.equal(a, b) and torch.equal(a, c)


def test_torch_finemap_rejects_bad_inputs(scene):
    tloc, test12 = scene["tloc"], scene["tq"].test12
    with pytest.raises(ValueError):
        build_finemap(tloc, test12[:, :9].contiguous())
    with pytest.raises(ValueError):
        build_finemap(tloc._replace(bins=tloc.bins.long()), test12)
    with pytest.raises(ValueError):
        build_finemap(tloc._replace(bins=tloc.bins[:-1]), test12)
