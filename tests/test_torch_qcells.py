"""PyTorch port, the quantized storage tier: quantize_dataset_values,
quantize_cells, the CSR-binned locator and the alpha bake (K5c-q, plain
versions) against the JAX package on the same datasets."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models import qcells as jq
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.locator import build_locator_csr as jcsr
from icon_rt_tpu.models.locator import densify_csr as jdensify
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.models.transfunc import post_classify as jpost_classify
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.models import qcells
from icon_rt_tpu_torch.models.locator import build_locator_csr, densify_csr

torch.set_num_threads(1)


def _ulp(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _perturbed(ds, seed=4):
    """A copy whose interior layer heights move by up to 40% of a layer's
    thickness, per cell: the layer spacing differs between columns, so
    quantize_cells keeps one h_frac row per cell."""
    rng = np.random.default_rng(seed)
    h = ds.height.copy()
    thick = h[:, 1:2] - h[:, 0:1]
    nl = int(ds.num_layers.max())
    h[:, 1:nl] += (rng.uniform(-0.4, 0.4, (len(h), nl - 1)) * thick) \
        .astype(np.float32)
    return dataclasses.replace(ds, height=h.astype(np.float32))


@pytest.fixture(scope="module", params=["uniform", "per_cell"])
def scene(request):
    ds = jsyn.icosphere(3, 6)
    if request.param == "per_cell":
        ds = _perturbed(ds)
    ds_q, lo, hi = jq.quantize_dataset_values(ds)
    tf = jmake_tf(value_range=tuple(jstats(ds_q).data_range), size=32)
    return ds, ds_q, lo, hi, tf, request.param


def test_torch_quantize_matches_jax(scene):
    """value_q and the h_frac grid exact, test12 <= 1 ULP, the dequant
    range equal; a shared h_frac row for uniform layer spacing and one row
    per cell (the (N, Lm) branch) for perturbed heights."""
    ds, ds_q, lo, hi, _, kind = scene
    t_ds, t_lo, t_hi = qcells.quantize_dataset_values(interop.dataset(ds))
    assert (t_lo, t_hi) == (lo, hi)
    np.testing.assert_array_equal(t_ds.value, ds_q.value)
    jqc = jq.quantize_cells(ds_q, value_range=(lo, hi))
    tq = qcells.quantize_cells(t_ds, value_range=(t_lo, t_hi))
    iq = interop.quantized_cells(jqc, n=ds.num_cells)
    assert tq.lm == iq.lm == 8
    assert tq.h_frac.shape == iq.h_frac.shape
    assert tq.h_frac.shape[0] == (1 if kind == "uniform" else ds.num_cells)
    np.testing.assert_array_equal(tq.h_frac.numpy(), iq.h_frac.numpy())
    np.testing.assert_array_equal(tq.value_q.numpy(), iq.value_q.numpy())
    assert _ulp(tq.test12.numpy(), iq.test12.numpy()) <= 1
    assert float(tq.value_lo) == float(iq.value_lo)
    assert float(tq.value_hi) == float(iq.value_hi)


def test_torch_h_frac_branches():
    """Uniform spacing shares one row; perturbed heights keep (N, Lm)."""
    ds = jsyn.icosphere(2, 5)
    for d, rows in ((ds, 1), (_perturbed(ds), ds.num_cells)):
        tq = qcells.quantize_cells(interop.dataset(d))
        assert tq.h_frac.shape == (rows, 8)
        assert tq.h_frac.dtype == torch.float32


def test_torch_locator_csr_matches_jax(scene):
    """build_locator_csr + densify_csr: the same k_cap, window and
    (n_bins, k_cap) candidate rows as JAX, bin for bin."""
    _, ds_q, *_ = scene
    jloc, jk = jcsr(ds_q)
    tcsr, tk = build_locator_csr(interop.dataset(ds_q))
    assert tk == jk
    np.testing.assert_array_equal(tcsr.starts, np.asarray(jloc.starts))
    np.testing.assert_array_equal(tcsr.items, np.asarray(jloc.items))
    tloc = densify_csr(tcsr, tk)
    iloc = interop.locator_packed(jdensify(jloc, jk), jk)
    np.testing.assert_array_equal(tloc.bins.numpy(), iloc.bins.numpy())
    for f in ("lat_lo", "lat_hi", "lon_lo", "lon_hi", "dims"):
        np.testing.assert_array_equal(getattr(tloc, f).numpy(),
                                      getattr(iloc, f).numpy())


def _bake_pair(scene):
    _, ds_q, lo, hi, tf, _ = scene
    jqc = jq.bake_alpha_q(jq.quantize_cells(ds_q, value_range=(lo, hi)), tf)
    tqc = qcells.bake_alpha_q(
        qcells.quantize_cells(interop.dataset(ds_q), value_range=(lo, hi)),
        interop.transfunc(tf))
    return jqc, tqc


def _assert_same_bake(jqc, tqc, n):
    iq = interop.quantized_cells(jqc, n=n)
    np.testing.assert_array_equal(tqc.alpha_q.numpy(), iq.alpha_q.numpy())
    np.testing.assert_array_equal(tqc.alpha_tab, jqc.alpha_tab)
    assert _ulp(tqc.alpha_max.numpy(), iq.alpha_max.numpy()) <= 1


def _edited(tf, edit):
    lut = np.asarray(tf.values).copy()
    edit(lut)
    return tf._replace(values=jnp.asarray(lut))


@pytest.mark.parametrize("donate", [False, True], ids=["base", "donated"])
@pytest.mark.parametrize("path", ["unchanged", "patch", "lookup"])
def test_torch_bake_alpha_q_matches_jax(scene, path, donate, monkeypatch):
    """bake_alpha_q (plain K5c-q) equals JAX on each edit from a baked
    base: alpha_q and the normalized table exact, alpha_max <= 1 ULP.
    unchanged: a colour-only edit keeps the table (no rewrite); patch: one
    halved LUT alpha (<= 32 changed levels, JAX's patch); lookup: the lower
    half of the LUT made transparent (JAX's full lookup).  The port runs
    both edits through the lookup (by the invariant alpha_q ==
    alpha_tab[value_q] it equals JAX's patch): into a new table, or with
    donation into q.alpha_q's storage."""
    edits = {"unchanged": lambda l: l.__setitem__((slice(None), [0, 2]),
                                                  l[:, [2, 0]]),
             "patch": lambda l: l.__setitem__((3, 3), l[3, 3] * 0.5),
             "lookup": lambda l: l.__setitem__((slice(0, 16), 3), 0.0)}
    jqc, tqc = _bake_pair(scene)
    n = tqc.num_cells
    _assert_same_bake(jqc, tqc, n)
    calls = []
    fn = qcells.bake_lookup
    monkeypatch.setattr(qcells, "bake_lookup", lambda *a, **k: (
        calls.append(k.get("out") is not None), fn(*a, **k))[1])
    tf2 = _edited(scene[4], edits[path])
    jq2 = jq.bake_alpha_q(jqc, tf2)
    tq2 = qcells.bake_alpha_q(tqc, interop.transfunc(tf2), donate=donate)
    _assert_same_bake(jq2, tq2, n)
    if path == "unchanged":
        assert calls == [] and tq2.alpha_q is tqc.alpha_q
        return
    changed = (tq2.alpha_tab != tqc.alpha_tab).sum()
    assert (0 < changed <= 32) == (path == "patch")
    assert calls == [donate]
    assert (tq2.alpha_q.data_ptr() == tqc.alpha_q.data_ptr()) == donate


@pytest.mark.parametrize("form", ["patch", "lookup", "no_tab"])
def test_torch_bake_alpha_q_donation(scene, form):
    """Without donation an edit never writes the alpha_q it was given (an
    edit may start again from the same base); with donation the returned
    table is the old one's storage, rewritten in place by the lookup's
    out= form, and equal to the edit without donation.  patch: an edit of
    <= 32 levels (JAX patches it); lookup: a wide one; no_tab: the old
    normalized table unknown."""
    _, tqc = _bake_pair(scene)
    if form == "no_tab":
        tqc = tqc._replace(alpha_tab=None)
    rows = slice(4, 5) if form == "patch" else slice(4, 12)
    tf2 = interop.transfunc(_edited(scene[4], lambda l: l.__setitem__(
        (rows, 3), l[rows, 3] * 0.3)))
    before = tqc.alpha_q.clone()
    kept = qcells.bake_alpha_q(tqc, tf2)
    assert torch.equal(tqc.alpha_q, before)
    assert kept.alpha_q.data_ptr() != tqc.alpha_q.data_ptr()
    assert not torch.equal(kept.alpha_q, before)
    if form == "patch":
        assert 0 < (kept.alpha_tab != tqc.alpha_tab).sum() <= 32
    given = qcells.bake_alpha_q(tqc, tf2, donate=True)
    assert given.alpha_q.data_ptr() == tqc.alpha_q.data_ptr()
    assert torch.equal(given.alpha_q, kept.alpha_q)
    assert torch.equal(tqc.alpha_q, kept.alpha_q)
    np.testing.assert_array_equal(given.alpha_tab, kept.alpha_tab)


def _levels(kind, rng):
    """A patch's (lev, new): 32 entries -1 padded, or all 256 levels."""
    if kind == "ends":                       # levels 0 and 255, 30 pads
        lev = np.full(32, -1, np.int32)
        lev[:2] = (0, 255)
    elif kind == "all32":                    # 32 real levels
        lev = rng.choice(256, 32, replace=False).astype(np.int32)
    else:                                    # every level, shuffled
        lev = rng.permutation(256).astype(np.int32)
    return lev, rng.integers(0, 256, lev.shape[0], dtype=np.uint8)


@pytest.mark.parametrize("lm", [8, 24])
@pytest.mark.parametrize("kind", ["ends", "all32", "all256"])
def test_torch_bake_plain_matches_jax(kind, lm):
    """K5c-q against JAX's `_bake_lookup` and `_bake_patch` on random
    (N, Lm) tables that hold levels 0 and 255, byte-equal: the lookup of
    a random table, and JAX's patch of a baked table (aq = tab[vq]) at
    the listed levels against the lookup of the edited table (tab with
    new at lev), the form in which the port runs every edit.  "all256"
    lists every level: JAX's compare-select broadcasts over a lev of any
    length."""
    rng = np.random.default_rng(lm + len(kind))
    vq = rng.integers(0, 256, (203, lm), dtype=np.uint8)
    vq[0, :2] = (0, 255)
    tab = rng.integers(0, 256, 256, dtype=np.uint8)
    lev, new = _levels(kind, rng)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        qcells.bake_lookup(t(vq), t(tab)).numpy(),
        np.asarray(jq._bake_lookup(jnp.asarray(vq), jnp.asarray(tab))))
    aq = tab[vq]
    want = np.asarray(jq._bake_patch(jnp.asarray(vq), jnp.asarray(aq),
                                     jnp.asarray(lev), jnp.asarray(new)))
    assert (want != aq).any()
    edited = tab.copy()
    edited[lev[lev >= 0]] = new[lev >= 0]
    np.testing.assert_array_equal(
        qcells.bake_lookup(t(vq), t(edited)).numpy(), want)
    into = t(aq.copy())
    assert qcells.bake_lookup(t(vq), t(edited), out=into) is into
    np.testing.assert_array_equal(into.numpy(), want)


def test_torch_alpha_bake_floor_conservative(scene):
    """The port's twin of test_fastq.py:71: every baked alpha is <= the
    exact postClassify alpha of its dequantized value, and within one
    quantization step of it."""
    _, tqc = _bake_pair(scene)
    tf = scene[4]
    vq = tqc.value_q.numpy().astype(np.float32)
    v = float(tqc.value_lo) + vq / 255.0 * float(tqc.value_hi
                                                - tqc.value_lo)
    exact = np.asarray(jpost_classify(tf, jnp.asarray(v.reshape(-1))))[:, 3]
    amax = float(tqc.alpha_max)
    baked = tqc.alpha_q.numpy().astype(np.float32).reshape(-1) / 255.0 * amax
    assert (baked <= exact + 1e-6).all()
    assert np.abs(baked - exact).max() <= amax / 255.0 + 1e-6


def test_torch_bake_kernels_plain_and_checks():
    """The K5c-q wrapper on CPU tensors runs the plain version (a table
    gather, into a new table or `out`) and rejects malformed tables."""
    rng = np.random.default_rng(0)
    vq = torch.from_numpy(rng.integers(0, 256, (50, 8), dtype=np.uint8))
    tab = torch.from_numpy(rng.integers(0, 256, 256, dtype=np.uint8))
    out = qcells.bake_lookup(vq, tab)
    np.testing.assert_array_equal(out.numpy(), tab.numpy()[vq.numpy()])
    with pytest.raises(ValueError):
        qcells.bake_lookup(vq.to(torch.int32), tab)
    with pytest.raises(ValueError):
        qcells.bake_lookup(vq, tab[:100])
    with pytest.raises(ValueError):
        qcells.bake_lookup(vq, tab.to(torch.int32))
    with pytest.raises(ValueError):
        qcells.bake_lookup(vq.t(), tab)
    into = torch.zeros_like(vq)
    assert qcells.bake_lookup(vq, tab, out=into) is into
    np.testing.assert_array_equal(into.numpy(), out.numpy())
    with pytest.raises(ValueError):
        qcells.bake_lookup(vq, tab, out=into[:10])
    with pytest.raises(ValueError):
        qcells.bake_lookup(vq, tab, out=into.to(torch.int32))


def test_torch_quantize_27_layers_diverges_from_jax():
    """A dataset of 25-31 layers rounds Lm up to 32, one more ceiling
    column than the dataset's height array holds past h_bot (31).  JAX's
    quantize_cells raises there (its (N, 31) ceilings against a (N, 32)
    mask); the port pads the missing column and masks it, with every
    column past num_layers, to 65535, so it quantizes: h_frac (1, 32),
    the 27 real ceilings ascending, then 65535.  The plain K2 renders
    that table: a finite frame that covers pixels."""
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models.cells import compute_stats
    from icon_rt_tpu_torch.models.finemap import build_finemap
    from icon_rt_tpu_torch.models.locator import build_locator
    from icon_rt_tpu_torch.models.shells import (build_radial_bands,
                                                 update_band_majorants)
    from icon_rt_tpu_torch.models.transfunc import make_transfunc
    from icon_rt_tpu_torch.ops.camera import Camera
    from icon_rt_tpu_torch.ops.fastq import render_frame_fast_q
    from icon_rt_tpu_torch.ops.render import alloc_frame, make_launch_params
    ds = jsyn.icosphere(2, 27)
    with pytest.raises(ValueError):
        jq.quantize_cells(ds)
    tds = synthetic.icosphere(2, 27)
    q = qcells.quantize_cells(tds)
    assert q.lm == 32 and q.h_frac.shape == (1, 32)
    row = q.h_frac[0]
    assert bool((row[1:27] >= row[:26]).all()) and float(row[26]) == 65535.0
    assert bool((row[27:] == 65535.0).all())
    st = compute_stats(tds)
    tf = make_transfunc(value_range=tuple(st.data_range))
    q = qcells.bake_alpha_q(q, tf)
    loc = build_locator(tds)
    bands = update_band_majorants(build_radial_bands(tds, 16), tf.values,
                                  tf.value_range)
    cam = Camera()
    c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    cam.set_orientation(c + np.array([2.0, 0.3, 0.8], np.float32)
                        * st.spherical_bounds_hi[0], c,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(16, 16), st.world_bounds_lo,
                            st.world_bounds_hi, unit_distance=1e3)
    acc, fb = alloc_frame(16, 16)
    render_frame_fast_q(q, loc, bands, tf, lp, acc, fb, width=16, height=16,
                        samples=2, finemap=build_finemap(loc, q.test12))
    assert bool(torch.isfinite(acc).all())
    assert int(((fb.numpy().view(np.uint32) >> 24) > 0).sum()) > 0
