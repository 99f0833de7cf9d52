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


@pytest.mark.parametrize("path", ["unchanged", "patch", "lookup"])
def test_torch_bake_alpha_q_matches_jax(scene, path, monkeypatch):
    """bake_alpha_q (plain K5c-q) equals JAX on each path of an edit from a
    baked base: alpha_q and the normalized table exact, alpha_max <= 1 ULP.
    unchanged: a colour-only edit keeps the table (no rewrite); patch: one
    halved LUT alpha (<= 32 changed levels); lookup: the lower half of the
    LUT made transparent."""
    edits = {"unchanged": lambda l: l.__setitem__((slice(None), [0, 2]),
                                                  l[:, [2, 0]]),
             "patch": lambda l: l.__setitem__((3, 3), l[3, 3] * 0.5),
             "lookup": lambda l: l.__setitem__((slice(0, 16), 3), 0.0)}
    jqc, tqc = _bake_pair(scene)
    n = tqc.num_cells
    _assert_same_bake(jqc, tqc, n)
    calls = []
    for name in ("bake_lookup", "bake_patch"):
        fn = getattr(qcells, name)
        monkeypatch.setattr(qcells, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    tf2 = _edited(scene[4], edits[path])
    jq2 = jq.bake_alpha_q(jqc, tf2)
    tq2 = qcells.bake_alpha_q(tqc, interop.transfunc(tf2))
    _assert_same_bake(jq2, tq2, n)
    if path == "unchanged":
        assert calls == [] and tq2.alpha_q is tqc.alpha_q
    else:
        assert calls == [f"bake_{path}"]
        changed = (tq2.alpha_tab != tqc.alpha_tab).sum()
        assert (0 < changed <= qcells.PATCH_LEVELS) == (path == "patch")


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
    """The K5c-q wrappers on CPU tensors run the plain versions (lookup is
    a table gather, patch rewrites only the listed levels) and reject
    malformed tables."""
    rng = np.random.default_rng(0)
    vq = torch.from_numpy(rng.integers(0, 256, (50, 8), dtype=np.uint8))
    tab = torch.from_numpy(rng.integers(0, 256, 256, dtype=np.uint8))
    out = qcells.bake_lookup(vq, tab)
    np.testing.assert_array_equal(out.numpy(), tab.numpy()[vq.numpy()])
    lev = torch.full((32,), -1, dtype=torch.int32)
    lev[:3] = torch.tensor([5, 77, 200], dtype=torch.int32)
    new = torch.zeros(32, dtype=torch.uint8)
    new[:3] = torch.tensor([1, 2, 3], dtype=torch.uint8)
    got = qcells.bake_patch(vq, out, lev, new).numpy()
    want = out.numpy().copy()
    for lv, nv in ((5, 1), (77, 2), (200, 3)):
        want[vq.numpy() == lv] = nv
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        qcells.bake_lookup(vq.to(torch.int32), tab)
    with pytest.raises(ValueError):
        qcells.bake_lookup(vq, tab[:100])
    with pytest.raises(ValueError):
        qcells.bake_patch(vq, out[:10], lev, new)
    with pytest.raises(ValueError):
        qcells.bake_patch(vq, out, lev[:8], new)
