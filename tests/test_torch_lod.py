"""PyTorch port, LOD: data/lod.py (host numpy) against the JAX package's
icon_rt_tpu/data/lod.py and bench.py `_auto_lod`, the plain K7-scene mip
tier (synth_quantized_device with field_lod > 0) against JAX's device
build, build_q_scene's mip tier against JAX's render of its own, and the
port's fix of the reference's fault F1 in build_lod_dataset."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from icon_rt_tpu.data import lod as jlod
from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.data.bigscene import build_locator_csr_from_scene as jcsr
from icon_rt_tpu.data.bigscene import synth_quantized as jsynth
from icon_rt_tpu.data.device_scene import synth_quantized_device as jdevice
from icon_rt_tpu.models.qcells import bake_alpha_q as jbake
from icon_rt_tpu.models.shells import update_band_majorants as jmajorants
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops.camera import Camera
from icon_rt_tpu.ops.fastq import render_frame_fast_q as jrender_q
from icon_rt_tpu.ops.order import inverse_order as jinverse
from icon_rt_tpu.ops.order import pixel_order as jpixel_order
from icon_rt_tpu.ops.render import alloc_frame as jalloc
from icon_rt_tpu.ops.render import make_launch_params as jmake_lp
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.data import bigscene, lod
from icon_rt_tpu_torch.data.device_scene import synth_quantized_device
from icon_rt_tpu_torch.data.icfile import ICDataset, MAX_LAYERS
from icon_rt_tpu_torch.ops.fastq import render_frame_fast_q
from icon_rt_tpu_torch.ops.order import inverse_order, pixel_order
from icon_rt_tpu_torch.ops.render import alloc_frame, make_launch_params
from test_torch_fastq import FB_MISMATCH_BOUND

torch.set_num_threads(1)

LAYERS = 4

_RNG = np.random.default_rng(11)
#: (function name, positional args) of the index and selection helpers
HELPER_CASES = [
    ("parent_index", (_RNG.integers(0, 20 * 4 ** 5, 64), 20 * 4 ** 5)),
    ("parent_index", (12345, 20 * 4 ** 7)),
    ("children_indices", (17, 20 * 4 ** 3)),
    ("children_indices", (_RNG.integers(0, 320, 8), 320)),
    ("cell_edge_m", (11, 6.401229e6)),
    ("cell_edge_m", (3, 6.371229e6)),
    ("equivalent_subdiv", (20 * 4 ** 9,)),
    ("equivalent_subdiv", (5000,)),
    ("equivalent_subdiv", (3,)),
    *[("select_lod", (_RNG.uniform(-3e7, 3e7, 3), 6.401229e6,
                      float(_RNG.uniform(0.3, 1.6)), int(h), int(s)))
      for h, s in zip(_RNG.integers(270, 2161, 8), _RNG.integers(4, 12, 8))],
    ("select_lod", (np.array([2.6e9, 0.0, 0.0]), 6.371229e6,
                    np.deg2rad(60.0), 1080, 11)),
]


@pytest.mark.parametrize("name,args", HELPER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(HELPER_CASES)])
def test_torch_lod_helpers_equal_jax(name, args):
    """parent_index, children_indices, cell_edge_m, equivalent_subdiv and
    select_lod give JAX's results, bit for bit."""
    got = getattr(lod, name)(*args)
    want = getattr(jlod, name)(*args)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert type(got) is type(want)


@pytest.mark.parametrize("framing,levels", [("closeup", (0, 0, 0, 0)),
                                            ("viewall", (0, 1, 2, 3))])
def test_torch_frame_lod_equals_auto_lod(framing, levels):
    """frame_lod is bench.py `_auto_lod` (after its clamp to subdiv - 1)
    at 1920x1080 for subdiv 8-11: closeup never pools, viewall pools
    1/2/3 levels at subdiv 9/10/11 (R2B9 viewall renders level 3)."""
    for subdiv, want in zip(range(8, 12), levels):
        got = lod.frame_lod(subdiv, framing, bench.WIDTH, bench.HEIGHT)
        assert got == min(bench._auto_lod(subdiv, framing), subdiv - 1)
        assert got == want
    assert lod.frame_lod(1, "viewall", 16, 16) == 0        # the clamp


@pytest.fixture(scope="module", params=[1, 2])
def tiers(request):
    """JAX's device build of the level-l mip tier (as its tests run it),
    the port's plain build of the same tier, and the port's lod-0 build of
    the same geometry."""
    lvl = request.param
    sub = 3 - lvl
    n = 20 * 4 ** sub
    jd = jdevice(sub, LAYERS, chunk_cells=512, field_lod=lvl)
    td = synth_quantized_device(sub, LAYERS, device="cpu", field_lod=lvl,
                                latlon=True)
    t0 = synth_quantized_device(sub, LAYERS, device="cpu", latlon=True)
    return lvl, interop.device_scene(jd, n), td, t0


def test_torch_field_lod_matches_jax(tiers):
    """The mip tier's value_q equals JAX's on every entry;
    the value range within 1e-5 of JAX's (XLA's f32 reductions; 1 ULP
    apart at lod 0 as well).  Its geometry is the subdivision's own:
    test12, corner lat/lon and every bound bit-equal to the port's lod-0
    build, and test12 to JAX's within test_torch_device_scene.py's
    tolerance (XLA contracts the cross products into FMAs, so no build of
    the port is bit-equal to JAX's there)."""
    _, jd, td, t0 = tiers
    np.testing.assert_array_equal(td.cells.value_q.numpy(),
                                  jd.cells.value_q.numpy())
    assert (td.cells.value_q.numpy()[:, LAYERS:] == 0).all()
    for f in ("value_lo", "value_hi"):
        assert float(getattr(td.cells, f)) == pytest.approx(
            float(getattr(jd.cells, f)), rel=1e-5)
    np.testing.assert_allclose(td.stats.data_range, jd.stats.data_range,
                               rtol=1e-5)
    for f in ("world_bounds_lo", "world_bounds_hi", "spherical_bounds_lo",
              "spherical_bounds_hi"):
        np.testing.assert_array_equal(getattr(td.stats, f),
                                      getattr(t0.stats, f), err_msg=f)
        np.testing.assert_allclose(getattr(td.stats, f),
                                   getattr(jd.stats, f), rtol=1e-6,
                                   err_msg=f)
    for f in ("test12", "h_frac"):
        assert torch.equal(getattr(td.cells, f), getattr(t0.cells, f)), f
    assert torch.equal(td.lat, t0.lat) and torch.equal(td.lon, t0.lon)
    t, want = td.cells.test12.numpy(), jd.cells.test12.numpy()
    np.testing.assert_allclose(t[:, :9], want[:, :9], rtol=2e-5,
                               atol=2e-2 * np.abs(want[:, :9]).max())
    np.testing.assert_array_equal(t[:, 9:12], want[:, 9:12])
    lvl = (float(td.cells.value_hi) - float(td.cells.value_lo)) / 255.0
    np.testing.assert_allclose(td.bands.value_ranges.numpy(),
                               jd.bands.value_ranges.numpy(), atol=1.5 * lvl)


@pytest.mark.parametrize("lvl", [1, 2])
def test_torch_field_lod_windows_match_jax(lvl):
    """The pass split's plain versions of the mip tier over index windows
    (subdivision 4, ancestors of depth 1: a window at the head, one across
    the ancestor table's period, one at the tail): each window's pooled
    field, test12 and value_q bit-equal to the whole plain build's rows,
    and value_q equal to JAX's device build on every entry."""
    from icon_rt_tpu_torch.data import device_scene as ds
    sub = 4
    n = 20 * 4 ** sub
    jd = interop.device_scene(jdevice(sub, LAYERS, chunk_cells=1024,
                                      field_lod=lvl), n)
    td = synth_quantized_device(sub, LAYERS, device="cpu", field_lod=lvl)
    c = ds._Consts(sub, LAYERS, float(td.stats.spherical_bounds_lo[0]),
                   3.0e4, "cpu", lod=lvl)
    lo, hi = float(td.cells.value_lo), float(td.cells.value_hi)
    scale = float(ds.quant_scale(lo, hi))
    whole = ds._scene_pass1_torch(c, 0, n)
    count = 40
    for start in (0, c.n_anc - count // 2, n - count):
        p1 = ds._scene_pass1_torch(c, start, count)
        rows = slice(start, start + count)
        assert torch.equal(p1.field, whole.field[rows])
        t12, vq = ds._scene_pass2_torch(c, p1, lo, scale)[:2]
        assert torch.equal(t12, td.cells.test12[rows])
        assert torch.equal(vq, td.cells.value_q[rows])
        np.testing.assert_array_equal(vq.numpy(),
                                      jd.cells.value_q.numpy()[rows])


def test_torch_field_lod_is_mean_pool_of_fine(tiers):
    """tests/test_lod.py's contract for the port: each mip cell's
    dequantized layer values are the mean of its 4**l descendants' values
    in the full-resolution build, within one step of each quantization
    grid; and the mip's value range lies inside the fine one."""
    lvl, _, td, _ = tiers
    fine = synth_quantized_device(3, LAYERS, device="cpu")
    n = 20 * 4 ** 3
    nc = n // 4 ** lvl

    def deq(sc):
        lo, hi = float(sc.cells.value_lo), float(sc.cells.value_hi)
        q = sc.cells.value_q.numpy()[:, :LAYERS].astype(np.float64)
        return lo + q * (hi - lo) / 255.0

    pooled = deq(fine).reshape(4 ** lvl, nc, LAYERS).mean(axis=0)
    step = lambda sc: (float(sc.cells.value_hi)
                       - float(sc.cells.value_lo)) / 255.0
    assert np.abs(deq(td) - pooled).max() <= step(fine) + 0.5 * step(td)
    assert float(td.cells.value_lo) >= float(fine.cells.value_lo)
    assert float(td.cells.value_hi) <= float(fine.cells.value_hi)


def _viewall_lp_jax(stats, w):
    cam = Camera()
    cam.set_aspect(1.0)
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    ud = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
    return jmake_lp(cam.basis(w, w), stats.world_bounds_lo,
                    stats.world_bounds_hi, unit_distance=ud)


def test_torch_mip_tier_renders_like_jax():
    """The counterpart of tests/test_lod.py's
    test_mip_tier_renders_close_to_full_res: subdiv 3 at level 1, the
    reference's viewall framing, 48x48, 8 samples.  The port's whole path
    (build_q_scene with field_lod=1, frame_camera, pixel_order, K2's plain
    version) against JAX's (its device mip tier, a locator binned from its
    host scene): fb mismatches within test_torch_fastq.py's
    FB_MISMATCH_BOUND (measured: 0 of 177 covered pixels); and the port's
    mip tier against its own full-resolution render as JAX's test holds
    JAX's (coverage > 0.97, RMSE < 0.12 where both cover)."""
    w, spp = 48, 8

    def port(field_lod):
        q, loc, _, bands, tf, stats, fm, lvl, eff = bigscene.build_q_scene(
            3, LAYERS, device="cpu", field_lod=field_lod)
        assert (lvl, eff) == (field_lod, 3 - field_lod)
        cam = lod.frame_camera(stats, "viewall", w, w)
        ud = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
        lp = make_launch_params(cam.basis(w, w), stats.world_bounds_lo,
                                stats.world_bounds_hi, unit_distance=ud)
        perm, n_act = pixel_order(lp, stats.spherical_bounds_lo[0],
                                  stats.spherical_bounds_hi[0], w, w)
        acc, fb = alloc_frame(w, w)
        render_frame_fast_q(q, loc, bands, tf, lp, acc, fb, width=w,
                            height=w, pixel_perm=perm, n_active=n_act,
                            samples=spp, finemap=fm)
        inv = inverse_order(perm).numpy()
        return acc.numpy()[inv], fb.numpy().view(np.uint32)[inv]

    dsc = jdevice(2, LAYERS, field_lod=1)
    st = dsc.stats
    tf = jmake_tf(value_range=tuple(st.data_range))
    q = jbake(dsc.cells, tf)
    bands = jmajorants(dsc.bands, tf.values, tf.value_range)
    loc, k_cap = jcsr(jsynth(2, LAYERS))
    lp = _viewall_lp_jax(st, w)
    perm, n_act = jpixel_order(lp, st.spherical_bounds_lo[0],
                               st.spherical_bounds_hi[0], w, w)
    _, fj = jrender_q(q, loc, k_cap, bands, tf, lp, *jalloc(w, w), width=w,
                      height=w, pixel_perm=jnp.asarray(perm), n_active=n_act,
                      chunk=w * w, samples=spp)
    fj = np.asarray(fj)[jinverse(perm)]

    mip_a, mip_f = port(1)
    assert (fj != 0).sum() > 100
    assert (fj != mip_f).sum() <= FB_MISMATCH_BOUND

    full_a, _ = port(0)
    cov_f, cov_m = full_a[:, 3] > 0, mip_a[:, 3] > 0
    assert (cov_f == cov_m).mean() > 0.97
    both = cov_f & cov_m
    rmse = float(np.sqrt(np.mean((full_a[both][:, :3]
                                  - mip_a[both][:, :3]) ** 2)))
    assert rmse < 0.12


def test_torch_build_q_scene_mip_shares_geometry_cache(tmp_path,
                                                       monkeypatch):
    """A mip tier's locator and fine map are the subdivision-eff scene's:
    cached by the lod-0 build of subdiv eff, the level-1 build of subdiv
    eff + 1 loads the same tables (one locator and one fine map file)."""
    monkeypatch.setattr(bigscene, "CACHE_DIR", str(tmp_path))
    plain = bigscene.build_q_scene(2, LAYERS, device="cpu", cache=True)
    mip = bigscene.build_q_scene(3, LAYERS, device="cpu", field_lod=1,
                                 cache=True)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"fmap_s2_l{LAYERS}_f2.npz", f"qloc_s2_l{LAYERS}.npz"]
    assert mip[7:] == (1, 2) and mip[2] == plain[2]
    assert torch.equal(mip[1].bins, plain[1].bins)
    assert torch.equal(mip[6].slots, plain[6].slots)
    assert torch.equal(mip[0].test12, plain[0].test12)
    assert not torch.equal(mip[0].value_q, plain[0].value_q)


def _terrain():
    ds0 = jsyn.icosphere(subdivisions=3, num_layers=6)
    rng = np.random.default_rng(7)
    shift = rng.uniform(0.0, 5e3, ds0.num_cells).astype(np.float32)
    return dataclasses.replace(ds0, height=ds0.height + shift[:, None])


@pytest.mark.parametrize("make", [
    _terrain, lambda: jsyn.latlon_section(n_lat=6, n_lon=10, num_layers=3)],
    ids=["general_terrain", "regional"])
def test_torch_build_lod_dataset_geometry_equals_jax(make):
    """On tests/test_lod.py's general-terrain and regional datasets: the
    coarse geometry (lat, lon, height, num_layers) and the assignment of
    every fine column are bit-equal to JAX's; every pooled layer value lies
    within its members' values (the values themselves differ from JAX's by
    fault F1, test_torch_build_lod_dataset_pools_own_layers)."""
    ds = make()
    want, want_assign = jlod.build_lod_dataset(ds, 1)
    got, assign = lod.build_lod_dataset(ds, 1)
    np.testing.assert_array_equal(assign, want_assign)
    for f in ("lat", "lon", "num_layers", "height"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    mask = np.arange(MAX_LAYERS)[None, :] < ds.num_layers[:, None]
    vmin = np.full(got.num_cells, np.inf)
    vmax = np.full(got.num_cells, -np.inf)
    np.minimum.at(vmin, assign, np.where(mask, ds.value, np.inf).min(1))
    np.maximum.at(vmax, assign, np.where(mask, ds.value, -np.inf).max(1))
    for k in range(int(got.num_layers[0])):
        v = got.value[:, k]
        assert (v >= vmin - 1e-5).all() and (v <= vmax + 1e-5).all()


def test_torch_build_lod_dataset_pools_own_layers():
    """Fault F1 of the reference (ROADMAP Queue 3), fixed in the port:
    every fine layer j carries the distinct value j + 1 on columns of 6 of
    the 31 possible layers.  The coarse tier keeps the 6 uniform layers, so
    each coarse layer's midpoint lies in fine layer k of every member and
    its pooled value must be k + 1: the port gives exactly that.  JAX's
    build_lod_dataset compares the midpoint with all 31 ceiling slots,
    including the zero padding past num_layers, and so pools every
    member's top layer (6) into every coarse layer: the divergence this
    test states."""
    ds0 = jsyn.icosphere(subdivisions=3, num_layers=6)
    value = np.zeros_like(ds0.value)
    value[:, :6] = np.arange(1, 7, dtype=np.float32)
    ds = ICDataset(lat=ds0.lat, lon=ds0.lon, num_layers=ds0.num_layers,
                   height=ds0.height, value=value)
    got, _ = lod.build_lod_dataset(ds, 1)
    assert (got.num_layers == 6).all()
    np.testing.assert_array_equal(
        got.value[:, :6], np.broadcast_to(np.arange(1, 7, dtype=np.float32),
                                          (got.num_cells, 6)))
    want, _ = jlod.build_lod_dataset(ds, 1)
    np.testing.assert_array_equal(want.value[:, :6], 6.0)
