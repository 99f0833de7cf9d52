"""PyTorch port, the north-star scene: data/bigscene.py `synth_quantized`,
`to_device`, `build_locator_csr_from_scene` and `build_q_scene`;
data/device_scene.py `synth_quantized_device` (plain K7-scene); and
models/locator.py `bin_locator` (plain K7-loc), held against the JAX
package's host and device synthesizers and its host binning on the same
scenes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import bigscene as jbig
from icon_rt_tpu.data.device_scene import synth_quantized_device as jdevice
from icon_rt_tpu.models.finemap import build_finemap as jbuild_finemap
from icon_rt_tpu.models.qcells import bake_alpha_q as jbake
from icon_rt_tpu.models.shells import update_band_majorants as jmajorants
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops.camera import Camera
from icon_rt_tpu.ops.fastq import render_frame_fast_q as jrender_q
from icon_rt_tpu.ops.order import pixel_order as jpixel_order
from icon_rt_tpu.ops.render import alloc_frame as jalloc
from icon_rt_tpu.ops.render import make_launch_params as jmake_lp
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.data import bigscene
from icon_rt_tpu_torch.data.device_scene import synth_quantized_device
from icon_rt_tpu_torch.models import finemap, locator
from icon_rt_tpu_torch.models.qcells import bake_alpha_q
from icon_rt_tpu_torch.models.shells import update_band_majorants
from icon_rt_tpu_torch.models.transfunc import make_transfunc
from icon_rt_tpu_torch.ops.fastq import render_frame_fast_q
from icon_rt_tpu_torch.ops.render import alloc_frame
from test_torch_fastq import FB_MISMATCH_BOUND

torch.set_num_threads(1)

SUBDIV, LAYERS = 3, 6
N = 20 * 4 ** SUBDIV


@pytest.fixture(scope="module")
def scenes():
    """JAX's host and device builds and the port's plain device build of
    one scene (the JAX device build as tests/test_device_scene.py runs
    it)."""
    sc = jbig.synth_quantized(SUBDIV, LAYERS)
    jd = jdevice(SUBDIV, LAYERS, chunk_cells=512)
    td = synth_quantized_device(SUBDIV, LAYERS, device="cpu", latlon=True)
    return sc, interop.device_scene(jd, N), td, jd


def test_torch_synth_quantized_bit_equal_to_jax():
    """The host synthesizer: every array and scalar bit-equal to JAX's; and
    to_device's unpacked tables equal JAX's packed ones."""
    a = jbig.synth_quantized(2, 5)
    b = bigscene.synth_quantized(2, 5)
    for f in ("test12", "h_frac", "value_q", "lat", "lon", "band_edges",
              "band_ranges"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    assert (b.value_lo, b.value_hi) == (a.value_lo, a.value_hi)
    for f in b.stats._fields:
        np.testing.assert_array_equal(getattr(b.stats, f),
                                      getattr(a.stats, f), err_msg=f)
    jq, jb = jbig.to_device(a)
    q, bands = bigscene.to_device(b, device="cpu")
    want = interop.quantized_cells(jq, n=b.num_cells)
    for f in ("test12", "h_frac", "value_q", "alpha_q", "value_lo",
              "value_hi", "alpha_max"):
        assert torch.equal(getattr(q, f), getattr(want, f)), f
    want_b = interop.radial_bands(jb)
    for f in bands._fields:
        assert torch.equal(getattr(bands, f), getattr(want_b, f)), f


def test_torch_device_scene_geometry_matches_jax(scenes):
    """Plane normals to JAX's device build within test_device_scene.py's
    tolerance (f32 transcendental slack); h_bot, h_top, num_layers exact."""
    _, jd, td, _ = scenes
    t, want = td.cells.test12.numpy(), jd.cells.test12.numpy()
    assert t.shape == (N, 12)
    np.testing.assert_allclose(t[:, :9], want[:, :9], rtol=2e-5,
                               atol=2e-2 * np.abs(want[:, :9]).max())
    np.testing.assert_array_equal(t[:, 9:12], want[:, 9:12])


def test_torch_device_scene_values_match_jax(scenes):
    """u8 levels within 1 of JAX's on < 5% of entries; the value range, the
    shared h_frac row, the stats and the band ranges as
    test_device_scene.py holds JAX's device build to its host build."""
    sc, jd, td, _ = scenes
    lm = td.cells.lm
    dv = np.abs(td.cells.value_q.numpy().astype(int)
                - jd.cells.value_q.numpy().astype(int))
    assert td.cells.value_q.shape == (N, lm) and dv.max() <= 1
    assert (dv > 0).mean() < 0.05
    assert (td.cells.value_q.numpy()[:, LAYERS:] == 0).all()
    for f in ("value_lo", "value_hi"):
        assert float(getattr(td.cells, f)) == pytest.approx(
            float(getattr(jd.cells, f)), rel=1e-5)
    np.testing.assert_array_equal(td.cells.h_frac.numpy(),
                                  jd.cells.h_frac.numpy())
    np.testing.assert_array_equal(td.cells.h_frac.numpy(),
                                  sc.h_frac[:1].astype(np.float32))
    for f in td.stats._fields:
        np.testing.assert_allclose(getattr(td.stats, f),
                                   getattr(jd.stats, f), rtol=1e-5,
                                   err_msg=f)
    lvl = (float(td.cells.value_hi) - float(td.cells.value_lo)) / 255.0
    np.testing.assert_array_equal(td.bands.edges.numpy(),
                                  jd.bands.edges.numpy())
    np.testing.assert_allclose(td.bands.value_ranges.numpy(),
                               jd.bands.value_ranges.numpy(), atol=1.5 * lvl)
    np.testing.assert_allclose(td.bands.value_ranges.numpy(), sc.band_ranges,
                               atol=1.5 * lvl)


def test_torch_device_scene_band_ranges_conservative(scenes):
    """Every cell layer's dequantized value lies inside the range of every
    radial band the layer overlaps, for the port's own tables — the
    invariant the Woodcock majorants depend on."""
    td = scenes[2]
    q = td.cells
    lo, hi = float(q.value_lo), float(q.value_hi)
    vals = lo + q.value_q.numpy()[:, :LAYERS].astype(np.float64) \
        * (hi - lo) / 255.0
    edges = td.bands.edges.numpy()
    vr = td.bands.value_ranges.numpy()
    h_bot = float(td.stats.spherical_bounds_lo[0])
    h_top = float(td.stats.spherical_bounds_hi[0])
    layer_h = (h_top - h_bot) / LAYERS
    for j in range(LAYERS):
        b0 = np.searchsorted(edges, h_bot + j * layer_h, side="right") - 1
        b1 = np.searchsorted(edges, h_bot + (j + 1) * layer_h,
                             side="left") - 1
        b0, b1 = (int(np.clip(b, 0, vr.shape[0] - 1)) for b in (b0, b1))
        for b in range(b0, b1 + 1):
            assert vr[b, 0] <= vals[:, j].min() + 1e-6
            assert vr[b, 1] >= vals[:, j].max() - 1e-6


def test_torch_device_scene_windows_and_latlon(scenes):
    """The plain passes over an index window equal the same rows of the
    whole scene; the corner lat/lon are those of the oriented corners
    (within 5e-7 of the host synthesizer's, which normalizes through
    einsum)."""
    from icon_rt_tpu_torch.data import device_scene as ds
    sc, _, td, _ = scenes
    c = ds._Consts(SUBDIV, LAYERS, float(td.stats.spherical_bounds_lo[0]),
                   3.0e4, "cpu")
    lo, hi = float(td.cells.value_lo), float(td.cells.value_hi)
    t12, vq, _, _, lat, lon = ds.scene_window(
        c, N - 100, 100, lo, float(ds.quant_scale(lo, hi)), latlon=True)
    assert torch.equal(t12, td.cells.test12[N - 100:])
    assert torch.equal(vq, td.cells.value_q[N - 100:])
    assert torch.equal(lat, td.lat[N - 100:])
    assert torch.equal(lon, td.lon[N - 100:])
    np.testing.assert_allclose(td.lat.numpy(), sc.lat, rtol=0, atol=5e-7)
    with pytest.raises(ValueError):
        ds.scene_pass1(c, start=N - 10, count=11)


@pytest.mark.parametrize("s,d", [(2, 0), (3, 0), (4, 1), (5, 0), (5, 2),
                                 (5, 5)])
def test_torch_cell_corners_resume_from_ancestors(s, d):
    """The ancestor identity K7-scene's walk rests on: cell i's corners are
    its depth-d ancestor's (cell i % (20 * 4**d)) walked along the
    remaining s - d digits, bit for bit (d = 0: the base faces; d = s: the
    cells themselves)."""
    from icon_rt_tpu_torch.data import device_scene as ds
    base = torch.from_numpy(ds._base_triangles())
    idx = torch.arange(20 * 4 ** s, dtype=torch.int64)
    want = ds._cell_corners(idx, s, base)
    anc = torch.stack(ds._cell_corners(
        torch.arange(20 * 4 ** d, dtype=torch.int64), d, base), dim=1)
    got = ds._cell_corners_from(anc, idx, d, s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def scenes4():
    """JAX's device build of a subdivision-4 scene (ancestors of depth 1,
    80 of them) and the port's plain whole build."""
    jd = jdevice(4, LAYERS, chunk_cells=1024)
    td = synth_quantized_device(4, LAYERS, device="cpu", latlon=True)
    return interop.device_scene(jd, 20 * 4 ** 4), td


@pytest.mark.parametrize("where", ["head", "ancestor period", "tail"])
def test_torch_scene_split_windows_match_jax(scenes4, where):
    """The pass split's plain versions over index windows that start at 0,
    straddle the ancestor table's period and end at the last cell: pass 1
    and pass 2 of the window equal the whole build's rows bit for bit
    (test12, value_q, lat/lon), the window's aggregates bound the whole
    scene's, and the rows match JAX's device build as the whole scene's
    do (test12 within the geometry test's tolerance, u8 levels within
    1)."""
    from icon_rt_tpu_torch.data import device_scene as ds
    jd, td = scenes4
    c = ds._Consts(4, LAYERS, float(td.stats.spherical_bounds_lo[0]), 3.0e4,
                   "cpu")
    assert (c.anc_depth, c.n_anc) == (1, 80)
    count = 60
    start = {"head": 0, "ancestor period": c.n_anc - count // 2,
             "tail": c.n - count}[where]
    lo, hi = float(td.cells.value_lo), float(td.cells.value_hi)
    p1 = ds._scene_pass1_torch(c, start, count, True)
    agg = p1.agg.tolist()
    whole = dict(zip(ds.AGG, (lo, hi)))
    assert agg[0] >= whole["v_min"] and agg[1] <= whole["v_max"]
    t12, vq, qmin, qmax, lat, lon = ds._scene_pass2_torch(
        c, p1, lo, float(ds.quant_scale(lo, hi)))
    rows = slice(start, start + count)
    assert torch.equal(t12, td.cells.test12[rows])
    assert torch.equal(vq, td.cells.value_q[rows])
    assert torch.equal(lat, td.lat[rows]) and torch.equal(lon, td.lon[rows])
    assert torch.equal(qmin, vq[:, :LAYERS].amin(0).int())
    assert torch.equal(qmax, vq[:, :LAYERS].amax(0).int())
    want = jd.cells.test12.numpy()[rows]
    np.testing.assert_allclose(t12.numpy()[:, :9], want[:, :9], rtol=2e-5,
                               atol=2e-2 * np.abs(want[:, :9]).max())
    dv = np.abs(vq.numpy().astype(int)
                - jd.cells.value_q.numpy()[rows].astype(int))
    assert dv.max() <= 1


def test_torch_device_scene_field_lod_raises():
    """The mip tier is built for field_lod >= 0 (tests/test_torch_lod.py);
    a negative level, and a build_q_scene level that leaves no geometry,
    raise."""
    with pytest.raises(ValueError, match="field_lod"):
        synth_quantized_device(2, 4, field_lod=-1, device="cpu")
    with pytest.raises(ValueError, match="field_lod"):
        bigscene.build_q_scene(2, 4, device="cpu", field_lod=2)


def _bins_equal(loc, want, k_want):
    assert loc.bins.shape[1] == k_want
    assert torch.equal(loc.bins, want.bins)
    for f in ("lat_lo", "lat_hi", "lon_lo", "lon_hi", "dims"):
        assert torch.equal(getattr(loc, f), getattr(want, f)), f


@pytest.mark.parametrize("dims_scale", [1.0, 0.5, 0.25])
def test_torch_bin_locator_equals_jax_host_binning(scenes, dims_scale):
    """The plain binning of JAX's host-scene lat/lon equals JAX's
    build_locator_csr_from_scene bins bit for bit: k_cap, window, dims.
    k_cap is 17, 34 and 88: rows of up to 32 ids, past 32, and too wide
    for K7-loc's rows in shared memory."""
    sc = scenes[0]
    jloc, jk = jbig.build_locator_csr_from_scene(sc, dims_scale=dims_scale)
    want = interop.locator_packed(jloc, jk)
    loc, k = bigscene.build_locator_csr_from_scene(sc, dims_scale=dims_scale)
    assert k == jk
    _bins_equal(loc, want, jk)


@pytest.mark.parametrize("sub", [1, 2])
def test_torch_bin_locator_equals_numpy_binning(sub):
    """On icospheres with pole cells (all longitude bins of their rows) and
    dateline straddlers (two longitude ranges): the plain rectangles equal
    `_range_records`'s records and the bins equal densify_csr(
    build_locator_csr(...)) of the host path (numpy and native/)."""
    sc = bigscene.synth_quantized(sub, 3)

    class _LatLon:
        lat, lon, num_cells = sc.lat, sc.lon, sc.num_cells

    csr, k_want = locator.build_locator_csr(_LatLon)
    want = locator.densify_csr(csr, k_want)
    loc, k, counts, rect = locator.bin_locator(torch.from_numpy(sc.lat),
                                               torch.from_numpy(sc.lon))
    assert k == k_want
    _bins_equal(loc, want, k_want)
    n_lat, n_lon = csr.dims
    rec = locator._range_records(_LatLon, n_lat, n_lon, csr.lat_lo,
                                 csr.lat_hi, csr.lon_lo, csr.lon_hi)
    r = rect.numpy().astype(np.int64)
    mine = np.concatenate([np.c_[np.arange(len(r)), r[:, :4]],
                           np.c_[np.arange(len(r)), r[:, 4:]]])
    mine = mine[mine[:, 1] >= 0]
    mine = mine[np.lexsort(mine.T[::-1])]
    np.testing.assert_array_equal(mine, rec[np.lexsort(rec.T[::-1])])
    pole = (r[:, 2] == 0) & (r[:, 3] == n_lon - 1)
    assert pole.any() and (r[:, 4] >= 0).any()
    np.testing.assert_array_equal(counts.numpy(), csr.counts)


def _camera_lp(stats, w, dist=2.2):
    cam = Camera()
    cam.set_aspect(1.0)
    c = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    v = np.array([2.2, 0.4, 0.9], np.float32)
    v /= np.linalg.norm(v)
    cam.set_orientation(c + v * float(stats.spherical_bounds_hi[0]) * dist,
                        c, np.array([0, 0, 1], np.float32), cam.fovy)
    return jmake_lp(cam.basis(w, w), stats.world_bounds_lo,
                    stats.world_bounds_hi, unit_distance=3e3)


def test_torch_fastq_on_jax_device_tables(scenes):
    """render_frame_fast_q on JAX's device-built tables (through
    interop.device_scene), JAX's host-binned locator and fine map, per
    pixel against JAX's render of the same tables: fb within test_torch_
    fastq.py's bound, accum within 2.4e-7 where fb agrees (TF range off the
    value grid)."""
    sc, jd_port, _, jd = scenes
    w = 48
    st = jd.stats
    vlo, vhi = (float(v) for v in st.data_range)
    pad = 0.0123 * (vhi - vlo)
    tf = jmake_tf(value_range=(vlo - pad, vhi + 0.7 * pad))
    q = jbake(jd.cells, tf)
    bands = jmajorants(jd.bands, tf.values, tf.value_range)
    jloc, k = jbig.build_locator_csr_from_scene(sc)
    fm = jbuild_finemap(jloc, q.test12, k, factor=2)
    lp = _camera_lp(st, w, 1.3)
    perm, n_act = jpixel_order(lp, st.spherical_bounds_lo[0],
                               st.spherical_bounds_hi[0], w, w)
    aj, fj = jrender_q(q, jloc, k, bands, tf, lp, *jalloc(w, w), width=w,
                       height=w, pixel_perm=jnp.asarray(perm),
                       n_active=n_act, samples=4, finemap=fm)
    tq = bake_alpha_q(jd_port.cells, interop.transfunc(tf))
    at, ft = render_frame_fast_q(
        tq, interop.locator_packed(jloc, k), interop.radial_bands(bands),
        interop.transfunc(tf), interop.launch_params(lp), *alloc_frame(w, w),
        width=w, height=w, pixel_perm=torch.from_numpy(perm),
        n_active=n_act, samples=4, finemap=interop.finemap(fm))
    fj, ft = np.asarray(fj), ft.numpy().view(np.uint32)
    mism = fj != ft
    assert (fj != 0).sum() > 100
    assert mism.sum() <= FB_MISMATCH_BOUND, mism.sum()
    far = np.abs(np.asarray(aj) - at.numpy()).max(1) > 2.4e-7
    assert not far[~mism].any()


def test_torch_build_q_scene_renders_like_jax(scenes, tmp_path, monkeypatch):
    """The slice as a whole: build_q_scene on the CPU (device scene, bake,
    majorants, locator from the scene's own corners, fine map) renders the
    image JAX's bench scene (its device scene, a locator binned from its
    host scene, its fine map) renders: coverage agreement > 0.98 and mean
    |accum difference| < 0.05 where both cover, as test_device_scene.py
    holds JAX's device scene to its host scene.  A second build loads the
    locator and the fine map from the cache."""
    sc, _, _, jd = scenes
    monkeypatch.setattr(bigscene, "CACHE_DIR", str(tmp_path))
    out = bigscene.build_q_scene(SUBDIV, LAYERS, device="cpu", cache=True,
                                 timings={})
    q, loc, k, bands, tf, stats, fm, lod, eff = out
    assert (lod, eff) == (0, SUBDIV)
    assert q.alpha_tab is not None and fm is not None
    w = 32
    lp = _camera_lp(stats, w)
    at, _ = render_frame_fast_q(q, loc, bands, tf, interop.launch_params(lp),
                                *alloc_frame(w, w), width=w, height=w,
                                samples=4, finemap=fm)
    jtf = jmake_tf(value_range=tuple(jd.stats.data_range))
    jq = jbake(jd.cells, jtf)
    jloc, jk = jbig.build_locator_csr_from_scene(sc)
    aj, _ = jrender_q(jq, jloc, jk, jmajorants(jd.bands, jtf.values,
                                               jtf.value_range), jtf, lp,
                      *jalloc(w, w), width=w, height=w, samples=4,
                      finemap=jbuild_finemap(jloc, jq.test12, jk, factor=2))
    a, b = at.numpy(), np.asarray(aj)
    cov_a, cov_b = a[:, 3] > 0, b[:, 3] > 0
    assert cov_a.any() and (cov_a == cov_b).mean() > 0.98
    both = cov_a & cov_b
    assert np.abs(a[both] - b[both]).mean() < 0.05

    again = bigscene.build_q_scene(SUBDIV, LAYERS, device="cpu",
                                   cache=True)
    assert again[2] == k and torch.equal(again[1].bins, loc.bins)
    assert torch.equal(again[6].slots, fm.slots)


def test_torch_finemap_rejects_grid_past_int32():
    """The fine-map build refuses a grid whose fine bin ids overflow the
    trackers' 32-bit ids (a fake 40000 x 40000 locator at factor 2)."""
    f32 = torch.tensor(0.0)
    loc = locator.Locator(bins=torch.full((1, 4), -1, dtype=torch.int32),
                          lat_lo=f32, lat_hi=f32, lon_lo=f32, lon_hi=f32,
                          dims=torch.tensor([40000, 40000],
                                            dtype=torch.int32))
    with pytest.raises(ValueError, match="32-bit fine bin ids"):
        finemap.finemap_slots(loc, torch.zeros((1, 12)), factor=2)
