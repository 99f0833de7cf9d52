"""PyTorch port, the kernels on the card: K1+K4, K5a, K5b, K6 (ragged
sizes too), K2 (K1 and K2 also on ragged columns with rays grazing a
ceiling), K5c-q (into a
new table and in place, vector tails, zero size, the TF-edit dispatch),
K7-fm (factors 1-3, cut edge tiles, a band locator), K3 (both tiers; K3-q
after TF edits and its steady call without a host read), K5c-f32,
K7-scene (lod 0 and the mip tier, whole and windows), K7-loc, K8 (and its raw
mode; rays grazing the cells' shell top; its steady launch without a
host read) and K6b (refine_perm's prefix tails with int32 and int64
order), K1's, K2's and K3's cost output, K1's and
K2's raw mode (with rng_salt), the
unstructured elements' K9-w, K9-p and K9-n (ragged sizes, out=,
NaN scalars outside, 2,073,600 wedge points), and the multi-device
composites K10, against their plain PyTorch versions on the same CUDA
inputs.  Marked `cuda`: they
skip where no GPU is present (CUDA and Triton kernels have no CPU mode).
On a GPU machine:  python -m pytest --noconftest tests/test_torch_kernels_cuda.py"""
import numpy as np
import pytest
import torch

from icon_rt_tpu_torch.data import synthetic
from icon_rt_tpu_torch.data.icfile import ICDataset
from icon_rt_tpu_torch.models import accel
from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
from icon_rt_tpu_torch.models.locator import build_locator
from icon_rt_tpu_torch.models.shells import (build_radial_bands,
                                             update_band_majorants)
from icon_rt_tpu_torch.models.transfunc import make_transfunc
from icon_rt_tpu_torch.models import finemap, qcells
from icon_rt_tpu_torch.models.locator import build_locator_csr, densify_csr
from icon_rt_tpu_torch.ops import composite, fast, fastq, march, order
from icon_rt_tpu_torch.ops.camera import Camera
from icon_rt_tpu_torch.ops.render import alloc_frame, make_launch_params

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scene(dev):
    ds = synthetic.icosphere(4, 8)
    st = compute_stats(ds)
    cells = build_cells(ds, device=dev)
    loc = build_locator(ds, device=dev)
    tf = make_transfunc(value_range=tuple(st.data_range), opacity_scale=0.7,
                        device=dev)
    bands = update_band_majorants(build_radial_bands(ds, 64, device=dev),
                                  tf.values, tf.value_range)
    packed = fast.pack_cells(cells, tf)
    cam = Camera()
    c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    v = np.array([2.2, 0.4, 0.9], np.float32)
    v /= np.linalg.norm(v)
    cam.set_orientation(c + v * st.spherical_bounds_hi[0] * 1.6, c,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(96, 96), st.world_bounds_lo,
                            st.world_bounds_hi, unit_distance=1e3,
                            device=dev)
    perm, n_cov = order.pixel_order(lp, st.spherical_bounds_lo[0],
                                    st.spherical_bounds_hi[0], 96, 96)
    return dict(st=st, cells=cells, loc=loc, tf=tf, bands=bands,
                packed=packed, lp=lp, perm=perm, n_cov=n_cov)


def test_cuda_classify_bake_matches_plain(scene):
    """K5a: bitwise (both round every operation; no FMA contraction)."""
    c = scene["cells"]
    before = fast.launches["classify_bake"]
    prof, rgb = fast.classify_bake(c, scene["tf"])
    assert fast.launches["classify_bake"] == before + 1
    p_prof, p_rgb = fast._profile_rows_torch(c.height, c.value, c.num_layers,
                                             scene["tf"])
    assert torch.equal(prof, p_prof) and torch.equal(rgb, p_rgb)


#: K5b's LUT sizes: the smallest, the app's default 300, the largest whose
#: sparse table a block keeps in shared memory (1117 at 11 levels; 1024
#: here) and one past it (the table in global memory)
K5B_SIZES = [1, 2, 3, 300, 1024, 4096]


def _k5b_ranges(kind, scene, pscene, dev):
    """(M, 2) value ranges of one K5b case: the radial bands, random ranges
    with empty rows, the grid accel's 256^3 bins (mostly empty) or rows
    with +-inf, NaN and +-f32-max ends."""
    if kind == "bands":
        return scene["bands"].value_ranges
    if kind == "grid":
        return pscene["accels"]["grid"].value_ranges
    rng = np.random.default_rng(2)
    if kind == "random":
        lo = rng.uniform(-0.2, 1.1, 70_000).astype(np.float32)
        hi = lo + rng.uniform(-0.1, 0.6, lo.size).astype(np.float32)
    else:
        ends = np.array([np.inf, -np.inf, np.nan, np.finfo(np.float32).max,
                         -np.finfo(np.float32).max, 0.0, 0.5, 1.0],
                        np.float32)
        lo, hi = (a.ravel() for a in np.meshgrid(ends, ends))
    return torch.from_numpy(np.stack([lo, hi], axis=1)).to(dev)


@pytest.mark.parametrize("size", K5B_SIZES)
@pytest.mark.parametrize("kind", ["bands", "random", "grid", "special"])
def test_cuda_max_opacity_matches_plain(scene, pscene, dev, size, kind):
    """K5b: exact against the plain version on the card (both convert
    float to int alike there), for each LUT size and kind of ranges, with
    a random LUT and, at the app's size, the scene's own."""
    vr = _k5b_ranges(kind, scene, pscene, dev)
    luts = [torch.from_numpy(np.random.default_rng(size).random(
        (size, 4), np.float32)).to(dev)]
    if size == scene["tf"].values.shape[0]:
        luts.append(scene["tf"].values)
    for lut in luts:
        for trange in (scene["tf"].value_range,
                       torch.tensor([0.1, 0.9], device=dev)):
            before = accel.launches
            got = accel.max_opacity(vr, lut, trange)
            assert accel.launches == before + 1
            want = accel.compute_max_opacities_torch(vr, lut, trange)
            assert torch.equal(got, want)


def _chord_keys_both(cam, st, width, height, dev):
    """K6 (csrc/order.cu) and its plain version on the same camera: ((keys,
    count) of each), one launch counted."""
    r_in, r_out = st.spherical_bounds_lo[0], st.spherical_bounds_hi[0]
    before = order.launches
    got = order.chord_keys(cam, r_in, r_out, width, height)
    assert order.launches == before + 1
    f32 = lambda r: torch.tensor(float(np.float32(r)), device=dev)
    want = order._chord_keys_torch(cam, f32(r_in), f32(r_out), width, height)
    return got, want


def _assert_keys_close(got, want):
    """Same coverage, the same count, finite keys within 1 ULP."""
    (k, n), (p, m) = got, want
    fin = torch.isfinite(p)
    assert torch.equal(torch.isfinite(k), fin)
    assert n.dtype == torch.int32 and torch.equal(n, m)
    assert int(n) == int(fin.sum())
    ik = k[fin].view(torch.int32).long()
    ip = p[fin].view(torch.int32).long()
    assert not fin.any() or int((ik - ip).abs().max()) <= 1


def test_cuda_chord_keys_match_plain(scene, dev):
    """K6: same coverage and covered count, finite keys within 1 ULP; the
    count equals pixel_order's n_covered."""
    st, lp = scene["st"], scene["lp"]
    got, want = _chord_keys_both(order._camera(lp), st, 96, 96, dev)
    _assert_keys_close(got, want)
    assert int(got[1]) == scene["n_cov"] > 0


#: K6's ragged sizes: W*H % 4 == 1 (97 x 33, 1 x 1, 45 x 29), 2 (46 x 29)
#: and 3 (47 x 29) leave the last thread a tail of single pixels
@pytest.mark.parametrize("width,height", [(97, 33), (1, 1), (45, 29),
                                          (46, 29), (47, 29)])
def test_cuda_chord_keys_ragged_match_plain(scene, dev, width, height):
    """K6 at sizes whose pixel count is no multiple of its 4 pixels a
    thread: coverage, count and keys as test_cuda_chord_keys_match_plain,
    on a camera at 1.6 outer radii looking at the globe (one pixel: its
    central ray's view of it)."""
    st = scene["st"]
    cam = Camera()
    cam.set_aspect(width / height)
    c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    v = np.array([2.2, 0.4, 0.9], np.float32)
    v /= np.linalg.norm(v)
    cam.set_orientation(c + v * st.spherical_bounds_hi[0] * 1.6, c,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(width, height), st.world_bounds_lo,
                            st.world_bounds_hi, device=dev)
    got, want = _chord_keys_both(order._camera(lp), st, width, height, dev)
    assert got[0].shape == (width * height,)
    _assert_keys_close(got, want)
    assert order.pixel_order(lp, st.spherical_bounds_lo[0],
                             st.spherical_bounds_hi[0], width,
                             height)[1] == int(want[1])


@pytest.mark.parametrize("preserve_cache", [True, False])
def test_cuda_track_f32_matches_plain(scene, preserve_cache):
    """K1+K4: fb identical on >= 99.9% of lanes, accum within 1e-6."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    outs = []
    for kernel in (True, False):
        acc, fb = alloc_frame(96, 96, device=pix.device)
        args = (scene["packed"], scene["loc"], scene["bands"], scene["lp"],
                pix, acc[:n], fb[:n])
        if kernel:
            fast.track_f32(*args, width=96, height=96, samples=4,
                           preserve_cache=preserve_cache)
        else:
            fast._render_frame_fast_torch(*args, 96, 96, 4, preserve_cache)
        torch.cuda.synchronize()
        outs.append((acc, fb))
    (ak, fk), (ap, fp) = outs
    assert (fk == fp).float().mean() >= 0.999
    assert float((ak - ap).abs().max()) <= 1e-6


def test_cuda_track_f32_samples_n_equals_sequential(scene):
    """The kernel's samples=N contract: bitwise with preserve_cache=False."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    lp = scene["lp"]
    tabs = (scene["packed"], scene["loc"], scene["bands"])
    a1, f1 = alloc_frame(96, 96, device=pix.device)
    for s in range(4):
        fast.track_f32(*tabs, lp._replace(accum_id=torch.tensor(
            s, dtype=torch.int32)), pix, a1[:n], f1[:n], width=96, height=96)
    a2, f2 = alloc_frame(96, 96, device=pix.device)
    fast.track_f32(*tabs, lp, pix, a2[:n], f2[:n], width=96, height=96,
                   samples=4, preserve_cache=False)
    assert torch.equal(a1, a2) and torch.equal(f1, f2)


@pytest.fixture(scope="module")
def qscene(dev, scene):
    """The quantized tier of the same icosphere, as the app builds it."""
    ds_q, lo, hi = qcells.quantize_dataset_values(synthetic.icosphere(4, 8))
    q = qcells.quantize_cells(ds_q, value_range=(lo, hi), device=dev)
    q = qcells.bake_alpha_q(q, scene["tf"])
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap, device=dev)
    return dict(q=q, loc=loc, fm=finemap.build_finemap(loc, q.test12))


def test_cuda_build_finemap_matches_plain(qscene):
    """K7-fm: the u8 slots exactly equal to the plain version's."""
    before = finemap.launches
    fm = qscene["fm"]
    slots = finemap.finemap_slots(qscene["loc"], qscene["q"].test12)
    assert finemap.launches == before + 1
    want = finemap._build_finemap_torch(qscene["loc"], qscene["q"].test12)
    assert torch.equal(slots, want) and torch.equal(fm.slots, want)


def _finemap_matches(loc, test12, factor):
    before = finemap.launches
    slots = finemap.finemap_slots(loc, test12, factor)
    assert finemap.launches == before + 1
    want = finemap._build_finemap_torch(loc, test12, factor)
    assert slots.shape == want.shape and torch.equal(slots, want)
    fb = torch.arange(want.shape[0], device=want.device)
    assert torch.equal(finemap._finemap_bins_torch(loc, test12, factor, fb),
                       want)


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_cuda_build_finemap_factors_match_plain(qscene, factor):
    """K7-fm at factors 1-3 on the subdivision-4 locator (50 x 50 coarse
    bins: fine grids of 50-150 bins a side, no multiple of the kernel's
    16 x 32 tile, so every row and column of tiles has a cut edge tile):
    the slots byte-equal to the plain version's, and to the sampled-bin
    plain version on every bin."""
    loc = qscene["loc"]
    assert loc.dims.tolist() == [50, 50]
    _finemap_matches(loc, qscene["q"].test12, factor)


@pytest.mark.parametrize("factor", [1, 2])
def test_cuda_build_finemap_band_locator_matches_plain(scene5, factor):
    """K7-fm over a locator binned from a latitude band of cells only
    (corners within [-0.5, 0.7] rad of the subdivision-5 scene), so that
    its clamped edge rows lie inside the sphere, not at the poles, and
    over the whole scene's locator at a quarter of its bins (k_cap 92:
    the launcher halves the tile to fit shared memory at factor 1)."""
    from icon_rt_tpu_torch.data import device_scene as ds
    from icon_rt_tpu_torch.models import locator
    p1 = ds.scene_pass1(scene5, latlon=True)
    lo, hi = float(p1.agg[0]), float(p1.agg[1])
    test12, _, _, _, lat, lon = ds.scene_pass2(
        scene5, p1, lo, float(ds.quant_scale(lo, hi)))
    band = ((lat >= -0.5) & (lat <= 0.7)).all(1)
    t_band = test12[band].contiguous()
    loc = locator.bin_locator(lat[band].contiguous(),
                              lon[band].contiguous())[0]
    assert -1.0 < float(loc.lat_lo) and float(loc.lat_hi) < 1.0
    _finemap_matches(loc, t_band, factor)
    loc_q, k_cap = locator.bin_locator(lat, lon, dims_scale=0.25)[:2]
    assert k_cap > 64
    _finemap_matches(loc_q, test12, factor)


def _bake_forms(vq, aq, tab):
    """{form: (kernel output, plain output)} of K5c-q's lookup on the same
    inputs, into a new table and into a copy of aq (out=)."""
    into = aq.clone()
    out = {"lookup": (qcells.bake_lookup(vq, tab),
                      qcells._bake_lookup_torch(vq, tab)),
           "lookup_out": (qcells.bake_lookup(vq, tab, out=into),
                          qcells._bake_lookup_torch(vq, tab))}
    assert out["lookup_out"][0] is into
    return out


@pytest.mark.parametrize("form", ["lookup", "lookup_out"])
def test_cuda_bake_alpha_q_matches_plain(qscene, dev, form):
    """K5c-q (csrc/bake_q.cu): u8 tables exactly equal to the plain
    version's on the scene's value table (a random table, into a new
    table and into a given one), and the launch counted once a call."""
    rng = np.random.default_rng(1)
    q = qscene["q"]
    tab = torch.from_numpy(rng.integers(0, 256, 256, dtype=np.uint8)).to(dev)
    before = qcells.launches["bake_lookup"]
    got, want = _bake_forms(q.value_q, q.alpha_q, tab)[form]
    assert torch.equal(got, want)
    assert qcells.launches["bake_lookup"] - before == 2


@pytest.mark.parametrize("donate", [False, True], ids=["base", "donated"])
@pytest.mark.parametrize("edit", ["patch", "lookup"])
def test_cuda_bake_alpha_q_edit_matches_cpu(scene, qscene, edit, donate):
    """bake_alpha_q on the card after a TF edit (patch: one LUT alpha
    halved, <= 32 levels changed; lookup: the lower half made
    transparent) equals the same edit on CPU copies: one launch of the
    lookup, into q.alpha_q's storage when donated (a copy here), else
    into a new table that leaves q.alpha_q as it was."""
    q = qscene["q"]._replace(alpha_q=qscene["q"].alpha_q.clone())
    lut = scene["tf"].values.clone()
    if edit == "patch":
        lut[lut.shape[0] // 2, 3] *= 0.5
    else:
        lut[: lut.shape[0] // 2, 3] = 0.0
    tf2 = scene["tf"]._replace(values=lut)
    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    want = qcells.bake_alpha_q(type(q)(*map(cpu, q)),
                               type(tf2)(*map(cpu, tf2)))
    keep = q.alpha_q.clone()
    before = qcells.launches["bake_lookup"]
    got = qcells.bake_alpha_q(q, tf2, donate=donate)
    assert qcells.launches["bake_lookup"] - before == 1
    changed = (got.alpha_tab != q.alpha_tab).sum()
    assert (0 < changed <= 32) == (edit == "patch")
    assert torch.equal(got.alpha_q.cpu(), want.alpha_q)
    np.testing.assert_array_equal(got.alpha_tab, want.alpha_tab)
    assert (got.alpha_q.data_ptr() == q.alpha_q.data_ptr()) == donate
    if not donate:
        assert torch.equal(q.alpha_q, keep)


@pytest.mark.parametrize("rows,lm", [(0, 8), (1, 8), (3, 8), (1001, 8),
                                     (257, 24), (4099, 16)])
def test_cuda_bake_q_tails_match_plain(dev, rows, lm):
    """K5c-q's lookup on random tables whose byte count leaves a tail past
    the last 16-byte vector (rows x Lm a multiple of 8, not of 16), and at
    zero size: byte-equal to the plain version, into a new table and in
    place."""
    rng = np.random.default_rng(rows * 7 + lm)
    vq = torch.from_numpy(rng.integers(0, 256, (rows, lm), dtype=np.uint8)
                          ).to(dev)
    aq = torch.from_numpy(rng.integers(0, 256, (rows, lm), dtype=np.uint8)
                          ).to(dev)
    tab = torch.from_numpy(rng.integers(0, 256, 256, dtype=np.uint8)).to(dev)
    for form, (got, want) in _bake_forms(vq, aq, tab).items():
        assert got.shape == (rows, lm) and torch.equal(got, want), form


def test_cuda_bake_q_refuses_unaligned(dev):
    """The kernels move 16 bytes a load: a table that does not start on a
    16-byte boundary is refused, not read."""
    vq = torch.zeros(64 * 8 + 8, dtype=torch.uint8, device=dev)[8:]
    tab = torch.zeros(256, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        qcells.bake_lookup(vq.view(64, 8), tab)


@pytest.mark.parametrize("use_fm", [True, False],
                         ids=["finemap", "no_finemap"])
@pytest.mark.parametrize("preserve_cache", [True, False])
def test_cuda_track_q_matches_plain(scene, qscene, use_fm, preserve_cache):
    """K2: fb identical on >= 99.9% of lanes, accum within 1e-6."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    fm = qscene["fm"] if use_fm else None
    outs = []
    for kernel in (True, False):
        acc, fb = alloc_frame(96, 96, device=pix.device)
        args = (qscene["q"], qscene["loc"], scene["bands"], scene["tf"],
                scene["lp"], pix, acc[:n], fb[:n])
        if kernel:
            fastq.track_q(*args, width=96, height=96, samples=4,
                          preserve_cache=preserve_cache, finemap=fm)
        else:
            fastq._render_frame_fast_q_torch(*args, 96, 96, 4,
                                             preserve_cache, fm)
        torch.cuda.synchronize()
        outs.append((acc, fb))
    (ak, fk), (ap, fp) = outs
    assert (fk == fp).float().mean() >= 0.999
    assert float((ak - ap).abs().max()) <= 1e-6


@pytest.mark.parametrize("accum_id", [0, 3])
def test_cuda_march_f32_matches_plain(scene, accum_id):
    """K3-f32: fb identical on >= 99.9% of lanes, accum within 1e-6 (the
    kernel follows the plain version's loop order; bit-equal is the aim)."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    lp = scene["lp"]._replace(accum_id=torch.tensor(
        accum_id, dtype=torch.int32, device=pix.device))
    outs = []
    for kernel in (True, False):
        acc, fb = alloc_frame(96, 96, device=pix.device)
        args = (scene["packed"], scene["loc"], scene["bands"], lp, pix,
                acc[:n], fb[:n])
        before = march.launches["march_f32"]
        if kernel:
            march.march_f32(*args, width=96, height=96)
            assert march.launches["march_f32"] == before + 1
        else:
            march._march_frame_torch(
                fast._F32Tier(scene["packed"], scene["loc"]),
                scene["bands"], lp, pix, acc[:n], fb[:n], 96, 96)
        torch.cuda.synchronize()
        outs.append((acc, fb))
    (ak, fk), (ap, fp) = outs
    assert (fk == fp).float().mean() >= 0.999
    assert float((ak - ap).abs().max()) <= 1e-6


@pytest.mark.parametrize("use_fm", [True, False],
                         ids=["finemap", "no_finemap"])
def test_cuda_march_q_matches_plain(scene, qscene, use_fm):
    """K3-q: fb identical on >= 99.9% of lanes, accum within 1e-6."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    fm = qscene["fm"] if use_fm else None
    outs = []
    for kernel in (True, False):
        acc, fb = alloc_frame(96, 96, device=pix.device)
        tabs = (qscene["q"], qscene["loc"], scene["bands"], scene["tf"])
        if kernel:
            march.march_q(*tabs, scene["lp"], pix, acc[:n], fb[:n],
                          width=96, height=96, finemap=fm)
        else:
            march._march_frame_torch(
                fastq._QTier(qscene["q"], qscene["loc"], scene["tf"], fm),
                scene["bands"], scene["lp"], pix, acc[:n], fb[:n], 96, 96)
        torch.cuda.synchronize()
        outs.append((acc, fb))
    (ak, fk), (ap, fp) = outs
    assert (fk == fp).float().mean() >= 0.999
    assert float((ak - ap).abs().max()) <= 1e-6


def _march_q_vs_plain(scene, qscene, tf, lp, fm=None):
    """K3-q and its plain version on the covered lanes: fb identical on
    >= 99.9%, accum within 1e-6."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    outs = []
    for kernel in (True, False):
        acc, fb = alloc_frame(96, 96, device=pix.device)
        if kernel:
            march.march_q(qscene["q"], qscene["loc"], scene["bands"], tf, lp,
                          pix, acc[:n], fb[:n], width=96, height=96,
                          finemap=fm)
        else:
            march._march_frame_torch(
                fastq._QTier(qscene["q"], qscene["loc"], tf, fm),
                scene["bands"], lp, pix, acc[:n], fb[:n], 96, 96)
        torch.cuda.synchronize()
        outs.append((acc, fb))
    (ak, fk), (ap, fp) = outs
    assert (fk == fp).float().mean() >= 0.999
    assert float((ak - ap).abs().max()) <= 1e-6
    return ak


@pytest.mark.parametrize("edit", ["lut in place", "new range"])
def test_cuda_march_q_after_tf_edit_matches_plain(scene, qscene, edit):
    """K3-q builds its code table from the live TF on the card: after a TF
    edit between two launches (the LUT rewritten in place, or a TF with a
    new value range) the next launch equals the plain version on the
    edited TF, and differs from the launch before the edit."""
    tf = make_transfunc(value_range=tuple(scene["tf"].value_range.tolist()),
                        device=scene["lp"].cam_org.device)
    before = _march_q_vs_plain(scene, qscene, tf, scene["lp"])
    if edit == "lut in place":
        tf.values.copy_(torch.flip(tf.values, dims=[0]))
    else:
        lo, hi = tf.value_range.tolist()
        tf = tf._replace(value_range=torch.tensor(
            [lo, lo + 0.5 * (hi - lo)], dtype=torch.float32,
            device=tf.values.device))
    after = _march_q_vs_plain(scene, qscene, tf, scene["lp"])
    assert float((after - before).abs().max()) > 1e-3


def test_cuda_march_q_steady_call_reads_nothing_back(scene, qscene):
    """A steady K3-q call (the tables, TF and camera of the call before it,
    a new accum_id) does no device-to-host read: it runs under
    torch.cuda.set_sync_debug_mode("error"); and a camera move and the new
    accum_id reach the launch (the frame equals the plain version's)."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    dev = pix.device
    tabs = (qscene["q"], qscene["loc"], scene["bands"], scene["tf"])
    acc, fb = (x[:n] for x in alloc_frame(96, 96, device=dev))
    lps = [scene["lp"]._replace(accum_id=torch.tensor(
        k, dtype=torch.int32, device=dev)) for k in range(3)]
    march.march_q(*tabs, lps[0], pix, acc, fb, width=96, height=96,
                  finemap=qscene["fm"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        march.march_q(*tabs, lps[1], pix, acc, fb, width=96, height=96,
                      finemap=qscene["fm"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    moved = lps[2]._replace(cam_org=lps[2].cam_org * 1.01)
    for lp in (lps[2], moved):
        _march_q_vs_plain(scene, qscene, scene["tf"], lp, qscene["fm"])


def test_cuda_march_f32_steady_call_reads_nothing_back(scene):
    """A steady K3-f32 call (the tables and camera of the call before it, a
    new accum_id) does no device-to-host read, and a camera move and the
    new accum_id reach the launch: its frames equal the plain version's
    (fb identical on >= 99.9% of lanes, accum within 1e-6, as
    `test_cuda_march_f32_matches_plain`) and the move changes them."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    dev = pix.device
    tabs = (scene["packed"], scene["loc"], scene["bands"])
    lps = [scene["lp"]._replace(accum_id=torch.tensor(
        k, dtype=torch.int32, device=dev)) for k in range(3)]
    lps.append(lps[2]._replace(cam_org=lps[2].cam_org * 1.01))
    acc, fb = (x[:n] for x in alloc_frame(96, 96, device=dev))
    march.march_f32(*tabs, lps[0], pix, acc, fb, width=96, height=96)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        march.march_f32(*tabs, lps[1], pix, acc, fb, width=96, height=96)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = []
    for lp in lps[2:]:
        ak, fk = alloc_frame(96, 96, device=dev)
        ap, fp = alloc_frame(96, 96, device=dev)
        march.march_f32(*tabs, lp, pix, ak[:n], fk[:n], width=96, height=96)
        march._march_frame_torch(fast._F32Tier(scene["packed"], scene["loc"]),
                                 scene["bands"], lp, pix, ap[:n], fp[:n], 96,
                                 96)
        torch.cuda.synchronize()
        assert (fk == fp).float().mean() >= 0.999
        assert float((ak - ap).abs().max()) <= 1e-6
        got.append(ak)
    assert float((got[1] - got[0]).abs().max()) > 1e-3


def test_cuda_opacity_scale_matches_plain(scene):
    """K5c-f32: parts and apply bitwise equal to the plain versions, and the
    scale-only re-bake bitwise equal to a full K5a bake at the new scale."""
    c, tf = scene["cells"], scene["tf"]
    parts = fast.pack_alpha_scale_parts(c, tf)
    want = fast._alpha_scale_parts_torch(c.value, tf)
    assert torch.equal(parts[0], want[0]) and torch.equal(parts[1], want[1])
    s = torch.full_like(tf.opacity_scale, 0.37)
    packed = fast.pack_cells(c, tf)
    prof_p = packed.prof.clone()
    fast.apply_opacity_scale(packed, parts, s)
    fast._apply_opacity_scale_torch(prof_p, *want, s)
    assert torch.equal(packed.prof, prof_p)
    full = fast.classify_bake(c, tf._replace(opacity_scale=s))[0]
    assert torch.equal(packed.prof, full)


@pytest.fixture(scope="module")
def scene5(dev):
    """K7-scene's consts of a subdivision-5 x 16 scene on the card."""
    from icon_rt_tpu_torch.data import device_scene
    return device_scene._Consts(5, 16, float(synthetic.EARTH_RADIUS), 3.0e4,
                                dev)


def _pass1_equal(got, want):
    """K7-scene pass 1 outputs bit-equal: aggregates, test12, lat/lon and
    the field (the w stash at lod 0, the pooled values otherwise)."""
    assert torch.equal(got.agg, want.agg)
    assert torch.equal(got.test12, want.test12)
    assert torch.equal(got.lat, want.lat) and torch.equal(got.lon, want.lon)
    if want.field is None:
        assert torch.equal(got.field_term(), want.field_term())
    else:
        assert torch.equal(got.field, want.field)


def _tables_match(got, want):
    """K7-scene pass 2 outputs: test12 and the corner lat/lon bit-equal,
    value_q within 1 level and exact on >= 99.999% of entries, the
    per-layer u8 ranges equal."""
    for k in (0, 4, 5):
        assert torch.equal(got[k], want[k])
    dv = (got[1].int() - want[1].int()).abs()
    assert int(dv.max()) <= 1 and float((dv == 0).float().mean()) >= 0.99999
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


def test_cuda_scene_matches_plain(scene5):
    """K7-scene: the ancestors' launch and pass 1's aggregates, test12
    rows, corner lat/lon and field stash bit-equal to the plain version's;
    pass 2's value_q within 1 level and exact on >= 99.999% of entries;
    the per-layer u8 ranges equal."""
    from icon_rt_tpu_torch.data import device_scene as ds
    c = scene5
    before = dict(ds.launches)
    p1 = ds.scene_pass1(c, latlon=True)
    p1p = ds._scene_pass1_torch(c, 0, c.n, True)
    _pass1_equal(p1, p1p)
    lo, hi = float(p1.agg[0]), float(p1.agg[1])
    scale = float(ds.quant_scale(lo, hi))
    got = ds.scene_pass2(c, p1, lo, scale)
    want = ds._scene_pass2_torch(c, p1p, lo, scale)
    assert ds.launches == {k: v + (not k.startswith("scene_lod"))
                           for k, v in before.items()}
    _tables_match(got, want)


@pytest.mark.parametrize("lod", [0, 3])
@pytest.mark.parametrize("where", ["head", "ancestor period", "tail"])
def test_cuda_scene_windows_match_plain(dev, lod, where):
    """K7-scene over index windows that start at 0, that straddle the
    ancestor table's period (cell n_anc, where the ancestors wrap) and that
    end at the last cell, at lod 0 (subdivision 5) and lod 3 (subdivision
    4, 64 descendants a cell): both passes bit-equal to the plain version's
    window, and the lod-0 windows equal to the same rows of the whole
    scene."""
    from icon_rt_tpu_torch.data import device_scene as ds
    sub = 5 if lod == 0 else 4
    c = ds._Consts(sub, 16, float(synthetic.EARTH_RADIUS), 3.0e4, dev,
                   lod=lod)
    count = 200 if lod == 0 else 64
    start = {"head": 0, "ancestor period": c.n_anc - count // 2,
             "tail": c.n - count}[where]
    assert 0 <= start and start + count <= c.n
    whole = ds.scene_pass1(c, latlon=True)
    lo, hi = float(whole.agg[0]), float(whole.agg[1])
    scale = float(ds.quant_scale(lo, hi))
    p1 = ds.scene_pass1(c, start, count, latlon=True)
    p1p = ds._scene_pass1_torch(c, start, count, True)
    _pass1_equal(p1, p1p)
    got = ds.scene_pass2(c, p1, lo, scale)
    _tables_match(got, ds._scene_pass2_torch(c, p1p, lo, scale))
    if lod == 0:
        rows = slice(start, start + count)
        assert torch.equal(got[0], whole.test12[rows])
        tabs = ds.scene_pass2(c, whole, lo, scale)
        assert torch.equal(got[1], tabs[1][rows])


@pytest.mark.parametrize("dims_scale,big_cap", [
    (1.0, None),    # k_cap 18; the two cells flagged with the far pole
    (0.5, None),    # k_cap 38: rows past 32 ids, still in shared memory
    (0.25, None),   # k_cap 92: rows too wide for shared memory
    (3.0, None),    # 303^2 bins: polar cells of more than kBigTiles tiles
    (1.0, 1),       # more cells of many tiles than the first list holds
])
def test_cuda_locator_bins_match_plain(scene5, monkeypatch, dims_scale,
                                       big_cap):
    """K7-loc: rectangles, counts, k_cap and the dense bins exactly equal
    to the plain version's on the subdivision-5 scene's corners."""
    from icon_rt_tpu_torch.data import device_scene as ds
    from icon_rt_tpu_torch.models import locator
    if big_cap is not None:
        monkeypatch.setattr(locator, "_BIG_CAP", big_cap)
    p1 = ds.scene_pass1(scene5, latlon=True)
    lo, hi = float(p1.agg[0]), float(p1.agg[1])
    _, _, _, _, lat, lon = ds.scene_pass2(
        scene5, p1, lo, float(ds.quant_scale(lo, hi)))
    before = dict(locator.launches)
    loc, k, counts, rect = locator.bin_locator(lat, lon,
                                               dims_scale=dims_scale)
    reruns = 1 if big_cap is not None else 0
    assert locator.launches == {
        k_: v + 1 + (reruns if k_ == "locator_rects" else 0)
        for k_, v in before.items()}
    n_lat, n_lon = (int(d) for d in loc.dims.tolist())
    window = locator.locator_window(lat, lon)
    assert window == locator._locator_window_torch(lat, lon)
    bins_p, k_p, counts_p, rect_p = locator._locator_bins_torch(
        lat, lon, n_lat, n_lon, window)
    assert k == k_p
    assert torch.equal(rect, rect_p) and torch.equal(counts, counts_p)
    assert torch.equal(loc.bins, bins_p)


@pytest.mark.parametrize("case", ["one", "signed zeros", "nan lat",
                                  "nan lon"])
def test_cuda_locator_window_matches_plain(dev, case):
    """K7-loc's window (one read of both arrays): equal to torch's min and
    max, NaN where torch's is, on random corners."""
    from icon_rt_tpu_torch.models import locator
    rng = np.random.default_rng(5)
    n = 1 if case == "one" else 300_001
    lat = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    lon = rng.uniform(-3.1, 3.1, (n, 3)).astype(np.float32)
    if case == "signed zeros":
        lat[lat > 0] = 0.0
        lon[lon < 0] = -0.0
    if case.startswith("nan"):
        (lat if case == "nan lat" else lon)[n // 2, 1] = np.nan
    lat, lon = torch.from_numpy(lat).to(dev), torch.from_numpy(lon).to(dev)
    before = locator.launches["locator_window"]
    got = locator.locator_window(lat, lon)
    assert locator.launches["locator_window"] == before + 1
    np.testing.assert_array_equal(got, locator._locator_window_torch(lat,
                                                                     lon))


@pytest.fixture(scope="module")
def pscene(dev):
    """The parity raygens' tables at subdiv 3 x 8: cells, locator, both
    accels with their majorants, and a 64x64 closeup-like frame."""
    from icon_rt_tpu_torch.models.accel import (build_grid_accel,
                                                build_shell_accel,
                                                update_majorants)
    ds = synthetic.icosphere(3, 8)
    st = compute_stats(ds)
    tf = make_transfunc(value_range=tuple(st.data_range), opacity_scale=0.7,
                        device=dev)
    accels = {
        "sphere": build_shell_accel(ds, st.spherical_bounds_lo,
                                    st.spherical_bounds_hi, device=dev),
        "grid": build_grid_accel(ds, st.world_bounds_lo, st.world_bounds_hi,
                                 device=dev)}
    accels = {k: update_majorants(a, tf.values, tf.value_range)
              for k, a in accels.items()}
    cam = Camera()
    c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    v = np.array([2.2, 0.4, 0.9], np.float32)
    v /= np.linalg.norm(v)
    cam.set_orientation(c + v * st.spherical_bounds_hi[0] * 1.6, c,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(64, 64), st.world_bounds_lo,
                            st.world_bounds_hi, unit_distance=1e3,
                            device=dev)
    return dict(cells=build_cells(ds, device=dev),
                loc=build_locator(ds, device=dev), tf=tf, accels=accels,
                lp=lp, cam=cam, lo=st.world_bounds_lo, hi=st.world_bounds_hi)


@pytest.mark.parametrize("sampler", ["locator", "brute"])
@pytest.mark.parametrize("raygen", ["ae", "sphere", "grid"])
def test_cuda_parity_matches_plain(pscene, raygen, sampler):
    """K8: two samples of each raygen x sampler; the first sample's final
    LCG state and loop iterations equal on every lane, then fb identical
    on >= 99.9% of pixels and accum within 1e-6."""
    from icon_rt_tpu_torch.ops import render
    s = pscene
    lp = s["lp"]
    accel = s["accels"].get(raygen)
    key = f"parity_{raygen}_{sampler}"
    before = render.launches[key]
    outs = []
    for kernel in (True, False):
        acc, fb = alloc_frame(64, 64, device=lp.accum_id.device)
        dbg = torch.zeros(64 * 64, 2, dtype=torch.int32, device=acc.device)
        pix = torch.arange(64 * 64, dtype=torch.int32, device=acc.device)
        for k in range(2):
            lpk = lp._replace(accum_id=torch.tensor(k, dtype=torch.int32,
                                                    device=acc.device))
            args = (s["cells"], s["tf"], lpk, acc, fb)
            if kernel:
                render.parity_track(*args, width=64, height=64,
                                    raygen=raygen, sampler=sampler,
                                    locator=s["loc"], accel=accel,
                                    debug=dbg if k == 0 else None)
            else:
                render._parity_torch(s["cells"], s["tf"], lpk, pix, acc, fb,
                                     dbg if k == 0 else None, 64, 64,
                                     raygen, sampler, s["loc"], accel)
        torch.cuda.synchronize()
        outs.append((acc, fb, dbg))
    assert render.launches[key] == before + 2
    (ak, fk, dk), (ap, fp, dp) = outs
    assert torch.equal(dk, dp)
    assert (fk == fp).float().mean() >= 0.999
    assert float((ak - ap).abs().max()) <= 1e-6


def _on(tup, device):
    """A NamedTuple of tensors with every tensor moved to `device`."""
    return type(tup)(*[x.to(device) if isinstance(x, torch.Tensor) else x
                       for x in tup])


@pytest.mark.parametrize("raygen", ["ae", "sphere", "grid"])
def test_cuda_parity_work_counts_match_eager(pscene, raygen):
    """ops/woodcock.py `Work`, the counts behind K8's bound in
    chip_smoke.py: the plain version on the card (a CUDA graph of one
    lock-step iteration replayed between compactions, rows that finished
    inside a window masked out) counts exactly what the eager loop on the
    CPU counts, on 256 strided lanes of the frame, locator sampler."""
    from icon_rt_tpu_torch.ops import render
    from icon_rt_tpu_torch.ops.woodcock import Work
    s = pscene
    got = []
    for device in ("cuda", "cpu"):
        cells, loc = _on(s["cells"], device), _on(s["loc"], device)
        accel = s["accels"].get(raygen)
        accel = None if accel is None else _on(accel, device)
        pix = torch.arange(0, 64 * 64, 16, dtype=torch.int32, device=device)
        acc = torch.zeros(pix.shape[0], 4, device=device)
        fb = torch.zeros(pix.shape[0], dtype=torch.int32, device=device)
        work = Work(cells, "locator", loc)
        render._parity_torch(cells, _on(s["tf"], device),
                             _on(s["lp"], device), pix, acc, fb, None, 64,
                             64, raygen, "locator", loc, accel, work)
        got.append(work.counts())
    assert got[0] == got[1]
    assert got[0]["eval"] > 0


@pytest.mark.parametrize("tier", ["f32", "q"])
def test_cuda_track_cost_matches_plain(scene, qscene, tier):
    """K1's and K2's return_cost store: with a cost output the kernel's
    accum and fb are bit-equal to its launch without one; its per-pixel
    step counts equal the plain version's on >= 99.9% of pixels (the share
    the fb is held to) and are 0 on every untraced pixel."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    dev = pix.device
    if tier == "f32":
        tabs = (scene["packed"], scene["loc"], scene["bands"])
        kernel, plain, extra = fast.track_f32, \
            fast._render_frame_fast_torch, ()
    else:
        tabs = (qscene["q"], qscene["loc"], scene["bands"], scene["tf"])
        kernel, plain = fastq.track_q, fastq._render_frame_fast_q_torch
        extra = (qscene["fm"],)
    outs = []
    for mode in ("kernel", "kernel_cost", "plain_cost"):
        acc, fb = alloc_frame(96, 96, device=dev)
        cost = None if mode == "kernel" else \
            torch.zeros(96 * 96, dtype=torch.int32, device=dev)
        args = (*tabs, scene["lp"], pix, acc[:n], fb[:n])
        if mode == "plain_cost":
            plain(*args, 96, 96, 4, True, *extra, cost=cost)
        else:
            kw = dict(finemap=extra[0]) if extra else {}
            kernel(*args, width=96, height=96, samples=4,
                   preserve_cache=True, cost=cost, **kw)
        torch.cuda.synchronize()
        outs.append((acc, fb, cost))
    (a0, f0, _), (a1, f1, ck), (_, _, cp) = outs
    assert torch.equal(a0, a1) and torch.equal(f0, f1)
    assert float((ck == cp).float().mean()) >= 0.999
    untraced = torch.ones(96 * 96, dtype=torch.bool, device=dev)
    untraced[pix.long()] = False
    assert int(ck[untraced].abs().max()) == 0 and int(ck.max()) > 0


def _ragged_scene(dev):
    """An icosphere (subdivision 4) whose columns hold 1..24 layers of
    random thickness, a quarter of them of zero thickness, so that most
    columns have fewer layers than the quantized tier's Lm (24); the camera
    sits on the x axis and looks at the point where its ray grazes the
    sphere of the third ceiling, so the rays around the frame's centre
    skim that ceiling."""
    rng = np.random.default_rng(7)
    ds = synthetic.icosphere(4, 8)
    n = ds.num_cells
    nl = rng.integers(1, 25, n).astype(np.int32)
    step = rng.uniform(500.0, 4000.0, (n, 32)).astype(np.float32)
    step[rng.random((n, 32)) < 0.25] = 0.0
    step[:, 0] = 0.0
    height = (ds.height[:, :1] + np.cumsum(step, axis=1)).astype(np.float32)
    ds = ICDataset(lat=ds.lat, lon=ds.lon, num_layers=nl, height=height,
                   value=ds.value)
    st = compute_stats(ds)
    tf = make_transfunc(value_range=tuple(st.data_range), opacity_scale=0.7,
                        device=dev)
    bands = update_band_majorants(build_radial_bands(ds, 64, device=dev),
                                  tf.values, tf.value_range)
    cells = build_cells(ds, device=dev)
    q = qcells.bake_alpha_q(qcells.quantize_cells(ds, device=dev), tf)
    csr, k_cap = build_locator_csr(ds)
    loc_q = densify_csr(csr, k_cap, device=dev)
    r_k = float(np.median(height[:, 3]))
    d = 1.5 * float(st.spherical_bounds_hi[0])
    cam = Camera()
    pos = np.array([d, 0, 0], np.float32)
    touch = np.array([r_k * r_k / d, r_k * np.sqrt(1 - (r_k / d) ** 2), 0],
                     np.float32)
    cam.set_orientation(pos, touch, np.array([0, 0, 1], np.float32),
                        np.radians(20.0))
    lp = make_launch_params(cam.basis(96, 96), st.world_bounds_lo,
                            st.world_bounds_hi, unit_distance=1e3,
                            device=dev)
    perm, n_cov = order.pixel_order(lp, st.spherical_bounds_lo[0],
                                    st.spherical_bounds_hi[0], 96, 96)
    from icon_rt_tpu_torch.models.shells import build_radial_bands_wedge
    bands_w = update_band_majorants(build_radial_bands_wedge(
        ds, 64, device=dev), tf.values, tf.value_range)
    return dict(packed=fast.pack_cells(cells, tf), loc=build_locator(
        ds, device=dev), q=q, loc_q=loc_q,
        fm=finemap.build_finemap(loc_q, q.test12), tf=tf, bands=bands,
        lp=lp, perm=perm, n_cov=n_cov,
        packed_w=fast.pack_cells_wedge(cells, tf), bands_w=bands_w)


@pytest.fixture(scope="module")
def rscene(dev):
    return _ragged_scene(dev)


@pytest.mark.parametrize("case", ["graze 8 samples", "graze raw salted"])
@pytest.mark.parametrize("tier", ["f32", "q"])
def test_cuda_track_ragged_layers_match_plain(rscene, tier, case):
    """K1 and K2 (the layer from each slot's cached bracket, else a binary
    search) against their plain versions on columns of 1..24 layers with
    zero-thickness layers (most below the q tier's Lm) and rays grazing a
    ceiling: 8 samples with the column cache kept and the cost output
    (fb identical on >= 99.9% of lanes, accum within 1e-6, cost on >=
    99.9%), and one raw sample with rng_salt, raw_t and the cost output
    (wrote identical, colour and t identical on >= 99.9% of lanes, colour
    within 1e-6, cost on >= 99.9%)."""
    s = rscene
    n = s["n_cov"]
    pix = s["perm"][:n].contiguous()
    dev = pix.device
    if tier == "f32":
        tabs = (s["packed"], s["loc"], s["bands"], s["lp"])
        kern = lambda *a, **k: fast.track_f32(*tabs, *a, width=96,
                                              height=96, **k)
        plain = lambda *a, **k: fast._render_frame_fast_torch(
            *tabs, *a, 96, 96, k["samples"], True, k["cost"],
            fast._F32Tier, k["rng_salt"], k["out"])
    else:
        tabs = (s["q"], s["loc_q"], s["bands"], s["tf"], s["lp"])
        kern = lambda *a, **k: fastq.track_q(*tabs, *a, width=96, height=96,
                                             finemap=s["fm"], **k)
        plain = lambda *a, **k: fastq._render_frame_fast_q_torch(
            *tabs, *a, 96, 96, k["samples"], True, s["fm"], k["cost"],
            k["rng_salt"], k["out"])
    raw = case.endswith("raw salted")
    outs = []
    for run in (kern, plain):
        cost = torch.zeros(96 * 96, dtype=torch.int32, device=dev)
        if raw:
            out = fast.alloc_raw(n, dev)
            run(pix, None, None, samples=1, cost=cost, rng_salt=5, out=out)
        else:
            acc, fb = (x[:n] for x in alloc_frame(96, 96, device=dev))
            run(pix, acc, fb, samples=8, cost=cost, rng_salt=0, out=None)
            out = (acc, fb)
        torch.cuda.synchronize()
        outs.append((out, cost))
    (ok, ck), (op, cp) = outs
    assert float((ck == cp).float().mean()) >= 0.999 and int(ck.max()) > 0
    if raw:
        assert torch.equal(ok.wrote, op.wrote)
        assert (ok.ca == op.ca).all(1).float().mean() >= 0.999
        assert float((ok.ca - op.ca).abs().max()) <= 1e-6
        assert (ok.t == op.t).float().mean() >= 0.999
        assert bool(torch.isfinite(ok.t).any())
    else:
        assert (ok[1] == op[1]).float().mean() >= 0.999
        assert float((ok[0] - op[0]).abs().max()) <= 1e-6
        assert int((ok[1] != 0).sum()) > n // 4


@pytest.mark.parametrize("preserve_cache", [True, False])
def test_cuda_track_wedge_ragged_layers_match_plain(rscene, preserve_cache):
    """K9-w (each slot's layer bracket in s = dot(P, n'), else a binary
    search) against its plain version on the ragged scene -- columns of
    1..24 layers, a quarter of zero thickness, rays grazing the third
    ceiling -- 8 samples with the cost output: fb identical on >= 99.9% of
    lanes, accum within 1e-6, cost on >= 99.9%."""
    s = rscene
    n = s["n_cov"]
    pix = s["perm"][:n].contiguous()
    dev = pix.device
    outs = []
    for kernel in (True, False):
        cost = torch.zeros(96 * 96, dtype=torch.int32, device=dev)
        acc, fb = (x[:n] for x in alloc_frame(96, 96, device=dev))
        args = (s["packed_w"], s["loc"], s["bands_w"], s["lp"], pix, acc,
                fb)
        if kernel:
            fast.track_wedge(*args, width=96, height=96, samples=8,
                             preserve_cache=preserve_cache, cost=cost)
        else:
            fast._render_frame_fast_torch(*args, 96, 96, 8, preserve_cache,
                                          cost, tier=fast._WedgeTier)
        torch.cuda.synchronize()
        outs.append((acc, fb, cost))
    (ak, fk, ck), (ap, fp, cp) = outs
    assert float((ck == cp).float().mean()) >= 0.999 and int(ck.max()) > 0
    assert (fk == fp).float().mean() >= 0.999
    assert float((ak - ap).abs().max()) <= 1e-6
    assert int((fk != 0).sum()) > n // 4


def test_cuda_scene_lod_matches_plain(dev):
    """K7-scene's mip tier (field_lod 2 on a subdivision-4 x 16 scene, each
    cell pooled over 16 subdivision-6 descendants): pass 1's aggregates,
    test12 and the corner lat/lon bit-equal to the plain version's; value_q
    within 1 level and exact on >= 99.999% of entries; the per-layer u8
    ranges equal; the launches counted under the lod keys."""
    from icon_rt_tpu_torch.data import device_scene as ds
    c = ds._Consts(4, 16, float(synthetic.EARTH_RADIUS), 3.0e4, dev, lod=2)
    before = dict(ds.launches)
    p1 = ds.scene_pass1(c, latlon=True)
    p1p = ds._scene_pass1_torch(c, 0, c.n, True)
    _pass1_equal(p1, p1p)
    lo, hi = float(p1.agg[0]), float(p1.agg[1])
    scale = float(ds.quant_scale(lo, hi))
    got = ds.scene_pass2(c, p1, lo, scale)
    want = ds._scene_pass2_torch(c, p1p, lo, scale)
    assert ds.launches == {k: v + k.startswith("scene_lod")
                           for k, v in before.items()}
    _tables_match(got, want)


def test_cuda_refine_matches_plain(dev):
    """K6b: refine_keys, refine_perm and repermute exactly equal to their
    plain versions on 100,000 lanes (70,000 covered, costs with ties)."""
    rng = np.random.default_rng(5)
    total, n_act = 100_000, 70_000
    t = lambda a: torch.from_numpy(a).to(dev)
    perm = t(rng.permutation(total).astype(np.int32))
    cost = t(rng.integers(0, 50, total).astype(np.int32))
    acc = t(rng.standard_normal((total, 4)).astype(np.float32))
    fb = t(rng.integers(-2 ** 31, 2 ** 31 - 1, total).astype(np.int32))
    before = dict(order.refine_launches)
    keys = order.refine_keys(perm, n_act, cost)
    assert torch.equal(keys, order._refine_keys_torch(perm, n_act, cost))
    srt = torch.sort(keys, stable=True).indices.to(torch.int32)
    assert torch.equal(order.refine_perm(perm, n_act, srt),
                       order._refine_perm_torch(perm, n_act, srt))
    new = order.refine_order_device(perm, n_act, cost)
    want_new = order.refine_order(perm.cpu().numpy(), n_act,
                                  cost.cpu().numpy())
    assert np.array_equal(new.cpu().numpy(), want_new)
    inv = order.inverse_order(perm)
    a2, f2 = order.repermute_device(acc, fb, new, inv)
    pa, pf = order._repermute_torch(acc, fb, new, inv)
    assert torch.equal(a2, pa) and torch.equal(f2, pf)
    assert order.refine_launches == {k: v + (1 if k == "repermute" else 2)
                                     for k, v in before.items()}


#: refine_perm's prefix sizes over 100,003 lanes (a ragged end):
#: n_active % 4 == 0, 1, 2, 3, none and every lane
REFINE_PERM_TOTAL = 100_003


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_act", [4_000, 4_001, 4_002, 4_003, 0,
                                   REFINE_PERM_TOTAL])
def test_cuda_refine_perm_tails_match_plain(dev, n_act, dtype):
    """K6b refine_perm (csrc/order.cu, 4 lanes a thread) where n_active
    splits a vector at each offset, leaves no head or no tail, with int32
    and int64 (torch.sort's) order: exact against the plain version, one
    launch a call."""
    rng = np.random.default_rng(n_act + 7)
    t = lambda a: torch.from_numpy(a).to(dev)
    perm = t(rng.permutation(REFINE_PERM_TOTAL).astype(np.int32))
    srt = t(rng.permutation(n_act)).to(dtype)
    before = order.refine_launches["refine_perm"]
    got = order.refine_perm(perm, n_act, srt)
    assert order.refine_launches["refine_perm"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, order._refine_perm_torch(perm, n_act, srt))


@pytest.mark.parametrize("n_act", [0, 1, 3, 4, 70_001])
def test_cuda_refine_keys_tails_match_plain(dev, n_act):
    """K6b refine_keys (csrc/order.cu, 4 keys a thread) at the prefix
    sizes of its tail: none, 1 and 3 keys, one full vector and 70,001
    (17,500 vectors and a key); exact against the plain version, one
    launch for each call with a key and none without."""
    rng = np.random.default_rng(n_act)
    total = max(n_act, 8) + 5
    t = lambda a: torch.from_numpy(a).to(dev)
    perm = t(rng.permutation(total).astype(np.int32))
    cost = t(rng.integers(-2 ** 31, 2 ** 31 - 1, total).astype(np.int32))
    before = order.refine_launches["refine_keys"]
    keys = order.refine_keys(perm, n_act, cost)
    assert order.refine_launches["refine_keys"] == before + (n_act > 0)
    assert keys.shape == (n_act,) and keys.dtype == torch.int32
    assert torch.equal(keys, order._refine_keys_torch(perm, n_act, cost))


@pytest.fixture(scope="module")
def wscene(dev, scene):
    """The fast wedge tier of the subdiv-4 scene: pack_cells_wedge (K5a
    over bv) and the wedge bands."""
    from icon_rt_tpu_torch.models.shells import build_radial_bands_wedge
    ds = synthetic.icosphere(4, 8)
    bands = update_band_majorants(build_radial_bands_wedge(ds, 64,
                                                           device=dev),
                                  scene["tf"].values, scene["tf"].value_range)
    return dict(packed=fast.pack_cells_wedge(scene["cells"], scene["tf"]),
                bands=bands)


@pytest.mark.parametrize("preserve_cache", [True, False])
def test_cuda_track_wedge_matches_plain(scene, wscene, preserve_cache):
    """K9-w: 4 samples on the covered lanes; fb identical on >= 99.9% of
    lanes, accum within 1e-6; the image not blank."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    before = fast.launches["track_wedge"]
    outs = []
    for kernel in (True, False):
        acc, fb = alloc_frame(96, 96, device=pix.device)
        args = (wscene["packed"], scene["loc"], wscene["bands"],
                scene["lp"], pix, acc[:n], fb[:n])
        if kernel:
            fast.track_wedge(*args, width=96, height=96, samples=4,
                             preserve_cache=preserve_cache)
        else:
            fast._render_frame_fast_torch(*args, 96, 96, 4, preserve_cache,
                                          tier=fast._WedgeTier)
        torch.cuda.synchronize()
        outs.append((acc, fb))
    assert fast.launches["track_wedge"] == before + 1
    (ak, fk), (ap, fp) = outs
    assert (fk == fp).float().mean() >= 0.999
    assert float((ak - ap).abs().max()) <= 1e-6
    assert int((fk != 0).sum()) > n // 4


#: K9-p's plain check lanes per raygen: the plain Newton window is slow in
#: lock step, and an AE lane beside the globe walks the whole box
WEDGE_CHECK_LANES = {"ae": 256, "sphere": 1024, "grid": 1024}


@pytest.mark.parametrize("raygen", ["ae", "sphere", "grid"])
def test_cuda_parity_wedge_matches_plain(pscene, raygen):
    """K9-p (K8 with the wedge sampler): two samples on lanes strided over
    the frame; the first sample's final LCG state and loop iterations
    equal on every lane, fb identical on >= 99.9%, accum within 1e-6."""
    from icon_rt_tpu_torch.models.wedges import build_wedges
    from icon_rt_tpu_torch.ops import render
    s = pscene
    lp = s["lp"]
    dev = lp.accum_id.device
    w = build_wedges(synthetic.icosphere(3, 8), device=dev)
    accel = s["accels"].get(raygen)
    key = f"parity_{raygen}_wedge"
    before = render.launches[key]
    n = WEDGE_CHECK_LANES[raygen]
    pix = torch.arange(0, 64 * 64, 64 * 64 // n, dtype=torch.int32,
                       device=dev)
    outs = []
    for kernel in (True, False):
        acc = torch.zeros(n, 4, device=dev)
        fb = torch.zeros(n, dtype=torch.int32, device=dev)
        dbg = torch.zeros(n, 2, dtype=torch.int32, device=dev)
        for k in range(2):
            lpk = lp._replace(accum_id=torch.tensor(k, dtype=torch.int32,
                                                    device=dev))
            if kernel:
                render.parity_track(s["cells"], s["tf"], lpk, acc, fb,
                                    width=64, height=64, raygen=raygen,
                                    sampler="wedge", locator=s["loc"],
                                    accel=accel, pix=pix, wedges=w,
                                    debug=dbg if k == 0 else None)
            else:
                render._parity_torch(s["cells"], s["tf"], lpk, pix, acc, fb,
                                     dbg if k == 0 else None, 64, 64,
                                     raygen, "wedge", s["loc"], accel,
                                     wedges=w)
        torch.cuda.synchronize()
        outs.append((acc, fb, dbg))
    assert render.launches[key] == before + 2
    (ak, fk, dk), (ap, fp, dp) = outs
    assert torch.equal(dk, dp)
    assert (fk == fp).float().mean() >= 0.999
    assert float((ak - ap).abs().max()) <= 1e-6
    assert int((fk != 0).sum()) > 0


def _uelems_inputs(nv, m, dev, seed):
    """m seeded points on jittered unit elements of nv vertices (as
    chip_smoke.py's `uelems_inputs`)."""
    base = {5: [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 1]],
            6: [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1],
                [0, 1, 1]],
            8: [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1],
                [1, 0, 1], [1, 1, 1], [0, 1, 1]]}[nv]
    rs = np.random.default_rng(seed)
    V = (np.asarray(base, np.float32)[None]
         + rs.normal(size=(m, nv, 3)) * 0.15).astype(np.float32)
    S = rs.random((m, nv)).astype(np.float32)
    P = (rs.normal(size=(m, 3)) * 0.5 + 0.45).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (P, V, S))


@pytest.mark.parametrize("nv", [5, 6, 8])
def test_cuda_uelems_points_match_plain(dev, nv):
    """K9-n: 65,536 seeded points on jittered unit elements of each shape;
    inside flags (bool) and values bit-equal to the plain Newton."""
    from icon_rt_tpu_torch.ops import uelems
    P, V, S = _uelems_inputs(nv, 65536, dev, nv)
    before = uelems.launches["uelems_points"]
    hk, vk = uelems.uelems_points(P, V, S)
    hp, vp = uelems.newton(P, V, S)
    assert uelems.launches["uelems_points"] == before + 1
    assert hk.dtype == torch.bool
    assert torch.equal(hk, hp) and torch.equal(vk, vp)
    assert 0.05 < float(hk.float().mean()) < 0.95


@pytest.mark.parametrize("m", [1, 127, 129, 65537])
@pytest.mark.parametrize("nv", [5, 6, 8])
def test_cuda_uelems_points_ragged_out_match_plain(dev, nv, m):
    """K9-n on ragged sizes around its blocks of 128 threads, into out=
    tensors: flags (bool) and values bit-equal to the plain Newton, the
    given tensors returned; then with NaN scalars on every element that
    does not contain its point, which the kernel must leave unread: the
    same bits as with the finite scalars."""
    from icon_rt_tpu_torch.ops import uelems
    P, V, S = _uelems_inputs(nv, m, dev, m + nv)
    out = (torch.ones(m, dtype=torch.bool, device=dev),
           torch.full((m,), float("nan"), device=dev))
    hk, vk = uelems.uelems_points(P, V, S, out=out)
    hp, vp = uelems.newton(P, V, S)
    assert hk is out[0] and vk is out[1]
    assert torch.equal(hk, hp) and torch.equal(vk, vp)
    S_nan = torch.where(hp[:, None], S, float("nan"))
    hn, vn = uelems.uelems_points(P, V, S_nan)
    assert torch.equal(hn, hp) and torch.equal(vn, vp)


def test_cuda_uelems_points_frame_wedges_match_plain(dev):
    """K9-n on 2,073,600 wedge points (one a 1080p lane): bit-equal to
    the plain Newton, into a new bool tensor and into out=."""
    from icon_rt_tpu_torch.ops import uelems
    m = 1920 * 1080
    P, V, S = _uelems_inputs(6, m, dev, 6)
    hp, vp = uelems.newton(P, V, S)
    hk, vk = uelems.uelems_points(P, V, S)
    assert hk.dtype == torch.bool
    assert torch.equal(hk, hp) and torch.equal(vk, vp)
    out = (torch.empty_like(hk), torch.empty_like(vk))
    uelems.uelems_points(P, V, S, out=out)
    assert torch.equal(out[0], hp) and torch.equal(out[1], vp)


@pytest.mark.parametrize("salt", [0, 2])
@pytest.mark.parametrize("tier", ["f32", "q"])
def test_cuda_track_raw_matches_plain(scene, qscene, tier, salt):
    """K1/K2 raw mode (one sample, wrote, colour and t per lane, no
    finalize) with and without rng_salt against the plain versions: wrote
    and t identical, colour identical on >= 99.9% of lanes and within 1e-6;
    the raw sample through K10's finalize equals the finalizing launch of
    the same sample bit for bit."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    dev = pix.device
    if tier == "f32":
        tabs = (scene["packed"], scene["loc"], scene["bands"], scene["lp"])
        kern = lambda *a, **k: fast.track_f32(*tabs, *a, width=96,
                                              height=96, **k)
        plain = lambda pix, acc, fb, salt, out: fast._render_frame_fast_torch(
            *tabs, pix, acc, fb, 96, 96, 1, True, None, fast._F32Tier, salt,
            out)
    else:
        tabs = (qscene["q"], qscene["loc"], scene["bands"], scene["tf"],
                scene["lp"])
        kern = lambda *a, **k: fastq.track_q(*tabs, *a, width=96, height=96,
                                             finemap=qscene["fm"], **k)
        plain = lambda pix, acc, fb, salt, out: \
            fastq._render_frame_fast_q_torch(*tabs, pix, acc, fb, 96, 96, 1,
                                             True, qscene["fm"], None, salt,
                                             out)
    rk, rp = fast.alloc_raw(n, dev), fast.alloc_raw(n, dev)
    kern(pix, None, None, rng_salt=salt, out=rk)
    plain(pix, None, None, salt, rp)
    torch.cuda.synchronize()
    assert torch.equal(rk.wrote, rp.wrote)
    assert (rk.ca == rp.ca).all(1).float().mean() >= 0.999
    assert float((rk.ca - rp.ca).abs().max()) <= 1e-6
    assert (rk.t == rp.t).float().mean() >= 0.999
    if salt:
        return
    acc, fb = alloc_frame(96, 96, device=dev)
    acc, fb = acc[:n], fb[:n]
    kern(pix, acc, fb)
    acc_r, fb_r = alloc_frame(96, 96, device=dev)
    acc_r, fb_r = acc_r[:n], fb_r[:n]
    composite.finalize_mean(composite.mean_payload(rk.wrote, rk.ca), acc_r,
                            fb_r, scene["lp"].accum_id)
    assert torch.equal(acc_r, acc) and torch.equal(fb_r, fb)


@pytest.mark.parametrize("sampler", ["locator", "brute"])
@pytest.mark.parametrize("raygen", ["ae", "sphere", "grid"])
def test_cuda_parity_raw_matches_plain(pscene, raygen, sampler):
    """K8's raw mode (out=, no finalize): wrote identical and colour
    identical on >= 99.9% of lanes and within 1e-6 of the plain version's,
    every lane's final LCG state and iterations equal; the raw sample
    through K10's mean finalize over one rank equals K8's finalizing
    launch bit for bit (a ParityParams mirror out of step would show)."""
    from icon_rt_tpu_torch.ops import render
    s = pscene
    lp = s["lp"]._replace(accum_id=torch.tensor(
        2, dtype=torch.int32, device=s["lp"].accum_id.device))
    dev = lp.accum_id.device
    L = 64 * 64
    pix = torch.arange(L, dtype=torch.int32, device=dev)
    accel = s["accels"].get(raygen)
    kw = dict(width=64, height=64, raygen=raygen, sampler=sampler,
              locator=s["loc"], accel=accel)
    key = f"parity_{raygen}_{sampler}_raw"
    before = render.launches[key]
    rk, rp = fast.alloc_raw(L, dev), fast.alloc_raw(L, dev)
    dk, dp = (torch.zeros(L, 2, dtype=torch.int32, device=dev)
              for _ in range(2))
    render.parity_track(s["cells"], s["tf"], lp, None, None, debug=dk,
                        out=rk, **kw)
    assert render.launches[key] == before + 1
    render._parity_torch(s["cells"], s["tf"], lp, pix, None, None, dp, 64,
                         64, raygen, sampler, s["loc"], accel, out=rp)
    torch.cuda.synchronize()
    assert torch.equal(dk, dp)
    assert torch.equal(rk.wrote, rp.wrote)
    assert (rk.ca == rp.ca).all(1).float().mean() >= 0.999
    assert float((rk.ca - rp.ca).abs().max()) <= 1e-6
    g = torch.Generator().manual_seed(3)
    acc0 = torch.rand(L, 4, generator=g).to(dev)
    acc, fb = acc0.clone(), torch.zeros(L, dtype=torch.int32, device=dev)
    render.parity_track(s["cells"], s["tf"], lp, acc, fb, **kw)
    acc_r, fb_r = acc0.clone(), torch.zeros_like(fb)
    composite.finalize_mean(composite.mean_payload(rk.wrote, rk.ca), acc_r,
                            fb_r, lp.accum_id)
    assert torch.equal(acc_r, acc) and torch.equal(fb_r, fb)


def _grazing_lp(pscene, size, dev, r=None):
    """Launch params of a camera at 1.6 shell tops whose view centre is
    tangent to the sphere of radius r (the cells' shell top shell[1] where
    None): its rays graze it, where K8's whole-shell test decides."""
    c = pscene["cells"]
    r = float(c.shell[1]) if r is None else r
    d = 1.6 * r
    tangent = np.array([r * r / d, r * np.sqrt(1.0 - (r / d) ** 2), 0.0],
                       np.float32)
    cam = Camera()
    cam.set_orientation(np.array([d, 0.0, 0.0], np.float32), tangent,
                        np.array([0, 0, 1], np.float32), 3.0)
    return make_launch_params(cam.basis(size, size), pscene["lo"],
                              pscene["hi"], unit_distance=1e3, device=dev)


@pytest.mark.parametrize("sampler", ["locator", "brute", "wedge"])
@pytest.mark.parametrize("raygen", ["ae", "sphere", "grid"])
def test_cuda_parity_grazing_shell_matches_plain(pscene, raygen, sampler):
    """K8 with rays that graze the sampler's shell top, where its
    whole-shell test decides, at 96 x 96 lanes: every lane's final LCG
    state and iterations, accum and fb bit-equal to the plain version's;
    then raw mode's wrote, colour and debug output bit-equal too.  K9-p
    (the wedge sampler) grazes the top of the wedges' shell
    (`Wedges.shell`, above the cells' by its margin) on WEDGE_CHECK_LANES
    lanes strided over the frame (its plain Newton window is slow in lock
    step), under K9-p's gates: rng and iterations equal on every lane, fb
    and raw colour identical on >= 99.9%, within 1e-6, wrote equal."""
    from icon_rt_tpu_torch.models.wedges import build_wedges
    from icon_rt_tpu_torch.ops import render
    s = pscene
    dev = s["lp"].accum_id.device
    n = 96
    w = build_wedges(synthetic.icosphere(3, 8), device=dev) \
        if sampler == "wedge" else None
    lp = _grazing_lp(s, n, dev, None if w is None else float(w.shell[1]))
    accel = s["accels"].get(raygen)
    kw = dict(width=n, height=n, raygen=raygen, sampler=sampler,
              locator=s["loc"], accel=accel, wedges=w)
    pix = torch.arange(n * n, dtype=torch.int32, device=dev)
    if w is not None:
        m = WEDGE_CHECK_LANES[raygen]
        pix = pix[::n * n // m][:m].contiguous()
    L = pix.shape[0]
    outs = []
    for kernel in (True, False):
        acc = torch.zeros(L, 4, device=dev)
        fb = torch.zeros(L, dtype=torch.int32, device=dev)
        dbg = torch.zeros(L, 2, dtype=torch.int32, device=dev)
        if kernel:
            render.parity_track(s["cells"], s["tf"], lp, acc, fb, debug=dbg,
                                pix=None if w is None else pix, **kw)
        else:
            render._parity_torch(s["cells"], s["tf"], lp, pix, acc, fb, dbg,
                                 n, n, raygen, sampler, s["loc"], accel,
                                 wedges=w)
        raw = fast.alloc_raw(L, dev)
        rdbg = torch.zeros_like(dbg)
        lp1 = lp._replace(accum_id=torch.tensor(1, dtype=torch.int32,
                                                device=dev))
        if kernel:
            render.parity_track(s["cells"], s["tf"], lp1, None, None,
                                debug=rdbg, out=raw,
                                pix=None if w is None else pix, **kw)
        else:
            render._parity_torch(s["cells"], s["tf"], lp1, pix, None, None,
                                 rdbg, n, n, raygen, sampler, s["loc"],
                                 accel, wedges=w, out=raw)
        torch.cuda.synchronize()
        outs.append((acc, fb, dbg, raw.wrote, raw.ca, rdbg))
    if w is None:
        for got, want in zip(*outs):
            assert torch.equal(got, want)
    else:
        (ak, fk, dk, wk, ck, rk), (ap, fp, dp, wp, cp, rp) = outs
        assert torch.equal(dk, dp) and torch.equal(rk, rp)
        assert torch.equal(wk, wp)
        assert (fk == fp).float().mean() >= 0.999
        assert (ck == cp).all(1).float().mean() >= 0.999
        assert float((ak - ap).abs().max()) <= 1e-6
        assert float((ck - cp).abs().max()) <= 1e-6
    acc, fb, dbg = outs[0][:3]
    assert int((fb != 0).sum()) > 0 and int(dbg[:, 1].max()) > 0


def test_cuda_parity_unknown_mode_is_refused(dev):
    """parity_launch and parity_occupancy go through one dispatch over the
    raygen x sampler instances: a mode outside it returns
    cudaErrorInvalidValue (1) and launches nothing, and every known mode
    answers the occupancy query."""
    import ctypes
    from icon_rt_tpu_torch.ops import render
    lib = render.build_parity()
    out = (ctypes.c_int * 3)()
    params = render._parity_params_type()()
    params.n_lanes = 1
    for rg, sp in ((0, 3), (3, 0), (-1, 0), (0, -1), (2, 3)):
        assert lib.parity_occupancy(rg, sp, out) == 1
        assert lib.parity_launch(ctypes.byref(params), rg, sp, None) == 1
    torch.cuda.synchronize()
    for rg in range(3):
        for sp in range(3):
            assert lib.parity_occupancy(rg, sp, out) == 0
            assert out[0] > 0 and out[1] > 0


@pytest.mark.parametrize("raygen,sampler", [
    ("ae", "locator"), ("sphere", "locator"), ("grid", "locator"),
    ("ae", "brute"), ("ae", "wedge")])
def test_cuda_parity_steady_call_reads_nothing_back(pscene, raygen,
                                                     sampler):
    """A steady K8 launch (the tables of the launch before it, a new
    accum_id) does no device-to-host read: the camera, the box, the TF's
    range and scale, the cells' shell, the locator window and the accel
    bounds are read on the card; a camera move and the new accum_id reach
    the kernel (its frames equal the plain version's bit for bit and the
    move changes them)."""
    from icon_rt_tpu_torch.models.wedges import build_wedges
    from icon_rt_tpu_torch.ops import render
    s = pscene
    dev = s["lp"].accum_id.device
    w = (build_wedges(synthetic.icosphere(3, 8), device=dev)
         if sampler == "wedge" else None)
    accel = s["accels"].get(raygen)
    n = 16 if sampler == "wedge" else 64
    lps = [make_launch_params(s["cam"].basis(n, n), s["lo"], s["hi"],
                              unit_distance=1e3, accum_id=k, device=dev)
           for k in range(3)]
    lps.append(lps[2]._replace(cam_org=lps[2].cam_org * 1.01))
    kw = dict(width=n, height=n, raygen=raygen, sampler=sampler,
              locator=s["loc"], accel=accel, wedges=w)
    acc, fb = alloc_frame(n, n, device=dev)
    render.parity_track(s["cells"], s["tf"], lps[0], acc, fb, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        render.parity_track(s["cells"], s["tf"], lps[1], acc, fb, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pix = torch.arange(n * n, dtype=torch.int32, device=dev)
    got = []
    for lp in lps[2:]:
        ak, fk = alloc_frame(n, n, device=dev)
        ap, fp = alloc_frame(n, n, device=dev)
        render.parity_track(s["cells"], s["tf"], lp, ak, fk, **kw)
        render._parity_torch(s["cells"], s["tf"], lp, pix, ap, fp, None, n,
                             n, raygen, sampler, s["loc"], accel, wedges=w)
        torch.cuda.synchronize()
        assert torch.equal(ak, ap) and torch.equal(fk, fp)
        got.append(fk)
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("tier", ["f32", "q"])
def test_cuda_march_cost_matches_plain(scene, qscene, tier):
    """K3's cost output (each lane's march iterations at its pixel): equal
    to the plain version's on every pixel, untraced pixels untouched; the
    frame with the cost equal to the frame without, bit for bit."""
    n = scene["n_cov"]
    pix = scene["perm"][:n].contiguous()
    dev = pix.device
    if tier == "f32":
        tabs = (scene["packed"], scene["loc"], scene["bands"], scene["lp"])
        kern = lambda *a, **k: march.march_f32(*tabs, *a, width=96,
                                               height=96, **k)
        plain = lambda *a: march._march_frame_torch(
            fast._F32Tier(scene["packed"], scene["loc"]), scene["bands"],
            scene["lp"], *a)
    else:
        tabs = (qscene["q"], qscene["loc"], scene["bands"], scene["tf"],
                scene["lp"])
        kern = lambda *a, **k: march.march_q(*tabs, *a, width=96,
                                             height=96, **k)
        plain = lambda *a: march._march_frame_torch(
            fastq._QTier(qscene["q"], qscene["loc"], scene["tf"], None),
            scene["bands"], scene["lp"], *a)
    key = f"march_{tier}_cost"
    before = march.launches[key]
    ck, cp = (torch.full((96 * 96,), -1, dtype=torch.int32, device=dev)
              for _ in range(2))
    acc, fb = (x[:n] for x in alloc_frame(96, 96, device=dev))
    kern(pix, acc, fb, cost=ck)
    assert march.launches[key] == before + 1
    acc0, fb0 = (x[:n] for x in alloc_frame(96, 96, device=dev))
    kern(pix, acc0, fb0)
    accp, fbp = (x[:n] for x in alloc_frame(96, 96, device=dev))
    plain(pix, accp, fbp, 96, 96, cp)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc0) and torch.equal(fb, fb0)
    assert torch.equal(ck, cp)
    assert int((ck[pix.long()] > 0).sum()) > n // 2
    assert int((ck == -1).sum()) == 96 * 96 - n


def _k10_inputs(dev, L, D=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    t = torch.rand(L, generator=g)
    t[torch.rand(L, generator=g) < 0.3] = float("inf")
    t_min = torch.minimum(t, torch.rand(L, generator=g))
    t_min[::5] = t[::5]                       # ties with this slab
    t_min[::11] = float("inf")                # every slab +inf
    t[::11] = float("inf")
    return dict(
        t=t.to(dev), t_min=t_min.to(dev),
        win=torch.randint(0, D, (L,), generator=g, dtype=torch.int32).to(dev),
        ca=torch.rand(L, 4, generator=g).to(dev),
        wrote=(torch.rand(L, generator=g) > 0.3).to(dev),
        accum=torch.rand(L, 4, generator=g).to(dev),
        fb=torch.randint(0, 2 ** 31 - 1, (L,), generator=g,
                         dtype=torch.int32).to(dev),
        total5=torch.cat([torch.rand(L, 4, generator=g) * 2,
                          torch.randint(0, 3, (L, 1), generator=g).float()],
                         1).to(dev))


@pytest.mark.parametrize("L", [1000, 2_073_600])
def test_cuda_composite_matches_plain(dev, L):
    """K10: the three masks and the two finalizes bit-equal to their plain
    versions (ties of equal t, all-+inf lanes, lanes without a write)."""
    x = _k10_inputs(dev, L)
    aid = torch.tensor(3, dtype=torch.int32, device=dev)
    before = dict(composite.launches)
    pairs = [
        (composite.select_candidates(x["t"], x["t_min"], 1, 3),
         composite._mask_torch(composite.CAND, 1, 3, t=x["t"],
                               t_min=x["t_min"])),
        (composite.select_payload(x["t"], x["t_min"], x["win"], x["ca"], 1),
         composite._mask_torch(composite.PAYLOAD, 1, 3, t=x["t"],
                               t_min=x["t_min"], win=x["win"], ca=x["ca"])),
        (composite.mean_payload(x["wrote"], x["ca"]),
         composite._mask_torch(composite.MEAN, 0, 0, ca=x["ca"],
                               wrote=x["wrote"]))]
    for got, want in pairs:
        assert torch.equal(got, want)
    for mode in (composite.FIRST_HIT, composite.MEAN_FIN):
        ak, fk = x["accum"].clone(), x["fb"].clone()
        ap, fp = x["accum"].clone(), x["fb"].clone()
        if mode == composite.FIRST_HIT:
            composite.finalize_first_hit(x["ca"], x["t_min"], x["wrote"], ak,
                                         fk, aid)
            composite._finalize_torch(mode, x["ca"], ap, fp, aid,
                                      t_min=x["t_min"], wrote=x["wrote"])
        else:
            composite.finalize_mean(x["total5"], ak, fk, aid)
            composite._finalize_torch(mode, x["total5"], ap, fp, aid)
        assert torch.equal(ak, ap) and torch.equal(fk, fp)
        assert not torch.equal(fk, x["fb"])
    assert composite.launches["composite_mask"] == \
        before["composite_mask"] + 3
    assert composite.launches["composite_finalize"] == \
        before["composite_finalize"] + 2


def _march_view_lp(scene, view, size, dev):
    """Launch params of a camera inside the shell (half-way up it, looking
    along the horizon) or outside it at 1.6 shell tops with its view
    centre tangent to the sphere half-way up the shell ("grazing"): their
    rays cross columns on both sides of their apex, where both pieces of
    a crossing's integral are non-empty and a crossing spans many layers
    (the inside view's rays within ~4 degrees below its horizon, the
    grazing view's rows whose impact parameter lies in the shell); at a
    unit distance of 1e5 m most rays cross several columns."""
    st = scene["st"]
    r = 0.5 * float(st.spherical_bounds_lo[0] + st.spherical_bounds_hi[0])
    cam = Camera()
    if view == "inside":
        org = np.array([r, 0.0, 0.0], np.float32)
        cam.set_orientation(org, org + np.array([0.0, r, 0.0], np.float32),
                            np.array([1, 0, 0], np.float32), 8.0)
    else:
        d = 1.6 * float(st.spherical_bounds_hi[0])
        tangent = np.array([r * r / d, r * np.sqrt(1.0 - (r / d) ** 2),
                            0.0], np.float32)
        cam.set_orientation(np.array([d, 0.0, 0.0], np.float32), tangent,
                            np.array([0, 0, 1], np.float32), 0.4)
    return make_launch_params(cam.basis(size, size), st.world_bounds_lo,
                              st.world_bounds_hi, unit_distance=1e5,
                              device=dev)


@pytest.mark.parametrize("view", ["inside", "grazing"])
@pytest.mark.parametrize("tier", ["f32", "q"])
def test_cuda_march_views_bit_equal_plain(scene, qscene, dev, tier, view):
    """K3 from inside the shell and at grazing incidence, every pixel a
    lane: accum, fb and the cost output bit-equal to the plain version's
    (the integral visits only the layers whose length can be > 0; the f32
    tier's locate reads its candidates in groups)."""
    size = 96
    lp = _march_view_lp(scene, view, size, dev)
    pix = torch.arange(size * size, dtype=torch.int32, device=dev)
    if tier == "f32":
        tabs = (scene["packed"], scene["loc"], scene["bands"], lp)
        kern = lambda *a, **k: march.march_f32(*tabs, *a, width=size,
                                               height=size, **k)
        ptier = fast._F32Tier(scene["packed"], scene["loc"])
    else:
        tabs = (qscene["q"], qscene["loc"], scene["bands"], scene["tf"], lp)
        kern = lambda *a, **k: march.march_q(*tabs, *a, width=size,
                                             height=size, **k)
        ptier = fastq._QTier(qscene["q"], qscene["loc"], scene["tf"], None)
    outs = []
    for kernel in (True, False):
        acc, fb = alloc_frame(size, size, device=dev)
        cost = torch.full((size * size,), -1, dtype=torch.int32, device=dev)
        if kernel:
            kern(pix, acc, fb, cost=cost)
        else:
            march._march_frame_torch(ptier, scene["bands"], lp, pix, acc, fb,
                                     size, size, cost)
        torch.cuda.synchronize()
        outs.append((acc, fb, cost))
    for k, p in zip(*outs):
        assert torch.equal(k, p)
    acc, _, cost = outs[0]
    assert int((cost > 1).sum()) > size * size // 4
    assert int((acc[:, 3] > 0).sum()) > size * size // 4


@pytest.mark.parametrize("L", [1, 255, 257, 2_073_601])
def test_cuda_composite_finalize_lanes_match_plain(dev, L):
    """K10's finalize in both modes at lane counts around its 256-thread
    blocks: bit-equal to the plain version."""
    x = _k10_inputs(dev, L, seed=L)
    aid = torch.tensor(5, dtype=torch.int32, device=dev)
    for mode in (composite.FIRST_HIT, composite.MEAN_FIN):
        ak, fk = x["accum"].clone(), x["fb"].clone()
        ap, fp = x["accum"].clone(), x["fb"].clone()
        if mode == composite.FIRST_HIT:
            composite.finalize_first_hit(x["ca"], x["t_min"], x["wrote"], ak,
                                         fk, aid)
            composite._finalize_torch(mode, x["ca"], ap, fp, aid,
                                      t_min=x["t_min"], wrote=x["wrote"])
        else:
            composite.finalize_mean(x["total5"], ak, fk, aid)
            composite._finalize_torch(mode, x["total5"], ap, fp, aid)
        torch.cuda.synchronize()
        assert torch.equal(ak, ap) and torch.equal(fk, fp)


@pytest.mark.parametrize("what", ["total", "accum"])
@pytest.mark.parametrize("mode", ["first_hit", "mean"])
def test_cuda_composite_finalize_rows_off_16_bytes_match_plain(dev, mode,
                                                                what):
    """K10's finalize reads its rows as 4-byte floats: a `total` or `accum`
    view that starts off a 16-byte boundary is taken, bit-equal to the
    plain version; an accum_id that is not a () int32 tensor on the card
    is refused before any launch."""
    L = 300
    x = _k10_inputs(dev, L)
    width = 5 if mode == "mean" and what == "total" else 4
    src = {"total": x["ca"] if mode == "first_hit" else x["total5"],
           "accum": x["accum"]}
    buf = torch.empty(L * width + 1, dtype=torch.float32, device=dev)
    view = buf[1:].view(L, width)
    view.copy_(src[what])
    aid = torch.tensor(2, dtype=torch.int32, device=dev)

    def run(total, accum, fb, kernel, accum_id=aid):
        if mode == "first_hit" and kernel:
            composite.finalize_first_hit(total, x["t_min"], x["wrote"],
                                         accum, fb, accum_id)
        elif mode == "first_hit":
            composite._finalize_torch(composite.FIRST_HIT, total, accum, fb,
                                      accum_id, t_min=x["t_min"],
                                      wrote=x["wrote"])
        elif kernel:
            composite.finalize_mean(total, accum, fb, accum_id)
        else:
            composite._finalize_torch(composite.MEAN_FIN, total, accum, fb,
                                      accum_id)

    got = {"total": src["total"], "accum": x["accum"].clone()}
    got[what] = view
    fk, fp = x["fb"].clone(), x["fb"].clone()
    ap = x["accum"].clone()
    run(got["total"], got["accum"], fk, True)
    run(src["total"], ap, fp, False)
    torch.cuda.synchronize()
    assert torch.equal(got["accum"], ap) and torch.equal(fk, fp)
    before = composite.launches["composite_finalize"]
    for bad in (torch.tensor(2, dtype=torch.int64, device=dev),
                torch.tensor(2, dtype=torch.int32),
                torch.tensor([2], dtype=torch.int32, device=dev)):
        with pytest.raises(ValueError, match="accum_id"):
            run(src["total"], x["accum"].clone(), x["fb"].clone(), True,
                accum_id=bad)
    assert composite.launches["composite_finalize"] == before
