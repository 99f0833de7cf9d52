"""PyTorch port, the fast wedge tier (K9-w's plain version: ops/fast.py
`_track_torch` on `_WedgeTier`, through render_frame_fast(sampler=
"wedge")): its packed tables and renders held against the JAX package's
on the same scene, tables and seeds, and the contract of
tests/test_fast_wedge.py (conservative band majorants, sample batching,
statistical agreement with the parity Newton wedge path)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models.cells import build_cells as jbuild_cells
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.locator import build_locator as jbuild_locator
from icon_rt_tpu.models.shells import build_radial_bands_wedge as jbands_w
from icon_rt_tpu.models.shells import update_band_majorants as jmajorants
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops.camera import Camera
from icon_rt_tpu.ops.fast import pack_cells_wedge as jpack_w
from icon_rt_tpu.ops.fast import render_frame_fast as jrender
from icon_rt_tpu.ops.order import pixel_order as jpixel_order
from icon_rt_tpu.ops.render import alloc_frame as jalloc
from icon_rt_tpu.ops.render import make_launch_params as jmake_lp
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.models.shells import (build_radial_bands_wedge,
                                             update_band_majorants)
from icon_rt_tpu_torch.models.transfunc import post_classify
from icon_rt_tpu_torch.models.wedges import bv_all, build_wedges, \
    column_min_norm
from icon_rt_tpu_torch.ops import fast
from icon_rt_tpu_torch.ops.render import alloc_frame, render_frame_ae
from test_torch_fast import FB_MISMATCH_BOUND

torch.set_num_threads(1)

#: fb pixels (of 24 * 24) where the port's fast wedge render may differ
#: from JAX's after 4 samples, the f32 tier's bound (test_torch_fast.py)
#: scaled to this frame; measured: 0 on both scenes below.  A mismatch
#: would be a libm ULP of log/asin/atan2 moving a collision across a face.
WEDGE_FB_MISMATCH = FB_MISMATCH_BOUND * 24 * 24 // 4096 + 1


def _section():
    """tests/test_fast_wedge.py's 4-column section."""
    return jsyn.latlon_section(n_lat=2, n_lon=2, lat_range=(-30, 30),
                               lon_range=(-30, 30), num_layers=3,
                               radius=100.0, thickness=30.0)


def _cam(st, W):
    cam = Camera()
    center = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    diag = np.linalg.norm(st.world_bounds_hi - st.world_bounds_lo)
    cam.set_orientation(center + np.array([0.7 * diag, 0, 0], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    return cam.basis(W, W)


class _Scene:
    """One scene's JAX tables and the port's copies (interop)."""

    def __init__(self, ds, W, ud, size=32):
        self.ds, self.W = ds, W
        self.st = st = jstats(ds)
        self.cells = jbuild_cells(ds)
        self.loc = jbuild_locator(ds)
        self.tf = jmake_tf(value_range=tuple(st.data_range), size=size)
        self.bands = jmajorants(jbands_w(ds, 16), self.tf.values,
                                self.tf.value_range)
        self.packed = jpack_w(self.cells, self.tf)
        self.lp = jmake_lp(_cam(st, W), st.world_bounds_lo,
                           st.world_bounds_hi, unit_distance=ud)
        self.perm, self.n_active = jpixel_order(
            self.lp, st.spherical_bounds_lo[0], st.spherical_bounds_hi[0],
            W, W)
        self.t_cells = interop.cells(self.cells)
        self.t_tf = interop.transfunc(self.tf)
        self.t = (self.t_cells, interop.packed_cells(self.packed),
                  interop.locator(self.loc), interop.radial_bands(self.bands))
        self.tlp = interop.launch_params(self.lp)

    def port(self, accum_id, samples=1, frame=None, preserve_cache=True):
        acc, fb = frame if frame is not None else alloc_frame(self.W, self.W)
        fast.render_frame_fast(
            *self.t, self.tlp._replace(
                accum_id=torch.tensor(accum_id, dtype=torch.int32)),
            acc, fb, width=self.W, height=self.W, samples=samples,
            pixel_perm=torch.from_numpy(self.perm), n_active=self.n_active,
            preserve_cache=preserve_cache, sampler="wedge")
        return acc, fb

    def jax(self, accum_id, samples=1):
        a, f = jalloc(self.W, self.W)
        return jrender(self.cells, self.packed, self.loc, self.bands,
                       self.lp._replace(accum_id=jnp.int32(accum_id)), a, f,
                       width=self.W, height=self.W, samples=samples,
                       pixel_perm=jnp.asarray(self.perm),
                       n_active=self.n_active, sampler="wedge")


SCENES = {"section": lambda: _Scene(_section(), 24, 5.0),
          "icosphere": lambda: _Scene(jsyn.icosphere(2, 5,
                                                     thickness=2.0e6),
                                      24, 2e5, size=256)}


@pytest.fixture(scope="module", params=sorted(SCENES))
def sc(request):
    return SCENES[request.param]()


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max())


def test_torch_pack_cells_wedge_matches_jax(sc):
    """Test rows (the f32 row and n') bit-equal to JAX's; prof and rgb (K5a
    over bv) within 1 ULP (JAX's one-hot LUT sum may contract into FMAs;
    the heights' inf padding equal)."""
    p = fast.pack_cells_wedge(sc.t_cells, sc.t_tf)
    np.testing.assert_array_equal(p.test.numpy(), np.asarray(sc.packed.test))
    assert p.test.shape[1] == fast.TEST_W_WEDGE
    assert float(p.test[:, 16:19].abs().sum()) > 0
    assert _ulp(p.prof.numpy(), sc.packed.prof) <= 1
    assert _ulp(p.rgb.numpy(), sc.packed.rgb) <= 1
    # the bake is K5a over bv_all, not over the cells' values
    prof_v, _ = fast.classify_bake(sc.t_cells, sc.t_tf)
    assert not torch.equal(prof_v, p.prof)


def test_torch_fast_wedge_matches_jax(sc):
    """4 samples in one launch (the column cache kept, as the app runs
    it): fb within WEDGE_FB_MISMATCH pixels of JAX's, accum within 1e-6
    elsewhere; the image is not blank."""
    acc, fb = sc.port(0, samples=4)
    a, f = sc.jax(0, samples=4)
    fb_t = fb.numpy().view(np.uint32)
    differ = fb_t != np.asarray(f)
    assert int(differ.sum()) <= WEDGE_FB_MISMATCH, int(differ.sum())
    same = ~differ
    assert np.abs(acc.numpy()[same] - np.asarray(a)[same]).max() <= 1e-6
    assert (fb_t != 0).sum() > 20


def test_torch_fast_wedge_batched_equals_sequential(sc):
    """tests/test_fast_wedge.py::test_fast_wedge_deterministic_and_batched:
    3 launches of 1 sample equal 1 launch of 3, bit for bit, with the
    column cache kept across samples as the app's default."""
    seq = None
    for s in range(3):
        seq = sc.port(s, frame=seq)
    bat = sc.port(0, samples=3)
    np.testing.assert_array_equal(bat[1].numpy(), seq[1].numpy())
    np.testing.assert_array_equal(bat[0].numpy(), seq[0].numpy())
    assert (seq[1].numpy() != 0).any()


def test_torch_wedge_bands_conservative():
    """tests/test_fast_wedge.py::test_wedge_bands_conservative through the
    port's builders: every wedge's classified bv alpha is bounded by the
    majorants of the bands over its sagitta-inflated radial extent."""
    ds = interop.dataset(_section())
    st = jstats(_section())
    from icon_rt_tpu_torch.models.transfunc import make_transfunc
    tf = make_transfunc(value_range=tuple(st.data_range), size=32)
    bands = update_band_majorants(build_radial_bands_wedge(ds, 16),
                                  tf.values, tf.value_range)
    bv = bv_all(ds.value, ds.num_layers)
    mn = column_min_norm(ds.lat, ds.lon)
    edges = bands.edges.numpy()
    mo = bands.max_opacities.numpy()
    alpha = post_classify(tf, torch.from_numpy(bv.reshape(-1)))[:, 3]
    alpha = alpha.numpy().reshape(bv.shape)
    for i in range(ds.num_cells):
        for L in range(int(ds.num_layers[i])):
            lo = ds.height[i, L] * mn[i]
            hi = ds.height[i, L + 1]
            b0 = np.clip(np.searchsorted(edges, lo, "right") - 1,
                         0, len(mo) - 1)
            b1 = np.clip(np.searchsorted(edges, hi, "left"), 0, len(mo) - 1)
            assert mo[min(b0, b1):max(b0, b1) + 1].max() >= alpha[i, L] - 1e-5


def test_torch_fast_wedge_matches_parity_statistically():
    """tests/test_fast_wedge.py::test_fast_wedge_matches_parity_statistically
    through the port, with its bounds: the converged fast wedge accum
    (32 samples in one launch) against 32 samples of the parity AE raygen
    with the Newton wedge sampler (K9-p's plain version), both sampling
    the same per-wedge-constant bv field."""
    sc = _Scene(_section(), 16, 5.0)
    n_samples = 32
    a_f, _ = alloc_frame(16, 16)
    f_f = torch.zeros(16 * 16, dtype=torch.int32)
    fast.render_frame_fast(*sc.t, sc.tlp, a_f, f_f, width=16, height=16,
                           samples=n_samples, sampler="wedge")
    w = build_wedges(interop.dataset(sc.ds))
    a_p, f_p = alloc_frame(16, 16)
    for s in range(n_samples):
        render_frame_ae(sc.t_cells, sc.t_tf, sc.tlp._replace(
            accum_id=torch.tensor(s, dtype=torch.int32)), a_p, f_p,
            width=16, height=16, sampler="wedge", locator=sc.t[2], wedges=w)
    a_f, a_p = a_f.numpy(), a_p.numpy()
    cover_f, cover_p = a_f[:, 3] > 0, a_p[:, 3] > 0
    # the fast tier writes where the ray meets the shell, parity the AABB
    assert (cover_f == cover_p).mean() > 0.85
    both = cover_f & cover_p
    assert both.sum() > 10
    assert np.abs(a_f[both] - a_p[both]).mean() < 0.11
    assert np.isfinite(a_f).all()
