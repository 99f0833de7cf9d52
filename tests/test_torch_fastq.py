"""PyTorch port, K2 (the quantized tracker and its frame epilogue): the
plain version `_render_frame_fast_q_torch` through render_frame_fast_q,
held against JAX render_frame_fast_q on the same quantized tables, locator,
fine map and seeds, and against its own samples=N and two-stage contracts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.finemap import build_finemap as jbuild_finemap
from icon_rt_tpu.models.locator import build_locator_csr as jcsr
from icon_rt_tpu.models.locator import densify_csr as jdensify
from icon_rt_tpu.models.qcells import bake_alpha_q as jbake
from icon_rt_tpu.models.qcells import quantize_cells as jquantize
from icon_rt_tpu.models.qcells import quantize_dataset_values as jqvalues
from icon_rt_tpu.models.shells import build_radial_bands as jbands
from icon_rt_tpu.models.shells import update_band_majorants as jmajorants
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops.camera import Camera
from icon_rt_tpu.ops.fastq import render_frame_fast_q as jrender_q
from icon_rt_tpu.ops.order import pixel_order as jpixel_order
from icon_rt_tpu.ops.render import alloc_frame as jalloc
from icon_rt_tpu.ops.render import make_launch_params as jmake_lp
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.ops.fastq import render_frame_fast_q, track_q
from icon_rt_tpu_torch.ops.render import alloc_frame
from test_torch_fast import reorder_invariance

torch.set_num_threads(1)

#: per-pixel fb mismatch bound against JAX, measured once after 4 samples
#: (cache kept), fine map on or off, with a TF range off the value grid:
#: 1 (thick) and 2 (thin) pixels.  Such a mismatch is a pixel whose sample
#: took another branch because XLA's and torch's libm log/asin/atan2, or
#: XLA's FMA contraction of a dequantized height, differ in the last place;
#: the f32 tier's bound (test_torch_fast.py) applies.
FB_MISMATCH_BOUND = 16       # pixels of 64 * 64 (0.4 %)

#: the bound with the app's default TF range, which is the data range: the
#: quantized value levels k = 17 m then sit exactly on LUT cell edges
#: (k / 255 * 300 is an integer), where the reference's asymmetric lerp is
#: discontinuous.  XLA evaluates value_lo + vq * ((hi - lo) / 255) as
#: fma(vq, (hi - lo) * (1 / 255), value_lo) (its HLO for the expression),
#: the port and the K2 kernel in the written order with every operation
#: rounded, so the two land on either side of an edge for those levels and
#: every pixel whose accepted sample has one gets another colour.
#: Measured once: 83 of 2304 pixels differ in fb (80) or accum (thick,
#: 3.6 %); 7 of 4096 (thin).
APP_TF_MISMATCH_BOUND = 96   # pixels of 48 * 48 (4.2 %)

#: (subdiv, layers, width, camera distance / r_out, unit_distance, TF range
#: padding as a fraction of the data range; 0 = the app's default)
CASES = {"thick": (2, 5, 48, 1.6, 1e3, 0.0123),
         "thin": (3, 7, 64, 1.3, 3e3, 0.0123),
         "thick_app_tf": (2, 5, 48, 1.6, 1e3, 0.0)}


class _Scene:
    """The app's quantized tier (apps/icon_rt.py get_q): values snapped to
    the 256-level grid, bands and TF range from the unquantized dataset
    (the range widened by tf_pad), CSR-binned locator, fine map at factor
    2."""

    def __init__(self, sub, layers, w, dist, ud, tf_pad):
        ds = jsyn.icosphere(sub, layers)
        st = jstats(ds)
        ds_q, lo, hi = jqvalues(ds)
        vlo, vhi = (float(v) for v in st.data_range)
        pad = tf_pad * (vhi - vlo)
        tf = jmake_tf(value_range=(vlo - pad, vhi + 0.7 * pad))
        self.q = jbake(jquantize(ds_q, value_range=(lo, hi)), tf)
        csr, self.k_cap = jcsr(ds_q)
        self.loc = jdensify(csr, self.k_cap)
        self.fm = jbuild_finemap(self.loc, self.q.test12, self.k_cap,
                                 factor=2)
        self.bands = jmajorants(jbands(ds, 64), tf.values, tf.value_range)
        self.tf = tf
        cam = Camera()
        c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
        v = np.array([2.2, 0.4, 0.9], np.float32)
        v /= np.linalg.norm(v)
        cam.set_orientation(c + v * st.spherical_bounds_hi[0] * dist, c,
                            np.array([0, 0, 1], np.float32), cam.fovy)
        self.w = w
        self.lp = jmake_lp(cam.basis(w, w), st.world_bounds_lo,
                           st.world_bounds_hi, unit_distance=ud)
        self.perm, self.n_active = jpixel_order(
            self.lp, st.spherical_bounds_lo[0], st.spherical_bounds_hi[0],
            w, w)
        # the port's tables: the same arrays, through interop
        self.t = dict(q=interop.quantized_cells(self.q, n=ds.num_cells),
                      loc=interop.locator_packed(self.loc, self.k_cap),
                      bands=interop.radial_bands(self.bands),
                      tf=interop.transfunc(tf))
        self.tfm = interop.finemap(self.fm)
        self.tlp = interop.launch_params(self.lp)

    def port(self, accum_id, samples=1, preserve_cache=True, frame=None,
             fm=True):
        acc, fb = frame if frame is not None else alloc_frame(self.w, self.w)
        t = self.t
        render_frame_fast_q(
            t["q"], t["loc"], t["bands"], t["tf"], self.tlp._replace(
                accum_id=torch.tensor(accum_id, dtype=torch.int32)),
            acc, fb, width=self.w, height=self.w,
            pixel_perm=torch.from_numpy(self.perm), n_active=self.n_active,
            samples=samples, preserve_cache=preserve_cache,
            finemap=self.tfm if fm else None)
        return acc, fb

    def jax(self, samples, fm):
        a, f = jalloc(self.w, self.w)
        return jrender_q(self.q, self.loc, self.k_cap, self.bands, self.tf,
                         self.lp, a, f, width=self.w, height=self.w,
                         pixel_perm=jnp.asarray(self.perm),
                         n_active=self.n_active, samples=samples,
                         finemap=self.fm if fm else None)


@pytest.fixture(scope="module", params=sorted(CASES))
def scene(request):
    sc = _Scene(*CASES[request.param])
    sc.bound = APP_TF_MISMATCH_BOUND if request.param == "thick_app_tf" \
        else FB_MISMATCH_BOUND
    return sc


def _fb(fb):
    return fb.numpy().view(np.uint32) if isinstance(fb, torch.Tensor) \
        else np.asarray(fb)


@pytest.mark.parametrize("fm", [True, False], ids=["finemap", "no_finemap"])
def test_torch_fastq_per_pixel_vs_jax(scene, fm):
    """One samples=4 call, column cache kept (the app's path), against JAX
    on the same seeds: fb mismatches within FB_MISMATCH_BOUND and accum on
    the agreeing pixels within 2.4e-7 (XLA contracts the accumulate lerp
    into an FMA: <= 2 ULP of values <= 1).  With the app's TF range, the
    pixels that differ in fb or in accum by more than 2.4e-7 are within
    APP_TF_MISMATCH_BOUND."""
    aj, fj = scene.jax(4, fm)
    at, ft = scene.port(0, samples=4, fm=fm)
    fj, ft = np.asarray(fj), _fb(ft)
    mism = fj != ft
    far = np.abs(np.asarray(aj) - at.numpy()).max(1) > 2.4e-7
    assert (fj != 0).sum() > 100
    if scene.bound == FB_MISMATCH_BOUND:
        assert mism.sum() <= scene.bound, mism.sum()
        assert not far[~mism].any()
    else:
        assert (mism | far).sum() <= scene.bound, (mism | far).sum()


def test_torch_fastq_samples_n_equals_sequential(scene):
    """samples=4 with preserve_cache=False equals one warm sample plus 4
    sequential samples=1 calls, bit for bit (accum and fb)."""
    seq = scene.port(0)
    for s in range(1, 5):
        seq = scene.port(s, frame=seq)
    bat = scene.port(0)
    bat = scene.port(1, samples=4, preserve_cache=False, frame=bat)
    np.testing.assert_array_equal(bat[0].numpy(), seq[0].numpy())
    np.testing.assert_array_equal(_fb(bat[1]), _fb(seq[1]))
    assert (_fb(seq[1]) != 0).any()


@pytest.mark.parametrize("preserve_cache", [True, False])
def test_torch_fastq_finemap_on_equals_off(scene, preserve_cache):
    """The two-stage locate is exact: with and without the fine map the
    render is bit-identical (a stage-1 hit fills the column the full query
    returns)."""
    on = scene.port(0, samples=3, preserve_cache=preserve_cache, fm=True)
    off = scene.port(0, samples=3, preserve_cache=preserve_cache, fm=False)
    np.testing.assert_array_equal(on[0].numpy(), off[0].numpy())
    np.testing.assert_array_equal(_fb(on[1]), _fb(off[1]))


def test_torch_fastq_reorder_keeps_image(scene):
    """K2's return_cost and the K6b re-sort, fine map on: test_torch_fast.py
    `reorder_invariance`."""
    t = scene.t

    def render(k, p, acc, fb):
        return render_frame_fast_q(
            t["q"], t["loc"], t["bands"], t["tf"], scene.tlp._replace(
                accum_id=torch.tensor(k, dtype=torch.int32)), acc, fb,
            width=scene.w, height=scene.w, pixel_perm=p,
            n_active=scene.n_active, samples=2, finemap=scene.tfm,
            return_cost=True)
    reorder_invariance(render, scene.perm, scene.n_active, scene.w, scene.w)


def test_torch_track_q_rejects_bad_inputs():
    sc = _Scene(*CASES["thick"])
    t = sc.t
    pix = torch.from_numpy(sc.perm)
    acc, fb = alloc_frame(sc.w, sc.w)
    kw = dict(width=sc.w, height=sc.w)
    args = (t["loc"], t["bands"], t["tf"], sc.tlp)
    with pytest.raises(ValueError):
        track_q(t["q"], *args, pix, acc.double(), fb, **kw)
    with pytest.raises(ValueError):
        track_q(t["q"]._replace(value_q=t["q"].value_q.to(torch.int32)),
                *args, pix, acc, fb, **kw)
    with pytest.raises(ValueError):
        track_q(t["q"]._replace(h_frac=t["q"].h_frac[:, :4].contiguous()),
                *args, pix, acc, fb, **kw)
    with pytest.raises(ValueError):
        track_q(t["q"], *args, pix[:10], acc, fb, **kw)
    with pytest.raises(ValueError):
        track_q(t["q"], *args, pix, acc, fb, samples=0, **kw)
    with pytest.raises(ValueError):
        track_q(t["q"], *args, pix, acc, fb, finemap=sc.tfm._replace(
            slots=sc.tfm.slots[:-1]), **kw)
