"""PyTorch port, K1+K4 (the fast tracker and its frame epilogue): the plain
version `_render_frame_fast_torch` through render_frame_fast, held against
its own samples=N contract and against the JAX render_frame_fast on the
same scene, tables and seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models.cells import build_cells as jbuild_cells
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.locator import build_locator as jbuild_locator
from icon_rt_tpu.models.shells import build_radial_bands as jbands
from icon_rt_tpu.models.shells import update_band_majorants as jmajorants
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops.camera import Camera
from icon_rt_tpu.ops.fast import pack_cells as jpack_cells
from icon_rt_tpu.ops.fast import render_frame_fast as jrender
from icon_rt_tpu.ops.order import pixel_order as jpixel_order
from icon_rt_tpu.ops.render import alloc_frame as jalloc
from icon_rt_tpu.ops.render import make_launch_params as jmake_lp
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.ops.fast import render_frame_fast, track_f32
from icon_rt_tpu_torch.ops.render import alloc_frame

torch.set_num_threads(1)

#: per-pixel fb mismatch bound against JAX, measured once on the scenes
#: below after 4 samples: 0 (thick), 6 (thin) and 10 (camera inside the
#: shell, long tangential paths) of 4096 pixels.  Every mismatch is an
#: isolated pixel whose sample took another branch: XLA's and torch's libm
#: log/asin/atan2 differ in the last place, which moves a tentative
#: collision across a layer or column boundary or flips a band-exit
#: compare (the argument of tests/test_golden.py:55-56); the count grows
#: with the steps a sample takes.
FB_MISMATCH_BOUND = 16       # pixels of 64 * 64 (0.4 %)

#: (subdiv, layers, width, camera distance / r_out, unit_distance); a
#: distance below 1 puts the camera inside the shell, looking along it
CASES = {"thick": (2, 5, 48, 1.6, 1e3), "thin": (2, 7, 64, 1.3, 3e3),
         "inside": (2, 7, 64, 0.9975, 3e3)}


class _Scene:
    def __init__(self, sub, layers, w, dist, ud):
        ds = jsyn.icosphere(sub, layers)
        st = jstats(ds)
        self.cells = jbuild_cells(ds)
        self.loc = jbuild_locator(ds)
        tf = jmake_tf(value_range=tuple(st.data_range))
        self.bands = jmajorants(jbands(ds, 64), tf.values, tf.value_range)
        self.packed = jpack_cells(self.cells, tf)
        cam = Camera()
        c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
        v = np.array([2.2, 0.4, 0.9], np.float32)
        v /= np.linalg.norm(v)
        pos = c + v * st.spherical_bounds_hi[0] * dist
        if dist < 1.0:      # inside the shell: look tangentially
            cam.set_orientation(pos, pos + np.cross(v, [0, 0, 1]), v,
                                cam.fovy)
        else:
            cam.set_orientation(pos, c, np.array([0, 0, 1], np.float32),
                                cam.fovy)
        self.w = self.h = w
        self.lp = jmake_lp(cam.basis(w, w), st.world_bounds_lo,
                           st.world_bounds_hi, unit_distance=ud)
        self.perm, self.n_active = jpixel_order(
            self.lp, st.spherical_bounds_lo[0], st.spherical_bounds_hi[0],
            w, w)
        # the port's tables: the same arrays, through interop
        self.t = (interop.cells(self.cells), interop.packed_cells(self.packed),
                  interop.locator(self.loc), interop.radial_bands(self.bands))
        self.tlp = interop.launch_params(self.lp)

    def port(self, accum_id, samples=1, preserve_cache=True, frame=None,
             perm=True):
        acc, fb = frame if frame is not None else alloc_frame(self.w, self.h)
        kw = dict(pixel_perm=torch.from_numpy(self.perm),
                  n_active=self.n_active) if perm else {}
        render_frame_fast(*self.t, self.tlp._replace(
            accum_id=torch.tensor(accum_id, dtype=torch.int32)), acc, fb,
            width=self.w, height=self.h, samples=samples,
            preserve_cache=preserve_cache, **kw)
        return acc, fb

    def jax(self, accum_id, samples=1, preserve_cache=True, frame=None,
            perm=True):
        a, f = frame if frame is not None else jalloc(self.w, self.h)
        kw = dict(pixel_perm=jnp.asarray(self.perm),
                  n_active=self.n_active) if perm else {}
        return jrender(self.cells, self.packed, self.loc, self.bands,
                       self.lp._replace(accum_id=jnp.int32(accum_id)), a, f,
                       width=self.w, height=self.h, samples=samples,
                       preserve_cache=preserve_cache, **kw)


@pytest.fixture(scope="module", params=sorted(CASES))
def scene(request):
    return _Scene(*CASES[request.param])


def _fb(fb):
    return fb.numpy().view(np.uint32) if isinstance(fb, torch.Tensor) \
        else np.asarray(fb)


def test_torch_samples_n_equals_sequential(scene):
    """(a) samples=4 with preserve_cache=False equals one warm sample plus
    4 sequential samples=1 calls, bit for bit (accum and fb), as
    tests/test_fast.py:156 asserts for JAX."""
    seq = scene.port(0)
    for s in range(1, 5):
        seq = scene.port(s, frame=seq)
    bat = scene.port(0)
    bat = scene.port(1, samples=4, preserve_cache=False, frame=bat)
    np.testing.assert_array_equal(bat[0].numpy(), seq[0].numpy())
    np.testing.assert_array_equal(_fb(bat[1]), _fb(seq[1]))
    assert (_fb(seq[1]) != 0).any()


def test_torch_n_active_leaves_tail_untouched():
    """Lanes past n_active keep their accum/fb bits; with the full prefix
    the permuted render is a permutation of the natural-order render."""
    sc = _Scene(*CASES["thick"])
    n = sc.n_active // 2
    acc, fb = alloc_frame(sc.w, sc.h)
    acc[:] = 0.25
    fb[:] = 12345
    render_frame_fast(*sc.t, sc.tlp, acc, fb, width=sc.w, height=sc.h,
                      pixel_perm=torch.from_numpy(sc.perm), n_active=n)
    assert (acc[n:] == 0.25).all() and (fb[n:] == 12345).all()
    perm_acc, perm_fb = sc.port(0)
    nat_acc, nat_fb = sc.port(0, perm=False)
    p = torch.from_numpy(sc.perm).long()
    np.testing.assert_array_equal(perm_fb.numpy(), nat_fb[p].numpy())
    np.testing.assert_array_equal(perm_acc.numpy(), nat_acc[p].numpy())


def test_torch_covered_prefix_is_exact(scene):
    """Tracing only pixel_order's covered prefix (n_active = n_covered, as
    the app launches) gives the same accum and fb bits as tracing every
    lane: no ray past the prefix can write (4 samples, cache kept)."""
    pre_acc, pre_fb = scene.port(0, samples=4)
    acc, fb = alloc_frame(scene.w, scene.h)
    render_frame_fast(*scene.t, scene.tlp, acc, fb, width=scene.w,
                      height=scene.h, pixel_perm=torch.from_numpy(scene.perm),
                      samples=4)
    np.testing.assert_array_equal(pre_acc.numpy(), acc.numpy())
    np.testing.assert_array_equal(pre_fb.numpy(), fb.numpy())


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_torch_fast_per_pixel_vs_jax(scene, mode):
    """(b) Per pixel against JAX render_frame_fast on the same seeds:
    4 sequential samples=1 calls, or one samples=4 call with the column
    cache kept across samples (the app's path).  fb mismatches within
    FB_MISMATCH_BOUND; accum on the agreeing pixels within 2.4e-7 (XLA
    contracts the accumulate lerp into an FMA: <= 2 ULP of values <= 1)."""
    if mode == "sequential":
        pj = tj = None
        for s in range(4):
            tj = scene.jax(s, frame=tj)
            pj = scene.port(s, frame=pj)
    else:
        tj = scene.jax(0, samples=4)
        pj = scene.port(0, samples=4)
    fj, ft = np.asarray(tj[1]), _fb(pj[1])
    mism = fj != ft
    assert (fj != 0).sum() > 100
    assert mism.sum() <= FB_MISMATCH_BOUND, mism.sum()
    aj, at = np.asarray(tj[0]), pj[0].numpy()
    assert np.abs(aj - at)[~mism].max() <= 2.4e-7


def test_torch_fast_mean_image_vs_jax(scene):
    """(c) The 16-sample mean image (one samples=16 call, cache kept) against
    JAX's 16 sequential samples=1 calls: RMSE over accum RGBA <= 2e-3
    (measured 2.2e-8 thick, 2.3e-4 thin, 9.1e-4 inside: the few pixels
    whose samples flipped a boundary carry the whole error, while one
    pixel's 16-sample Monte Carlo noise is of order 0.1)."""
    tj = None
    for s in range(16):
        tj = scene.jax(s, frame=tj)
    pj = scene.port(0, samples=16)
    aj, at = np.asarray(tj[0]), pj[0].numpy()
    assert np.sqrt(((aj - at) ** 2).mean()) <= 2e-3


def reorder_invariance(render, perm, n_active, w, h):
    """The contract of tests/test_fast.py's test_adaptive_reorder_bit_
    identical for a port tracker: three launches of 2 samples, once with
    ops/order.py's K6b re-sort (refine_order_device on the launch's
    return_cost, then repermute_device of accum and fb) between launches
    and once without.  The unpermuted fb and accum are identical, every
    launch's cost (natural pixel order) is identical, is 0 exactly on the
    untraced pixels and >= 1 on every pixel the first launch wrote.
    render(accum_id, perm tensor, accum, fb) -> (accum, fb, cost)."""
    from icon_rt_tpu_torch.ops.order import (inverse_order,
                                             refine_order_device,
                                             repermute_device)

    def run(reorder):
        p = torch.from_numpy(perm)
        acc, fb = alloc_frame(w, h)
        costs, first = [], None
        for k in range(3):
            acc, fb, cost = render(2 * k, p, acc, fb)
            nat = inverse_order(p).long()
            first = _fb(fb[nat]) if first is None else first
            costs.append(cost)
            if reorder:
                p2 = refine_order_device(p, n_active, cost)
                acc, fb = repermute_device(acc, fb, p2, inverse_order(p))
                p = p2
        inv = inverse_order(p).long()
        return acc[inv], fb[inv], costs, p, first

    a0, f0, c0, p0, first = run(False)
    a1, f1, c1, p1, _ = run(True)
    np.testing.assert_array_equal(_fb(f1), _fb(f0))
    np.testing.assert_array_equal(a1.numpy(), a0.numpy())
    assert (_fb(f0) != 0).sum() > 100
    assert not torch.equal(p1, p0)
    traced = np.zeros(w * h, bool)
    traced[perm[:n_active]] = True
    for k in range(3):
        assert torch.equal(c1[k], c0[k])
        cost = c0[k].numpy()
        assert c0[k].dtype == torch.int32 and (cost[~traced] == 0).all()
    assert (c0[0].numpy()[first != 0] >= 1).all()


def test_torch_fast_reorder_keeps_image(scene):
    """K1's return_cost and the K6b re-sort: reorder_invariance."""
    def render(k, p, acc, fb):
        return render_frame_fast(*scene.t, scene.tlp._replace(
            accum_id=torch.tensor(k, dtype=torch.int32)), acc, fb,
            width=scene.w, height=scene.h, pixel_perm=p,
            n_active=scene.n_active, samples=2, return_cost=True)
    reorder_invariance(render, scene.perm, scene.n_active, scene.w, scene.h)


def test_torch_track_f32_rejects_bad_inputs():
    sc = _Scene(*CASES["thick"])
    cells, packed, loc, bands = sc.t
    pix = torch.from_numpy(sc.perm)
    acc, fb = alloc_frame(sc.w, sc.h)
    kw = dict(width=sc.w, height=sc.h)
    with pytest.raises(ValueError):
        track_f32(packed, loc, bands, sc.tlp, pix, acc.double(), fb, **kw)
    with pytest.raises(ValueError):
        track_f32(packed, loc, bands, sc.tlp, pix.long(), acc, fb, **kw)
    with pytest.raises(ValueError):
        track_f32(packed._replace(prof=packed.prof[:, :32]), loc, bands,
                  sc.tlp, pix, acc, fb, **kw)
    with pytest.raises(ValueError):
        track_f32(packed, loc, bands, sc.tlp, pix[:10], acc, fb, **kw)
    with pytest.raises(ValueError):
        track_f32(packed, loc, bands, sc.tlp, pix, acc, fb, samples=0, **kw)
    with pytest.raises(ValueError):
        track_f32(packed, loc, bands, sc.tlp, pix, acc, fb,
                  cost=torch.zeros(sc.w * sc.h - 1, dtype=torch.int32), **kw)
