"""PyTorch port, the kernels on the card: K1+K4, K5a, K5b and K6 against
their plain PyTorch versions on the same CUDA inputs.  Marked `cuda`: they
skip where no GPU is present (CUDA and Triton kernels have no CPU mode).
On a GPU machine:  python -m pytest tests/test_torch_kernels_cuda.py"""
import numpy as np
import pytest
import torch

from icon_rt_tpu_torch.data import synthetic
from icon_rt_tpu_torch.models import accel
from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
from icon_rt_tpu_torch.models.locator import build_locator
from icon_rt_tpu_torch.models.shells import (build_radial_bands,
                                             update_band_majorants)
from icon_rt_tpu_torch.models.transfunc import make_transfunc
from icon_rt_tpu_torch.ops import fast, order
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


def test_cuda_max_opacity_matches_plain(scene, dev):
    """K5b: exact, on the bands and on random ranges with empty rows."""
    rng = np.random.default_rng(2)
    lo = rng.uniform(-0.2, 1.1, 70_000).astype(np.float32)
    ranges = np.stack([lo, lo + rng.uniform(-0.1, 0.6, lo.size)
                       .astype(np.float32)], axis=1)
    tf = scene["tf"]
    for vr in (scene["bands"].value_ranges,
               torch.from_numpy(ranges).to(dev)):
        got = accel.max_opacity(vr, tf.values, tf.value_range)
        want = accel.compute_max_opacities_torch(vr, tf.values,
                                                 tf.value_range)
        assert torch.equal(got, want)


def test_cuda_chord_keys_match_plain(scene, dev):
    """K6: same coverage, finite keys within 1 ULP."""
    st, lp = scene["st"], scene["lp"]
    cam = order._camera_vector(lp)
    r_in, r_out = st.spherical_bounds_lo[0], st.spherical_bounds_hi[0]
    k = order.chord_keys(cam, r_in, r_out, 96, 96)
    f32 = lambda r: torch.tensor(float(np.float32(r)), device=dev)
    p = order._chord_keys_torch(cam, f32(r_in), f32(r_out), 96, 96)
    fin = torch.isfinite(p)
    assert torch.equal(torch.isfinite(k), fin)
    ik = k[fin].view(torch.int32).long()
    ip = p[fin].view(torch.int32).long()
    assert int((ik - ip).abs().max()) <= 1


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
