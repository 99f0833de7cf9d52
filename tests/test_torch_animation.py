"""PyTorch port, the time series (data/animation.py): the Animation's grid
checks, animate_fast against JAX's per timestep, and the north-star
composition animate_fastq_sharded at the 4K frame shape of
tests/test_animation.py over two gloo ranks (parallel/ranks.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.data.animation import Animation as JAnimation
from icon_rt_tpu.data.animation import animate_fast as janimate_fast
from icon_rt_tpu.data.icfile import ICDataset as JICDataset
from icon_rt_tpu.models.cells import build_cells as jbuild_cells
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.locator import build_locator as jbuild_locator
from icon_rt_tpu.models.shells import build_radial_bands as jbands
from icon_rt_tpu.models.shells import update_band_majorants as jmajorants
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops.camera import Camera as JCamera
from icon_rt_tpu.ops.render import make_launch_params as jmake_lp
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.data import synthetic
from icon_rt_tpu_torch.data.animation import (Animation, animate_fast,
                                              animate_fastq_sharded)
from icon_rt_tpu_torch.data.icfile import ICDataset
from icon_rt_tpu_torch.models.cells import compute_stats
from icon_rt_tpu_torch.models.finemap import build_finemap
from icon_rt_tpu_torch.models.locator import build_locator_csr, densify_csr
from icon_rt_tpu_torch.models.qcells import (bake_alpha_q, quantize_cells,
                                             quantize_dataset_values)
from icon_rt_tpu_torch.models.shells import (build_radial_bands,
                                             update_band_majorants)
from icon_rt_tpu_torch.models.transfunc import make_transfunc
from icon_rt_tpu_torch.ops.camera import Camera
from icon_rt_tpu_torch.ops.render import make_launch_params
from icon_rt_tpu_torch.parallel import ranks
from test_torch_fast import FB_MISMATCH_BOUND

torch.set_num_threads(1)

#: seconds the two ranks may take (each orders 8.3M pixels on the CPU)
RANKS_TIMEOUT = 300


def _jseries(n_t=3):
    """tests/test_animation.py `_series`: a 2 x 2 lat/lon section whose
    field scales with t."""
    base = jsyn.latlon_section(n_lat=2, n_lon=2, num_layers=3, radius=100.0,
                               thickness=30.0)
    return [JICDataset(base.lat, base.lon, base.num_layers, base.height,
                       np.clip(base.value * (0.3 + 0.35 * t), 0, 1).astype(
                           np.float32)) for t in range(n_t)]


def test_torch_animation_validates_grid():
    steps = [interop.dataset(d) for d in _jseries()]
    anim = Animation(steps)
    assert anim.num_timesteps == 3
    np.testing.assert_array_equal(anim.values,
                                  JAnimation(_jseries()).values)
    np.testing.assert_array_equal(anim.dataset_at(2).value, steps[2].value)
    with pytest.raises(ValueError):
        Animation([])
    bad = steps[:2]
    bad[1] = ICDataset(bad[1].lat * 1.01, bad[1].lon, bad[1].num_layers,
                       bad[1].height, bad[1].value)
    with pytest.raises(ValueError):
        Animation(bad)
    bad[1] = ICDataset(steps[1].lat, steps[1].lon, steps[1].num_layers,
                       steps[1].height + 1.0, steps[1].value)
    with pytest.raises(ValueError):
        Animation(bad)


def test_torch_animate_fast_matches_jax():
    """Three timesteps, two samples each: K5a re-bakes each timestep's
    values, K1 renders them; each frame against JAX's animate_fast within
    test_torch_fast.py's mismatch bound, and the frames change with t."""
    W = H = 16
    janim = JAnimation(_jseries(3))
    ds0 = janim.geometry
    st = jstats(ds0)
    cells, loc = jbuild_cells(ds0), jbuild_locator(ds0)
    tf = jmake_tf(value_range=(0.0, 1.0), size=32)
    bands = jbands(ds0, 8)
    bands = bands._replace(value_ranges=jnp.tile(
        jnp.asarray([[0.0, 1.0]], jnp.float32), (bands.num_bands, 1)))
    bands = jmajorants(bands, tf.values, tf.value_range)
    cam = JCamera()
    c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    diag = np.linalg.norm(st.world_bounds_hi - st.world_bounds_lo)
    cam.set_orientation(c + np.array([0.7 * diag, 0, 0], np.float32), c,
                        np.array([0, 0, 1], np.float32), cam.fovy)

    def jlp(t, s):
        return jmake_lp(cam.basis(W, H), st.world_bounds_lo,
                        st.world_bounds_hi, unit_distance=5.0, accum_id=s)

    want = list(janimate_fast(janim, cells, loc, bands, tf, jlp, W, H,
                              samples_per_frame=2))
    got = list(animate_fast(interop.animation(janim), interop.cells(cells),
                            interop.locator(loc),
                            interop.radial_bands(bands),
                            interop.transfunc(tf),
                            lambda t, s: interop.launch_params(jlp(t, s)),
                            W, H, samples_per_frame=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 and g.shape == (W * H,)
        assert int((g != np.asarray(w)).sum()) <= FB_MISMATCH_BOUND
    assert not np.array_equal(got[0], got[2])


def _q4k_tables(W, H):
    """tests/test_animation.py's 4K scene on the port's builders: subdiv 1 x
    3 layers quantized, two timesteps (value_q, then value_q * 0.5), bands
    widened to the quantization range, the camera 28 r_out away."""
    ds = synthetic.icosphere(1, 3)
    ds_q, lo, hi = quantize_dataset_values(ds)
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    q = bake_alpha_q(quantize_cells(ds_q), tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap)
    bands = build_radial_bands(ds_q, 8)
    bands = update_band_majorants(bands._replace(
        value_ranges=torch.tensor([[lo, hi]], dtype=torch.float32).repeat(
            bands.num_bands, 1)), tf.values, tf.value_range)
    vq0 = q.value_q
    vq1 = (vq0.to(torch.float32) * 0.5).to(torch.uint8)
    cam = Camera()
    cam.set_aspect(W / H)
    c = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    R = float(stats.spherical_bounds_hi[0])
    cam.set_orientation(c + np.array([28 * R, 4 * R, 9 * R], np.float32), c,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    return dict(q=q, loc=loc, bands=bands, tf=tf, stats=stats, lp=lp,
                value_q=[vq0, vq1], fm=build_finemap(loc, q.test12, k_cap))


def test_torch_animate_fastq_sharded_4k(tmp_path):
    """The full north-star composition at a 3840 x 2160 frame: quantized
    tier, two timesteps (the second halves the field: alpha_q re-baked, not
    kept), the covered prefix dealt over two gloo ranks with the fine map.
    The frames differ between timesteps, and equal one process's without
    the fine map bit for bit (one geometry-only map serves both)."""
    W, H = 3840, 2160
    tables = _q4k_tables(W, H)
    got = ranks.run_ranks(
        functools.partial(ranks.animate_job,
                          inputs=functools.partial(ranks.given, tables),
                          tier="q", width=W, height=H, samples_per_frame=1,
                          tiles=2, chunk=256, finemap=True),
        2, "gloo", timeout=RANKS_TIMEOUT, rendezvous_dir=str(tmp_path),
        device_type="cpu")
    frames = got[0]["frames"]
    assert got[1]["frames"] is None and len(frames) == 2
    assert all(f.shape == (W * H,) and f.dtype == np.uint32 for f in frames)
    assert (frames[0] != 0).any()
    assert not np.array_equal(frames[0], frames[1])
    lp = tables["lp"]
    one = list(animate_fastq_sharded(
        tables["q"], tables["value_q"], tables["loc"], tables["bands"],
        tables["tf"], lambda t, s: lp, None, tables["stats"], W, H,
        samples_per_frame=1, chunk=256))
    for a, b in zip(frames, one):
        np.testing.assert_array_equal(a, b)
