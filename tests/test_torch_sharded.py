"""PyTorch port, the tile x sample mesh (parallel/sharded.py) and K10's
mean composite: the dealing plan bit-equal to JAX's, the tile-sharded frame
over two gloo ranks bit-equal to one process on both fast tiers, the
samples-axis frame against JAX's render_frame_fast_sharded on a (1, 2)
mesh of conftest's virtual devices, and the plain K10 mean against JAX's
psum composite.  The ranks are processes (parallel/ranks.py `run_ranks`)
with a rendezvous file under tmp_path and a time limit of their own."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models.cells import build_cells as jbuild_cells
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.locator import build_locator as jbuild_locator
from icon_rt_tpu.models.shells import build_radial_bands as jbands
from icon_rt_tpu.models.shells import update_band_majorants as jmajorants
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops.camera import Camera
from icon_rt_tpu.ops.fast import pack_cells as jpack_cells
from icon_rt_tpu.ops.order import pixel_order as jpixel_order
from icon_rt_tpu.ops.render import _finalize as jfinalize
from icon_rt_tpu.ops.render import make_launch_params as jmake_lp
from icon_rt_tpu.parallel import sharded as jsh
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.data.animation import Animation
from icon_rt_tpu_torch.models.cells import compute_stats
from icon_rt_tpu_torch.ops import composite
from icon_rt_tpu_torch.parallel import ranks
from icon_rt_tpu_torch.parallel.sharded import plan_fast_sharding
from test_torch_fast import FB_MISMATCH_BOUND

torch.set_num_threads(1)

#: seconds a run of ranks may take before it fails (each rank imports
#: torch and builds a subdiv-2 scene: ~3-8 s here)
RANKS_TIMEOUT = 240
CPU = torch.device("cpu")


def run(job, world, tmp_path, **kw):
    return ranks.run_ranks(functools.partial(job, **kw), world, "gloo",
                           timeout=RANKS_TIMEOUT,
                           rendezvous_dir=str(tmp_path), device_type="cpu")


@pytest.mark.parametrize("n_active,n_tiles,chunk",
                         [(1, 1, 16), (700, 2, 16), (4096, 8, 4096),
                          (4097, 3, 256), (0, 4, 16)])
def test_torch_plan_fast_sharding_matches_jax(n_active, n_tiles, chunk):
    perm = np.random.default_rng(n_active).permutation(5000).astype(
        np.int32)
    np.testing.assert_array_equal(
        plan_fast_sharding(perm, n_active, n_tiles, chunk),
        jsh.plan_fast_sharding(perm, n_active, n_tiles, chunk))


@pytest.mark.parametrize("tier", ["f32", "q"])
def test_torch_tile_sharded_frame_equals_one_process(tier, tmp_path):
    """Two gloo ranks dealing the covered prefix round-robin render the
    frame of one process bit for bit: a lane's samples depend only on its
    pixel and sample id (the quantized tier with its fine map)."""
    W, H = 32, 24
    kw = dict(inputs=functools.partial(ranks.synthetic_scene, tier, 2, 4, W,
                                       H),
              tier=tier, width=W, height=H, samples_per_frame=2, chunk=64,
              finemap=tier == "q")
    one = ranks.animate_job(0, 1, "gloo", CPU, mesh=False, **kw)
    two = run(ranks.animate_job, 2, tmp_path, tiles=2, **kw)
    assert two[1]["frames"] is None
    (f1,), (f2,) = one["frames"], two[0]["frames"]
    assert (f1 != 0).sum() > 100
    np.testing.assert_array_equal(f2, f1)


class _JaxScene:
    """The scene of tests/test_sharded.py `test_fast_sharded_cost_dealt`."""

    def __init__(self, W=32, H=24):
        ds = jsyn.icosphere(subdivisions=2, num_layers=4)
        st = jstats(ds)
        self.cells, self.loc = jbuild_cells(ds), jbuild_locator(ds)
        self.tf = jmake_tf(value_range=tuple(st.data_range), size=32)
        self.bands = jmajorants(jbands(ds, 8), self.tf.values,
                                self.tf.value_range)
        self.packed = jpack_cells(self.cells, self.tf)
        cam = Camera()
        cam.set_aspect(W / H)
        c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
        R = float(st.spherical_bounds_hi[0])
        cam.set_orientation(c + np.array([1.8 * R, 0.3 * R, 0.7 * R],
                                         np.float32),
                            c, np.array([0, 0, 1], np.float32), cam.fovy)
        self.lp = jmake_lp(cam.basis(W, H), st.world_bounds_lo,
                           st.world_bounds_hi, unit_distance=1e4)
        self.perm, self.n_active = jpixel_order(
            self.lp, st.spherical_bounds_lo[0], st.spherical_bounds_hi[0],
            W, H)
        self.ds, self.st, self.W, self.H = ds, st, W, H

    def port_tables(self):
        ds = interop.dataset(self.ds)
        return dict(anim=Animation([ds]), cells=interop.cells(self.cells),
                    loc=interop.locator(self.loc),
                    bands=interop.radial_bands(self.bands),
                    tf=interop.transfunc(self.tf), stats=compute_stats(ds),
                    lp=interop.launch_params(self.lp))


def test_torch_samples_axis_matches_jax(tmp_path):
    """tiles=1 x samples=2: rank s traces sample 2a + s of launch a in raw
    mode, K10's mean composite and one all_reduce(SUM) accumulate the pair
    -- against JAX's render_frame_fast_sharded on the same (1, 2) mesh
    shape, two launches, within test_torch_fast.py's mismatch bound."""
    sc = _JaxScene()
    W, H, chunk = sc.W, sc.H, 16
    mesh = jsh.make_mesh(jax.devices()[:2], tiles=1, samples=2)
    local = jsh.plan_fast_sharding(sc.perm, sc.n_active, 1, chunk)
    step = jsh.jit_render_frame_fast_sharded(mesh, width=W, height=H,
                                             chunk=chunk, donate=False)
    accum, fb = jsh.alloc_fast_sharded_frame(mesh, local)
    pix = jsh.shard_local_pix(mesh, local)
    for a in range(2):
        accum, fb = step(sc.cells, sc.packed, sc.loc, sc.bands,
                         sc.lp._replace(accum_id=jnp.int32(a)), accum, fb,
                         pix)
    want = jsh.scatter_fast_frame(jsh.gather_frame(fb), local, W, H)

    got = run(ranks.animate_job, 2, tmp_path,
              inputs=functools.partial(ranks.given, sc.port_tables()),
              tier="f32", width=W, height=H, samples_per_frame=2, tiles=1,
              samples=2, chunk=chunk)
    frame = got[0]["frames"][0]
    assert got[1]["frames"] is None
    assert (want != 0).sum() > 100
    assert int((frame != want).sum()) <= FB_MISMATCH_BOUND


def test_torch_samples_axis_equals_sequential_where_all_wrote(tmp_path):
    """The samples axis's documented semantics (icon_rt_tpu/parallel/
    sharded.py:14-20): pixels every one of whose samples wrote equal the
    sequential frame of the same samples (accum within 1e-6; the batch
    mean and the running mean round differently), and K10's mean equals
    the plain mean on the reduced buffer of every rank."""
    W, H = 32, 24
    got = run(ranks.samples_job, 2, tmp_path,
              inputs=functools.partial(ranks.synthetic_scene, "f32", 2, 4,
                                       W, H),
              width=W, height=H, launches=2, samples=2, reference=True)
    r0 = got[0]
    aw = r0["all_wrote"]
    assert all(r["mean_equal"] for r in got)
    assert aw.sum() > 100
    np.testing.assert_allclose(r0["accum"][aw], r0["ref_accum"][aw],
                               rtol=0, atol=1e-6)
    # silhouettes: a pixel whose samples did not all write may differ
    assert ((r0["accum"][:, 3] > 0) == (r0["ref_accum"][:, 3] > 0)).all()


def _jax_psum_mean(wrote, ca, accum, fb, accum_id):
    """JAX's samples-axis composite (icon_rt_tpu/parallel/sharded.py:
    243-248, then `_finalize`) over a mesh of S virtual devices: wrote
    (S, L), ca (S, L, 4) one row per device."""
    S = wrote.shape[0]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:S]), ("samples",))

    def body(w, c, a, f):
        w, c = w[0], c[0]
        n_wrote = jax.lax.psum(w.astype(jnp.float32), "samples")
        ca_sum = jax.lax.psum(jnp.where(w[:, None], c, 0.0), "samples")
        return jfinalize(n_wrote > 0.0,
                         ca_sum / jnp.maximum(n_wrote, 1.0)[:, None], a, f,
                         jnp.int32(accum_id))

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P("samples"), P("samples"), P(), P()),
                       out_specs=(P(), P()), check_vma=False)
    a, f = fn(jnp.asarray(wrote), jnp.asarray(ca), jnp.asarray(accum),
              jnp.asarray(fb))
    return np.asarray(a), np.asarray(f)


@pytest.mark.parametrize("n_samples", [2, 4])
def test_torch_k10_mean_plain_matches_jax_psum(n_samples):
    """The plain K10 mean (mask per rank, the ranks' sum, finalize) equals
    JAX's two psums and `_finalize` on crafted inputs: lanes no sample
    wrote, lanes every sample wrote, mixed lanes, zero colours; colours on
    a 1/256 grid, so the sums are exact in any order."""
    rng = np.random.default_rng(7)
    L = 4096
    wrote = rng.random((n_samples, L)) < 0.6
    wrote[:, :64] = False
    wrote[:, 64:128] = True
    # multiples of 1/256: every order of the sums rounds alike
    ca = (rng.integers(0, 257, (n_samples, L, 4)) / 256).astype(np.float32)
    ca[:, 128:192] = 0.0
    accum = rng.random((L, 4)).astype(np.float32)
    fb = rng.integers(0, 2 ** 32, L, dtype=np.uint32)
    a_j, f_j = _jax_psum_mean(wrote, ca, accum, fb, accum_id=3)

    total = sum(composite.mean_payload(torch.from_numpy(wrote[s]),
                                       torch.from_numpy(ca[s]))
                for s in range(n_samples))
    acc_t = torch.from_numpy(accum.copy())
    fb_t = torch.from_numpy(fb.view(np.int32).copy())
    composite.finalize_mean(total, acc_t, fb_t,
                            torch.tensor(3, dtype=torch.int32))
    np.testing.assert_array_equal(acc_t.numpy(), a_j)
    np.testing.assert_array_equal(fb_t.numpy().view(np.uint32), f_j)
    assert not (fb_t.numpy().view(np.uint32) == fb).all()
