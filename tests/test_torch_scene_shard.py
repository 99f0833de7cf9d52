"""PyTorch port, the latitude-slab scene shard (parallel/scene_shard.py) and
K10's first-hit select: the partition and each slab's tables bit-equal to
JAX's, the salted lane init bit-equal to JAX's `_init_lanes(rng_salt=)`,
the plain K10 select equal to JAX's `_argmin_select`, the D=2 render over
gloo ranks against JAX's render_frame_scene_sharded on two of conftest's
virtual devices, and the slabs x tiles mesh bit-equal to slabs alone."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.shells import build_radial_bands as jbands
from icon_rt_tpu.models.shells import update_band_majorants as jmajorants
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops.camera import Camera
from icon_rt_tpu.ops.fast import _init_lanes as jinit_lanes
from icon_rt_tpu.ops.render import _finalize as jfinalize
from icon_rt_tpu.ops.render import alloc_frame as jalloc
from icon_rt_tpu.ops.render import make_launch_params as jmake_lp
from icon_rt_tpu.parallel import scene_shard as jss
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.ops import composite
from icon_rt_tpu_torch.ops.fast import _init_lanes
from icon_rt_tpu_torch.parallel import ranks
from icon_rt_tpu_torch.parallel.scene_shard import (build_sharded_scene,
                                                    partition_dataset)
from test_torch_fastq import FB_MISMATCH_BOUND

torch.set_num_threads(1)

#: seconds a run of ranks may take before it fails (each plain-K2 sample of
#: a slab rank takes ~1-6 s here: every lane walks its whole ray)
RANKS_TIMEOUT = 300


def run(job, world, tmp_path, **kw):
    return ranks.run_ranks(functools.partial(job, **kw), world, "gloo",
                           timeout=RANKS_TIMEOUT,
                           rendezvous_dir=str(tmp_path), device_type="cpu")


def _setup(W=24, H=24, ud=None):
    """tests/test_scene_shard.py `_setup`: subdiv 2 x 4 layers, view_all
    camera, the unit distance 1e-3 of the inner radius's decade."""
    ds = jsyn.icosphere(subdivisions=2, num_layers=4)
    stats = jstats(ds)
    tf = jmake_tf(value_range=tuple(stats.data_range))
    cam = Camera()
    cam.set_aspect(W / H)
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    if ud is None:
        ud = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
    lp = jmake_lp(cam.basis(W, H), stats.world_bounds_lo,
                  stats.world_bounds_hi, unit_distance=ud)
    return ds, stats, tf, lp


@pytest.mark.parametrize("n_slabs", [1, 2, 3, 8])
def test_torch_partition_matches_jax(n_slabs):
    ds = jsyn.icosphere(subdivisions=2, num_layers=2)
    got = partition_dataset(interop.dataset(ds), n_slabs)
    want = jss.partition_dataset(ds, n_slabs)
    assert len(got) == len(want) == n_slabs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_slabs", [2, 3])
def test_torch_slab_tables_match_jax(n_slabs):
    """Each slab's quantized tables, alpha scale and locator (bins at the
    global k_cap, window, dims) equal JAX's slab before its padding."""
    ds, _, tf, _ = _setup()
    jscene, jk_cap, _ = jss.build_sharded_scene(ds, tf, n_slabs)
    parts = jss.partition_dataset(ds, n_slabs)
    for s in range(n_slabs):
        got, k_cap, _ = build_sharded_scene(interop.dataset(ds),
                                            interop.transfunc(tf), n_slabs,
                                            s, device="cpu")
        assert k_cap == jk_cap
        want = interop.sharded_scene(jscene, s, len(parts[s]), jk_cap)
        for name in want._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          getattr(want, name).numpy(),
                                          err_msg=f"slab {s} {name}")


@pytest.mark.parametrize("salt", [1, 2, 3, 0x7FFFFFFF, 0xFFFFFFFF])
def test_torch_salted_lane_init_matches_jax(salt):
    """rng_salt re-keys the tracking stream bit for bit as JAX's (the salt
    times 2654435761 wraps in u32), and leaves the jittered ray as it is."""
    ds, stats, tf, lp = _setup()
    W = H = 24
    bands = jmajorants(jbands(ds, 16), tf.values, tf.value_range)
    pix = np.arange(W * H, dtype=np.int32)
    ys, xs = np.divmod(pix, W)
    org = np.asarray(lp.cam_org)
    oo = jnp.float32(org[0] * org[0] + org[1] * org[1] + org[2] * org[2])
    lp = lp._replace(accum_id=jnp.int32(5))
    st, consts, _ = jinit_lanes(lp, jnp.asarray(xs), jnp.asarray(ys), W, H,
                                bands.edges, bands.max_opacities, oo, 16,
                                rng_salt=salt)
    tb, tlp = interop.radial_bands(bands), interop.launch_params(lp)
    args = (tlp, torch.from_numpy(xs).long(), torch.from_numpy(ys).long(),
            W, H, tb.edges, tb.max_opacities,
            torch.tensor(float(oo), dtype=torch.float32), 16,
            torch.tensor(5))
    ln = _init_lanes(*args, rng_salt=salt)
    plain = _init_lanes(*args)
    np.testing.assert_array_equal(ln.rng.numpy().astype(np.uint32),
                                  np.asarray(st.rng))
    assert (ln.rng != plain.rng).all()
    for f in ("dx", "dy", "dz", "od", "t", "seg_hi", "wrote"):
        np.testing.assert_array_equal(getattr(ln, f).numpy(),
                                      getattr(plain, f).numpy())
    np.testing.assert_allclose(ln.dx.numpy(), np.asarray(consts.dx),
                               rtol=0, atol=1e-6)


def _crafted(D, L, seed):
    """Per-slab t (D, L) with ties of equal finite t, lanes where every slab
    is +inf, and colours (D, L, 4)."""
    rng = np.random.default_rng(seed)
    t = rng.random((D, L)).astype(np.float32)
    t[rng.random((D, L)) < 0.3] = np.inf     # slabs without a collision
    t[:, :64] = np.inf                       # no slab collides
    t[:, 64:128] = np.float32(0.25)          # every slab ties
    t[1:, 128:192] = t[0, 128:192]           # ties at random values
    ca = rng.random((D, L, 4)).astype(np.float32)
    return t, ca


def _port_select(t, ca, wrote, accum, fb, accum_id):
    """The port's plain K10 first-hit composite over D simulated ranks: the
    masks, the collectives as min/sum over the ranks, the finalize.
    Returns (accum, fb, the reduced payload)."""
    D = t.shape[0]
    tt = [torch.from_numpy(t[s]) for s in range(D)]
    t_min = torch.from_numpy(t.min(axis=0))
    win = torch.stack([composite.select_candidates(tt[s], t_min, s, D)
                       for s in range(D)]).min(0).values
    total = sum(composite.select_payload(tt[s], t_min, win,
                                         torch.from_numpy(ca[s]), s)
                for s in range(D))
    acc = torch.from_numpy(accum.copy())
    pix = torch.from_numpy(fb.view(np.int32).copy())
    composite.finalize_first_hit(total, t_min, torch.from_numpy(wrote), acc,
                                 pix, torch.tensor(accum_id,
                                                   dtype=torch.int32))
    return acc.numpy(), pix.numpy().view(np.uint32), total.numpy()


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_torch_k10_select_plain_matches_jax(n_slabs):
    """The plain K10 select equals JAX's `_argmin_select` (then
    `_finalize`) over a ("slabs",) mesh of conftest's devices: ties go to
    the lowest slab, all-+inf lanes composite to 0."""
    L = 2048
    t, ca = _crafted(n_slabs, L, n_slabs)
    rng = np.random.default_rng(1)
    wrote = rng.random(L) < 0.8
    accum = rng.random((L, 4)).astype(np.float32)
    fb = rng.integers(0, 2 ** 32, L, dtype=np.uint32)
    mesh = Mesh(np.asarray(jax.devices()[:n_slabs]), ("slabs",))

    def body(t_, ca_, w, a, f):
        out = jss._argmin_select(t_[0], ca_[0], "slabs")
        return jfinalize(w, out, a, f, jnp.int32(2))

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P("slabs"), P("slabs"), P(), P(), P()),
                       out_specs=(P(), P()), check_vma=False)
    a_j, f_j = (np.asarray(x) for x in fn(
        jnp.asarray(t), jnp.asarray(ca), jnp.asarray(wrote),
        jnp.asarray(accum), jnp.asarray(fb)))
    a_p, f_p, total = _port_select(t, ca, wrote, accum, fb, 2)
    np.testing.assert_array_equal(a_p, a_j)
    np.testing.assert_array_equal(f_p, f_j)
    # lanes where every slab ties take slab 0's colour; lanes where every
    # slab is +inf composite to a zero sample
    np.testing.assert_array_equal(total[64:128], ca[0, 64:128])
    s = np.float32(1.0) / (np.float32(2.0) + np.float32(1.0))
    w = wrote[:64]
    np.testing.assert_array_equal(a_p[:64][w],
                                  ((np.float32(1.0) - s) * accum[:64])[w])


def _port_slab_tables(ds, tf, lp):
    return dict(ds=interop.dataset(ds), tf=interop.transfunc(tf),
                lp=interop.launch_params(lp))


def test_torch_scene_sharded_matches_jax(tmp_path):
    """D=2 slabs on two gloo ranks against JAX's render_frame_scene_sharded
    on two virtual devices, 2 samples at tests/test_scene_shard.py's scene:
    the same salted streams and first-hit select, within
    test_torch_fastq.py's fb mismatch bound (libm differences move a
    collision across a boundary)."""
    W = H = 24
    spp = 2
    ds, _, tf, lp = _setup(W, H)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("slabs",))
    scene, k_cap, ds_q = jss.build_sharded_scene(ds, tf, 2)
    scene = jss.shard_scene(mesh, scene)
    bands = jmajorants(jbands(ds_q, 64), tf.values, tf.value_range)
    step = jss.jit_render_frame_scene_sharded(mesh, k_cap, width=W,
                                              height=H, chunk=W * H,
                                              donate=False)
    accum, fb = jalloc(W, H)
    for s in range(spp):
        accum, fb = step(scene, bands, tf, lp._replace(accum_id=jnp.int32(s)),
                         accum, fb)
    want = np.asarray(fb)

    got = run(ranks.slab_job, 2, tmp_path,
              inputs=functools.partial(ranks.given,
                                       _port_slab_tables(ds, tf, lp)),
              slabs=2, width=W, height=H, spp=spp)
    assert got[0]["counts"]["composite_mask"] == 0      # the plain versions
    fb_p = got[0]["fb"].view(np.uint32)
    assert (want != 0).sum() > 30            # the view_all globe is small
    assert int((fb_p != want).sum()) <= FB_MISMATCH_BOUND


def test_torch_slabs_by_tiles_equals_slabs(tmp_path):
    """The ("slabs", "tiles") mesh, 2 x 2 on four gloo ranks, renders the
    frame of the ("slabs",) mesh on two, accum and fb bit for bit: the
    tiles only split the pixels."""
    W = H = 24
    ds, _, tf, lp = _setup(W, H, ud=1e4)
    kw = dict(inputs=functools.partial(ranks.given,
                                       _port_slab_tables(ds, tf, lp)),
              slabs=2, width=W, height=H, spp=3)
    one = run(ranks.slab_job, 2, tmp_path, **kw)[0]
    two = run(ranks.slab_job, 4, tmp_path, tiles=2, **kw)[0]
    assert (one["fb"] != 0).sum() > 30
    np.testing.assert_array_equal(two["accum"], one["accum"])
    np.testing.assert_array_equal(two["fb"], one["fb"])
