"""PyTorch port, `render_frame_sharded` (parallel/sharded.py): the parity
raygens (K8's plain version) and the fast raygen over row tiles of the
("tiles", "samples") mesh, against the port's own one-process frames and
the JAX package's render_frame_sharded on conftest's virtual devices, on
the scene of tests/test_sharded.py `_setup`.  The port's ranks are two
gloo processes (parallel/ranks.py `parity_job`), one run of them for every
layout and raygen."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models.accel import build_grid_accel as jgrid
from icon_rt_tpu.models.accel import build_shell_accel as jshell
from icon_rt_tpu.models.accel import update_majorants as jmajorants
from icon_rt_tpu.models.cells import build_cells as jbuild_cells
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.locator import build_locator as jbuild_locator
from icon_rt_tpu.models.shells import build_radial_bands as jbands
from icon_rt_tpu.models.shells import update_band_majorants as jband_maj
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops.camera import Camera
from icon_rt_tpu.ops.fast import pack_cells as jpack_cells
from icon_rt_tpu.ops.render import alloc_frame as jalloc
from icon_rt_tpu.ops.render import make_launch_params as jmake_lp
from icon_rt_tpu.parallel import sharded as jsh
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.ops import fast, render
from icon_rt_tpu_torch.parallel import ranks
from icon_rt_tpu_torch.parallel.sharded import render_frame_sharded
from test_torch_parity import JAX_ACCUM_TOL, JAX_FB_MISMATCH

torch.set_num_threads(1)

W = H = 16
STEPS = 2
#: the shell accel's bins (JAX's default 1 x 1024 x 1024 is far more than
#: a 16x16 frame needs)
SHELL_DIMS = (1, 32, 32)
#: seconds the run of ranks may take before it fails
RANKS_TIMEOUT = 240
#: (name, raygen, accel_mode) of the tiles runs
RAYGENS = [("ae", "ae", "grid"), ("grid", "accel", "grid"),
           ("sphere", "accel", "sphere")]


def _lp(lp, k):
    return lp._replace(accum_id=torch.tensor(k, dtype=torch.int32))


@pytest.fixture(scope="module")
def sc():
    """tests/test_sharded.py `_setup` (subdiv 2 x 4, view_all camera,
    unit distance 1e4, the (16, 16, 16) grid accel) plus a shell accel and
    the fast raygen's 8 radial bands, in both packages."""
    ds = jsyn.icosphere(subdivisions=2, num_layers=4)
    st = jstats(ds)
    cells, loc = jbuild_cells(ds), jbuild_locator(ds)
    tf = jmake_tf(value_range=tuple(st.data_range), size=32)
    acc = {"grid": jmajorants(jgrid(ds, st.world_bounds_lo,
                                    st.world_bounds_hi, (16, 16, 16)),
                              tf.values, tf.value_range),
           "sphere": jmajorants(jshell(ds, st.spherical_bounds_lo,
                                       st.spherical_bounds_hi, SHELL_DIMS),
                                tf.values, tf.value_range)}
    bands = jband_maj(jbands(ds, 8), tf.values, tf.value_range)
    cam = Camera()
    cam.view_all(st.world_bounds_lo, st.world_bounds_hi)
    lp = jmake_lp(cam.basis(W, H), st.world_bounds_lo, st.world_bounds_hi,
                  unit_distance=1e4)
    j = dict(cells=cells, loc=loc, tf=tf, acc=acc, bands=bands, lp=lp,
             packed=jpack_cells(cells, tf))
    t = dict(cells=interop.cells(cells), loc=interop.locator(loc),
             tf=interop.transfunc(tf), lp=interop.launch_params(lp),
             accel={"grid": interop.grid_accel(acc["grid"]),
                    "sphere": interop.shell_accel(acc["sphere"])},
             bands=interop.radial_bands(bands))
    return dict(j=j, t=t)


@pytest.fixture(scope="module")
def two_ranks(sc, tmp_path_factory):
    """One run of two gloo ranks: tiles 2 x samples 1 for every raygen
    (ae, accel grid, accel sphere, fast), then tiles 1 x samples 2 on the
    grid accel, STEPS steps each.  Returns rank 0's runs by name."""
    runs = [dict(tiles=2, samples=1, raygen=r, accel_mode=m, steps=STEPS)
            for _, r, m in RAYGENS]
    runs += [dict(tiles=2, samples=1, raygen="fast", steps=STEPS),
             dict(tiles=1, samples=2, raygen="accel", accel_mode="grid",
                  steps=STEPS)]
    out = ranks.run_ranks(
        functools.partial(ranks.parity_job,
                          inputs=functools.partial(ranks.given, sc["t"]),
                          width=W, height=H, runs=runs),
        2, "gloo", timeout=RANKS_TIMEOUT,
        rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
        device_type="cpu")
    assert all(r["fb"] is None for r in out[1]["runs"])
    names = [n for n, _, _ in RAYGENS] + ["fast", "samples"]
    return dict(zip(names, out[0]["runs"]))


def _one_process(t, name, n_samples):
    """The port's sequential frame of `n_samples` samples of raygen `name`
    in natural order (render_frame_ae / render_frame_accel)."""
    acc, fb = render.alloc_frame(W, H)
    for k in range(n_samples):
        kw = dict(width=W, height=H, sampler="locator", locator=t["loc"])
        if name == "ae":
            render.render_frame_ae(t["cells"], t["tf"], _lp(t["lp"], k), acc,
                                   fb, **kw)
        else:
            render.render_frame_accel(t["cells"], t["tf"], t["accel"][name],
                                      _lp(t["lp"], k), acc, fb,
                                      accel_mode=name, **kw)
    return acc.numpy(), fb.numpy()


def _jax_sharded(j, mesh, raygen, accel_mode):
    """JAX's render_frame_sharded, STEPS steps on `mesh`."""
    step = jsh.jit_render_frame_sharded(mesh, width=W, height=H,
                                        accel_mode=accel_mode,
                                        sampler="locator", raygen=raygen,
                                        donate=False)
    accum, fb = jsh.shard_frame(mesh, *jalloc(W, H))
    for k in range(STEPS):
        accum, fb = step(j["cells"], j["tf"], j["acc"][accel_mode],
                         j["lp"]._replace(accum_id=jnp.int32(k)), accum, fb,
                         j["loc"])
    return np.asarray(jax.device_get(accum)), jsh.gather_frame(fb)


def _against_jax(acc, fb, j_acc, j_fb):
    assert int((fb.view(np.uint32) != j_fb).sum()) <= JAX_FB_MISMATCH
    assert float(np.abs(acc - j_acc).max()) <= JAX_ACCUM_TOL


@pytest.mark.parametrize("name,raygen,accel_mode", RAYGENS,
                         ids=[n for n, _, _ in RAYGENS])
def test_torch_render_frame_sharded_tiles(sc, two_ranks, name, raygen,
                                          accel_mode):
    """Tiles 2 x samples 1 (JAX's :36 contract): two gloo ranks, each a
    block of rows, gather to the one-process frame of render_frame_ae /
    render_frame_accel bit for bit, as does the function without a mesh;
    and against JAX's render_frame_sharded on a (2, 1) mesh within the
    parity bounds of tests/test_torch_parity.py (fb on all but
    JAX_FB_MISMATCH of 256 pixels, accum within JAX_ACCUM_TOL)."""
    t = sc["t"]
    run = two_ranks[name]
    acc1, fb1 = _one_process(t, name, STEPS)
    assert (fb1 != 0).mean() > 0.02
    np.testing.assert_array_equal(run["fb"], fb1)
    np.testing.assert_array_equal(run["accum"], acc1)
    key = f"parity_{'ae' if raygen == 'ae' else accel_mode}_locator"
    assert run["counts"][key] == 0        # CPU tensors: the plain version
    assert set(run["timings"]) >= {"track", "gather"}
    acc, fb = render.alloc_frame(W, H)
    for k in range(STEPS):
        out = render_frame_sharded(None, t["cells"], t["tf"],
                                   t["accel"][accel_mode], _lp(t["lp"], k),
                                   acc, fb, width=W, height=H,
                                   accel_mode=accel_mode, locator=t["loc"],
                                   raygen=raygen)
        assert out[0] is acc and out[1] is fb      # updated in place
    np.testing.assert_array_equal(fb.numpy(), fb1)
    mesh = jsh.make_mesh(devices=jax.devices()[:2], tiles=2, samples=1)
    _against_jax(run["accum"], run["fb"],
                 *_jax_sharded(sc["j"], mesh, raygen, accel_mode))


def test_torch_render_frame_sharded_samples(sc, two_ranks):
    """Tiles 1 x samples 2 on the grid accel: rank s tracks sample 2a + s
    of step a in K8's raw mode and K10's mean composite with one
    all_reduce(SUM) accumulates the pair.  Against JAX on
    make_mesh(devices[:2], tiles=1, samples=2) within the parity bounds (a
    sum of two is exact in any order); against the port's own sequential
    frame of the same 2 * STEPS samples, JAX's :54 coverage contract and
    its :359 image contract (same coverage, 8-bit RMSE < 2 per channel)."""
    run = two_ranks["samples"]
    mesh = jsh.make_mesh(devices=jax.devices()[:2], tiles=1, samples=2)
    _against_jax(run["accum"], run["fb"],
                 *_jax_sharded(sc["j"], mesh, "accel", "grid"))
    a_seq, f_seq = _one_process(sc["t"], "grid", 2 * STEPS)
    a_b = run["accum"]
    cover_b, cover_s = a_b[:, 3] > 0, a_seq[:, 3] > 0
    assert (cover_b == cover_s).mean() > 0.95 and cover_s.mean() > 0.02
    both = cover_b & cover_s
    assert np.abs(a_b[both] - a_seq[both]).mean() < 0.35
    img_m = render.fb_to_image(run["fb"], W, H)
    img_s = render.fb_to_image(f_seq, W, H)
    np.testing.assert_array_equal(img_m[..., 3] > 0, img_s[..., 3] > 0)
    d = img_m.astype(np.float64) - img_s.astype(np.float64)
    rmse = np.sqrt((d * d).mean(axis=(0, 1)))
    assert rmse.max() < 2.0, rmse


def test_torch_render_frame_sharded_fast(sc, two_ranks):
    """raygen "fast" on row tiles (JAX's :86 contract): the two ranks'
    frame equals the port's one-process render_frame_fast, one sample a
    step, bit for bit."""
    t = sc["t"]
    packed = fast.pack_cells(t["cells"], t["tf"])
    acc, fb = render.alloc_frame(W, H)
    for k in range(STEPS):
        fast.render_frame_fast(t["cells"], packed, t["loc"], t["bands"],
                               _lp(t["lp"], k), acc, fb, width=W, height=H)
    run = two_ranks["fast"]
    assert (fb != 0).float().mean() > 0.02
    np.testing.assert_array_equal(run["fb"], fb.numpy())
    np.testing.assert_array_equal(run["accum"], acc.numpy())


def test_torch_render_frame_sharded_rejects_bad_inputs(sc):
    """An unknown raygen raises, as does a pixel count that the tiles axis
    does not divide (tile_pixels; JAX's :105 assertion)."""
    from icon_rt_tpu_torch.parallel.sharded import tile_pixels
    t = sc["t"]
    acc, fb = render.alloc_frame(W, H)
    with pytest.raises(ValueError):
        render_frame_sharded(None, t["cells"], t["tf"], None, t["lp"], acc,
                             fb, width=W, height=H, locator=t["loc"],
                             raygen="march")

    class Mesh3:                 # a tiles axis of 3 ranks
        mesh_dim_names = ("tiles", "samples")

        def size(self, i):
            return (3, 1)[i]

        def get_local_rank(self, name):
            return 0
    with pytest.raises(ValueError):
        tile_pixels(Mesh3(), W, H, torch.device("cpu"))
