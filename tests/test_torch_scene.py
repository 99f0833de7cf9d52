"""PyTorch port, scene build: the port's host builders against the JAX
package's on the same inputs — icosphere, cells, stats, locator, radial
bands, camera — and K5b's plain version against compute_max_opacities."""
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models import accel as jaccel
from icon_rt_tpu.models.cells import build_cells as jbuild_cells
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.locator import build_locator as jbuild_locator
from icon_rt_tpu.models.shells import build_radial_bands as jbands
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops.camera import Camera as JCamera
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.data import synthetic
from icon_rt_tpu_torch.models.accel import (compute_max_opacities_torch,
                                            max_opacity)
from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
from icon_rt_tpu_torch.models.locator import build_locator
from icon_rt_tpu_torch.models.shells import build_radial_bands
from icon_rt_tpu_torch.ops.camera import Camera

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[(2, 5), (3, 8)])
def scenes(request):
    sub, layers = request.param
    return jsyn.icosphere(sub, layers), synthetic.icosphere(sub, layers)


def test_torch_icosphere_and_cells_equal(scenes):
    """Exact: the same numpy host code gives the same dataset, cells and
    stats; the port's cells also keep their radial shell, [min h_bot,
    max h_top] of the JAX package's cells."""
    jds, tds = scenes
    for f in ("lat", "lon", "num_layers", "height", "value"):
        np.testing.assert_array_equal(getattr(tds, f), getattr(jds, f))
    jc, tc = jbuild_cells(jds), build_cells(interop.dataset(jds))
    assert set(tc._fields) == set(jc._fields) | {"shell"}
    for f in jc._fields:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    np.testing.assert_array_equal(
        tc.shell.numpy()[:2], [np.asarray(jc.h_bot).min(),
                               np.asarray(jc.h_top).max()])
    js, ts = jstats(jds), compute_stats(tds)
    for f in ts._fields:
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))


def test_torch_locator_equal(scenes):
    """Exact: bins and bin-grid parameters, native and numpy paths."""
    jds, tds = scenes
    jl = jbuild_locator(jds)
    for native in (True, False):
        tloc = build_locator(tds, use_native=native)
        for f in tloc._fields:
            np.testing.assert_array_equal(getattr(tloc, f).numpy(),
                                          np.asarray(getattr(jl, f)),
                                          err_msg=f"{f} native={native}")


def test_torch_band_edges_and_ranges_equal(scenes):
    jds, tds = scenes
    jb, tb = jbands(jds, 64), build_radial_bands(tds, 64)
    np.testing.assert_array_equal(tb.edges.numpy(), np.asarray(jb.edges))
    np.testing.assert_array_equal(tb.value_ranges.numpy(),
                                  np.asarray(jb.value_ranges))
    assert tb.num_bands == jb.num_bands == 64


def test_torch_camera_basis_equal(scenes):
    jds, _ = scenes
    st = jstats(jds)
    jc, tc = JCamera(), Camera()
    for c in (jc, tc):
        c.set_aspect(16 / 9)
        c.view_all(st.world_bounds_lo, st.world_bounds_hi)
    for a, b in zip(tc.basis(64, 36), jc.basis(64, 36)):
        np.testing.assert_array_equal(a, b)
    pose = (st.world_bounds_hi * 2.5, st.world_bounds_lo * 0.1,
            np.array([0, 0, 1], np.float32), 0.9)
    jc.set_orientation(*pose)
    tc.set_orientation(*pose)
    for a, b in zip(tc.basis(48, 48), jc.basis(48, 48)):
        np.testing.assert_array_equal(a, b)
    assert tc.to_cli_string() == jc.to_cli_string()


@pytest.mark.parametrize("size", [1, 2, 3, 300, 1024, 4096])
def test_torch_max_opacity_plain_exact(size):
    """K5b plain version: exact against the JAX sparse-table range-max, on
    the bands of a scene and on random finite ranges (empty rows, ranges
    past the TF range), for random LUTs of each size K5b's kernel
    branches on (the smallest, the shared-memory table, the global one)
    and the scene's own 300-entry LUT."""
    rng = np.random.default_rng(11)
    jds = jsyn.icosphere(3, 8)
    st = jstats(jds)
    tf = jmake_tf(value_range=tuple(st.data_range))
    vr = np.asarray(jbands(jds, 64).value_ranges)
    lo = rng.uniform(-0.3, 1.2, 4000).astype(np.float32)
    hi = lo + rng.uniform(-0.2, 0.8, 4000).astype(np.float32)
    rand = np.stack([lo, hi], axis=1)
    rand[::97] = [np.finfo(np.float32).max, -np.finfo(np.float32).max]
    luts = [rng.random((size, 4), np.float32)]
    if size == np.asarray(tf.values).shape[0]:
        luts.append(np.asarray(tf.values))
    for ranges in (vr, rand):
        for lut in luts:
            for trange in (np.asarray(tf.value_range),
                           np.array([0.1, 0.9], np.float32)):
                want = np.asarray(jaccel.compute_max_opacities(
                    ranges, lut, trange))
                args = (torch.from_numpy(np.ascontiguousarray(ranges)),
                        torch.from_numpy(lut), torch.from_numpy(trange))
                got = compute_max_opacities_torch(*args).numpy()
                np.testing.assert_array_equal(got, want)
                # the wrapper runs the plain version for CPU tensors
                np.testing.assert_array_equal(
                    max_opacity(*args).numpy(), want)
