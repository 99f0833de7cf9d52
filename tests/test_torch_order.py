"""PyTorch port, K6 (ray ordering): the plain chord-key version against the
JAX package's _chord_keys, and pixel_order's permutation and n_covered."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.ops.camera import Camera
from icon_rt_tpu.ops.order import _chord_keys
from icon_rt_tpu.ops.order import pixel_order as jpixel_order
from icon_rt_tpu.ops.render import make_launch_params as jmake_lp
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.ops.order import (_camera_vector, _chord_keys_torch,
                                         chord_keys, inverse_order,
                                         pixel_order)

torch.set_num_threads(1)

CASES = [(2, 64, 64, 2.2), (3, 64, 36, 1.3), (3, 48, 48, 6.0)]
KEY_TOL = 2e-5   # of r_out; see test_torch_chord_keys_plain_vs_jax


def _setup(sub, w, h, dist):
    ds = jsyn.icosphere(sub, 5)
    st = jstats(ds)
    cam = Camera()
    cam.set_aspect(w / h)
    c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    v = np.array([2.2, 0.4, 0.9], np.float32)
    v /= np.linalg.norm(v)
    cam.set_orientation(c + v * st.spherical_bounds_hi[0] * dist, c,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    lp = jmake_lp(cam.basis(w, h), st.world_bounds_lo, st.world_bounds_hi)
    return st, lp


@pytest.mark.parametrize("sub,w,h,dist", CASES)
def test_torch_chord_keys_plain_vs_jax(sub, w, h, dist):
    """Coverage (finite vs +inf key): identical.  Finite keys: within
    KEY_TOL = 2e-5 * r_out (128 m; measured max 66 m of r_out = 6.4e6
    m).  The chord
    length subtracts f32 squares of ~4e13 (od*od - oo + r*r), where one
    rounding of od*od is ~4e6; XLA:CPU may contract those products into
    FMAs while the port rounds every operation, so keys differ far beyond
    1 ULP although both are the same f32 formula."""
    st, lp = _setup(sub, w, h, dist)
    r_in, r_out = st.spherical_bounds_lo[0], st.spherical_bounds_hi[0]
    ys, xs = jnp.divmod(jnp.arange(w * h, dtype=jnp.int32), w)
    kj = np.asarray(_chord_keys(lp.cam_org, lp.cam_dir00, lp.cam_du,
                                lp.cam_dv, jnp.float32(r_in),
                                jnp.float32(r_out), xs, ys))
    cam = _camera_vector(interop.launch_params(lp))
    kt = _chord_keys_torch(cam, torch.tensor(np.float32(r_in)),
                           torch.tensor(np.float32(r_out)), w, h).numpy()
    fin = np.isfinite(kj)
    np.testing.assert_array_equal(np.isfinite(kt), fin)
    assert fin.any()
    assert np.abs(kt[fin] - kj[fin]).max() <= KEY_TOL * r_out
    # the wrapper runs the plain version for CPU tensors
    np.testing.assert_array_equal(chord_keys(cam, r_in, r_out, w, h).numpy(),
                                  kt)


@pytest.mark.parametrize("sub,w,h,dist", CASES)
def test_torch_pixel_order_vs_jax(sub, w, h, dist):
    """n_covered: equal.  Permutation: a permutation whose covered prefix
    holds the same pixels as JAX's, and at every sorted position the port's
    pixel has a JAX key within 2 * KEY_TOL of the JAX pixel's key there —
    the orders agree up to swaps of keys closer than the key tolerance."""
    st, lp = _setup(sub, w, h, dist)
    r_in, r_out = st.spherical_bounds_lo[0], st.spherical_bounds_hi[0]
    pj, nj = jpixel_order(lp, r_in, r_out, w, h)
    pt, nt = pixel_order(interop.launch_params(lp), r_in, r_out, w, h)
    pt = pt.numpy()
    assert nt == nj
    assert sorted(pt.tolist()) == list(range(w * h))
    np.testing.assert_array_equal(np.sort(pt[:nt]), np.sort(pj[:nj]))
    ys, xs = jnp.divmod(jnp.arange(w * h, dtype=jnp.int32), w)
    kj = np.asarray(_chord_keys(lp.cam_org, lp.cam_dir00, lp.cam_du,
                                lp.cam_dv, jnp.float32(r_in),
                                jnp.float32(r_out), xs, ys))
    assert np.abs(kj[pt[:nt]] - kj[pj[:nj]]).max() <= 2 * KEY_TOL * r_out
    assert (pt[:nt] == pj[:nj]).mean() > 0.5
    inv = inverse_order(torch.from_numpy(pt)).numpy()
    np.testing.assert_array_equal(inv[pt], np.arange(w * h))
    np.testing.assert_array_equal(inverse_order(pt), inv)

