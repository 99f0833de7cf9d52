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



#: (total, n_active, cost levels): few levels give many ties, which the
#: stable sort must keep in lane order
REFINE_CASES = [(64, 40, 5), (2304, 1500, 1000), (1000, 1000, 3), (50, 0, 4)]


@pytest.mark.parametrize("total,n_active,levels", REFINE_CASES)
def test_torch_refine_order_and_repermute_equal_jax(total, n_active, levels):
    """K6b's plain versions and the host helpers against JAX's on the same
    numpy inputs: refine_order and refine_order_device give JAX's
    permutation (stable among equal costs, tail untouched); refine_keys is
    cost[perm[:n_active]]; refine_perm of the keys' stable order is JAX's
    permutation; repermute and repermute_device give JAX's
    repermute of accum and fb, bit for bit."""
    from icon_rt_tpu.ops.order import refine_order as jrefine
    from icon_rt_tpu.ops.order import refine_order_device as jrefine_dev
    from icon_rt_tpu.ops.order import repermute as jrepermute
    from icon_rt_tpu.ops.order import repermute_device as jrepermute_dev
    from icon_rt_tpu_torch.ops.order import (refine_keys, refine_order,
                                             refine_order_device,
                                             refine_perm, repermute,
                                             repermute_device)
    rng = np.random.default_rng(total + n_active)
    perm = rng.permutation(total).astype(np.int32)
    cost = rng.integers(0, levels, total).astype(np.int32)
    acc = rng.standard_normal((total, 4)).astype(np.float32)
    fb = rng.integers(-2 ** 31, 2 ** 31 - 1, total).astype(np.int32)

    want = jrefine(perm, n_active, cost)
    np.testing.assert_array_equal(
        np.asarray(jrefine_dev(jnp.asarray(perm), n_active,
                               jnp.asarray(cost))), want)
    np.testing.assert_array_equal(refine_order(perm, n_active, cost), want)
    tp, tc = torch.from_numpy(perm), torch.from_numpy(cost)
    np.testing.assert_array_equal(refine_keys(tp, n_active, tc).numpy(),
                                  cost[perm[:n_active]])
    srt = np.argsort(cost[perm[:n_active]], kind="stable").astype(np.int32)
    np.testing.assert_array_equal(
        refine_perm(tp, n_active, torch.from_numpy(srt)).numpy(), want)
    new = refine_order_device(tp, n_active, tc)
    assert new.dtype == torch.int32
    np.testing.assert_array_equal(new.numpy(), want)
    np.testing.assert_array_equal(new.numpy()[n_active:], perm[n_active:])

    for arr in (acc, fb):
        ref = jrepermute(arr, perm, want)
        np.testing.assert_array_equal(repermute(arr, perm, want), ref)
        np.testing.assert_array_equal(
            np.asarray(jrepermute_dev(jnp.asarray(arr), jnp.asarray(perm),
                                      jnp.asarray(want))), ref)
    a2, f2 = repermute_device(torch.from_numpy(acc), torch.from_numpy(fb),
                              new, inverse_order(tp))
    np.testing.assert_array_equal(a2.numpy(), jrepermute(acc, perm, want))
    np.testing.assert_array_equal(f2.numpy(), jrepermute(fb, perm, want))


@pytest.mark.parametrize("n_active", [0, 1, 3])
def test_torch_refine_keys_tail_sizes_equal_jax(n_active):
    """refine_keys at the CUDA kernel's tail sizes (n_active % 4 != 0, and
    no key at all): cost[perm[:n_active]], and refine_order_device on
    those keys gives JAX's numpy refine_order."""
    from icon_rt_tpu.ops.order import refine_order as jrefine
    from icon_rt_tpu_torch.ops.order import refine_keys, refine_order_device
    rng = np.random.default_rng(40 + n_active)
    perm = rng.permutation(37).astype(np.int32)
    cost = rng.integers(0, 3, 37).astype(np.int32)
    tp, tc = torch.from_numpy(perm), torch.from_numpy(cost)
    keys = refine_keys(tp, n_active, tc)
    assert keys.dtype == torch.int32 and keys.shape == (n_active,)
    np.testing.assert_array_equal(keys.numpy(), cost[perm[:n_active]])
    np.testing.assert_array_equal(refine_order_device(tp, n_active,
                                                      tc).numpy(),
                                  jrefine(perm, n_active, cost))


def test_torch_refine_rejects_bad_inputs():
    from icon_rt_tpu_torch.ops.order import (refine_keys, refine_perm,
                                             repermute_device)
    perm = torch.arange(16, dtype=torch.int32)
    cost = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError):
        refine_perm(perm, 4, perm[:5])
    with pytest.raises(ValueError):
        refine_perm(perm, 4, perm[:4].long())
    with pytest.raises(ValueError):
        refine_perm(perm, 17, perm)
    with pytest.raises(ValueError):
        refine_keys(perm.long(), 4, cost)
    with pytest.raises(ValueError):
        refine_keys(perm, 4, cost[:8])
    with pytest.raises(ValueError):
        refine_keys(perm, 17, cost)
    acc = torch.zeros((16, 4))
    with pytest.raises(ValueError):
        repermute_device(acc[:8], cost, perm, perm)
    with pytest.raises(ValueError):
        repermute_device(acc.double(), cost, perm, perm)
    with pytest.raises(ValueError):
        repermute_device(acc, cost, perm, perm[:8])
    with pytest.raises(ValueError):
        repermute_device(acc, cost.long(), perm, perm)
