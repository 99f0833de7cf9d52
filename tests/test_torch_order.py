"""PyTorch port, K6 (ray ordering): the plain chord-key version and its
covered count against the JAX package's _chord_keys and pixel_order, and
pixel_order's permutation and n_covered; K6b (the measured-cost re-sort)
against JAX's refine_order, refine_order_device and repermute."""
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
from icon_rt_tpu_torch.ops.order import (_camera, _chord_keys_torch,
                                         chord_keys, inverse_order,
                                         pixel_order)

torch.set_num_threads(1)

CASES = [(2, 64, 64, 2.2), (3, 64, 36, 1.3), (3, 48, 48, 6.0)]
KEY_TOL = 2e-5   # of r_out; see test_torch_chord_keys_plain_vs_jax


def _setup(sub, w, h, dist):
    """The JAX stats and launch params of a camera at `dist` outer radii
    from the globe's center, looking at it; dist "shell" puts the camera
    midway between the inner and the outer shell, "away" at 2.2 outer
    radii looking away from the globe."""
    ds = jsyn.icosphere(sub, 5)
    st = jstats(ds)
    cam = Camera()
    cam.set_aspect(w / h)
    c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    v = np.array([2.2, 0.4, 0.9], np.float32)
    v /= np.linalg.norm(v)
    r_in, r_out = st.spherical_bounds_lo[0], st.spherical_bounds_hi[0]
    if dist == "shell":
        pos = c + v * (0.5 * (r_in + r_out))
    elif dist == "away":
        pos = c + v * (2.2 * r_out)
    else:
        pos = c + v * r_out * dist
    target = pos + v if dist == "away" else c
    cam.set_orientation(pos, target, np.array([0, 0, 1], np.float32),
                        cam.fovy)
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
    cam = _camera(interop.launch_params(lp))
    kt, nt = _chord_keys_torch(cam, torch.tensor(np.float32(r_in)),
                               torch.tensor(np.float32(r_out)), w, h)
    kt = kt.numpy()
    fin = np.isfinite(kj)
    np.testing.assert_array_equal(np.isfinite(kt), fin)
    assert fin.any()
    assert np.abs(kt[fin] - kj[fin]).max() <= KEY_TOL * r_out
    # the wrapper runs the plain version for CPU tensors
    keys, n = chord_keys(cam, r_in, r_out, w, h)
    np.testing.assert_array_equal(keys.numpy(), kt)
    assert torch.equal(n, nt)


#: CASES and two cameras whose coverage is whole or empty: inside the
#: outer shell (every ray leaves through it) and looking away from the
#: globe (every key +inf)
COUNT_CASES = CASES + [(3, 40, 30, "shell"), (2, 40, 30, "away")]


@pytest.mark.parametrize("sub,w,h,dist", COUNT_CASES)
def test_torch_chord_keys_count_vs_jax(sub, w, h, dist):
    """K6's covered count, taken in the keys' own pass (the kernel's
    per-block count; the plain version's isfinite(keys).sum()), equals JAX
    pixel_order's n_covered and the count of np.isfinite of JAX's
    _chord_keys, exactly; the coverage masks are identical.  The count is
    a (1,) int32 tensor from the wrapper and the plain version alike."""
    st, lp = _setup(sub, w, h, dist)
    r_in, r_out = st.spherical_bounds_lo[0], st.spherical_bounds_hi[0]
    ys, xs = jnp.divmod(jnp.arange(w * h, dtype=jnp.int32), w)
    kj = np.asarray(_chord_keys(lp.cam_org, lp.cam_dir00, lp.cam_du,
                                lp.cam_dv, jnp.float32(r_in),
                                jnp.float32(r_out), xs, ys))
    _, nj = jpixel_order(lp, r_in, r_out, w, h)
    keys, n = chord_keys(_camera(interop.launch_params(lp)), r_in, r_out,
                         w, h)
    assert n.dtype == torch.int32 and n.shape == (1,)
    np.testing.assert_array_equal(np.isfinite(keys.numpy()), np.isfinite(kj))
    assert int(n) == nj == int(np.isfinite(kj).sum())
    if dist == "shell":
        assert nj == w * h
    if dist == "away":
        assert nj == 0 and np.all(keys.numpy() == np.inf)
    assert pixel_order(interop.launch_params(lp), r_in, r_out, w, h)[1] == nj


def test_torch_chord_keys_rejects_bad_inputs():
    st, lp = _setup(2, 8, 8, 2.2)
    cam = _camera(interop.launch_params(lp))
    r = st.spherical_bounds_lo[0], st.spherical_bounds_hi[0]
    with pytest.raises(ValueError):
        chord_keys(cam[:3], *r, 8, 8)
    with pytest.raises(ValueError):
        chord_keys((cam[0].double(),) + cam[1:], *r, 8, 8)
    with pytest.raises(ValueError):
        chord_keys((torch.cat([cam[0], cam[1]]),) + cam[1:], *r, 8, 8)
    with pytest.raises(ValueError):
        chord_keys(cam, *r, 8, 0)


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


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("total,n_active,levels", REFINE_CASES)
def test_torch_refine_perm_order_dtypes_equal_jax(total, n_active, levels,
                                                  dtype):
    """refine_perm takes the keys' sorting permutation as torch.sort gives
    it (int64) or as int32: both give the same permutation, equal to JAX's
    refine_order_device on the same numpy inputs; refine_order_device,
    which hands the sort's int64 indices over as they come, gives it
    too."""
    from icon_rt_tpu.ops.order import refine_order_device as jrefine_dev
    from icon_rt_tpu_torch.ops.order import (refine_keys, refine_order_device,
                                             refine_perm)
    rng = np.random.default_rng(total + n_active)
    perm = rng.permutation(total).astype(np.int32)
    cost = rng.integers(0, levels, total).astype(np.int32)
    want = np.asarray(jrefine_dev(jnp.asarray(perm), n_active,
                                  jnp.asarray(cost)))
    tp, tc = torch.from_numpy(perm), torch.from_numpy(cost)
    srt = torch.sort(refine_keys(tp, n_active, tc), stable=True).indices
    assert srt.dtype == torch.int64
    got = refine_perm(tp, n_active, srt.to(dtype))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(refine_order_device(tp, n_active,
                                                      tc).numpy(), want)


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
        refine_perm(perm, 4, perm[:4].to(torch.int16))
    with pytest.raises(ValueError):
        refine_perm(perm.long(), 4, perm[:4])
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
