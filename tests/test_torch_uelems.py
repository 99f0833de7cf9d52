"""PyTorch port, the Newton intersectors of unstructured elements
(ops/uelems.py, the plain version of K9-n and of K9-p's inversion): held
against the JAX package's intersect_* on the same seeded elements and
points, the unit-element cases of tests/test_uelems.py and the scalar
oracle tests/refimpl.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refimpl
from icon_rt_tpu.ops import uelems as juelems
from icon_rt_tpu_torch.ops import uelems

torch.set_num_threads(1)

UNIT = {
    "wedge": np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                       [0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32),
    "pyramid": np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                         [0.5, 0.5, 1]], np.float32),
    "hex": np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                    np.float32),
}
JAX_FN = {"wedge": juelems.intersect_wedge,
          "pyramid": juelems.intersect_pyramid, "hex": juelems.intersect_hex}
PORT_FN = {"wedge": uelems.intersect_wedge,
           "pyramid": uelems.intersect_pyramid, "hex": uelems.intersect_hex}
#: inside flags equal to JAX's on at least this share of the points, and
#: values within VALUE_TOL where both are inside.  Measured on the CPU:
#: every flag equal and values within 1.8e-7 for all three shapes; XLA may
#: contract the vertex sums into FMAs, so the last bits differ on ~40% of
#: the values, and a point whose pcoords sit on the tolerance edge could
#: flip
FLAG_SHARE = 0.995
VALUE_TOL = 1e-5


def _elements(shape, n=2000, seed=0):
    """n jittered copies of the unit element with random scalars, and n
    points around it, from a numpy seed."""
    rs = np.random.default_rng(seed)
    base = UNIT[shape]
    V = (base[None] + rs.normal(size=(n, *base.shape)) * 0.15
         ).astype(np.float32)
    S = rs.random((n, base.shape[0])).astype(np.float32)
    P = (rs.normal(size=(n, 3)) * 0.5 + 0.45).astype(np.float32)
    return P, V, S


@pytest.mark.parametrize("shape", sorted(UNIT))
def test_torch_uelems_match_jax(shape):
    P, V, S = _elements(shape)
    hit, val = PORT_FN[shape](torch.from_numpy(P), torch.from_numpy(V),
                              torch.from_numpy(S))
    jhit, jval = jax.vmap(JAX_FN[shape])(jnp.asarray(P), jnp.asarray(V),
                                          jnp.asarray(S))
    jhit, jval = np.asarray(jhit), np.asarray(jval)
    assert (hit.numpy() == jhit).mean() >= FLAG_SHARE
    both = hit.numpy() & jhit
    assert 0.05 < both.mean() < 0.95            # inside and outside
    assert np.abs(val.numpy()[both] - jval[both]).max() <= VALUE_TOL
    assert (val.numpy()[~hit.numpy()] == 0.0).all()
    # the wrapper of K9-n runs this plain version on CPU tensors
    whit, wval = uelems.uelems_points(torch.from_numpy(P),
                                      torch.from_numpy(V),
                                      torch.from_numpy(S))
    assert torch.equal(whit, hit) and torch.equal(wval, val)


def _one(fn, p, V, S):
    hit, val = fn(torch.tensor([p], dtype=torch.float32),
                  torch.from_numpy(V)[None], torch.from_numpy(S)[None])
    return bool(hit[0]), float(val[0])


def test_torch_wedge_unit_element():
    """tests/test_uelems.py::test_wedge_unit_element through the port."""
    V = UNIT["wedge"]
    S = np.arange(6, dtype=np.float32)
    inside, val = _one(uelems.intersect_wedge, [0.25, 0.25, 0.5], V, S)
    assert inside
    assert abs(val - (0.25 * 1 + 0.25 * 2 + 0.5 * 3)) < 1e-3
    assert not _one(uelems.intersect_wedge, [0.9, 0.9, 0.5], V, S)[0]
    assert not _one(uelems.intersect_wedge, [0.25, 0.25, 1.5], V, S)[0]


def test_torch_pyramid_and_hex_unit_elements():
    """tests/test_uelems.py::test_pyramid_and_hex_unit_elements through
    the port."""
    Vh = UNIT["hex"]
    Sh = (Vh[:, 0] + 2 * Vh[:, 1] + 4 * Vh[:, 2]).astype(np.float32)
    inside, val = _one(uelems.intersect_hex, [0.3, 0.6, 0.2], Vh, Sh)
    assert inside and abs(val - (0.3 + 2 * 0.6 + 4 * 0.2)) < 1e-3
    assert not _one(uelems.intersect_hex, [1.2, 0.5, 0.5], Vh, Sh)[0]
    Vp = UNIT["pyramid"]
    Sp = np.array([0, 0, 0, 0, 10], np.float32)
    inside, val = _one(uelems.intersect_pyramid, [0.5, 0.5, 0.4], Vp, Sp)
    assert inside and abs(val - 4.0) < 2e-2
    assert not _one(uelems.intersect_pyramid, [0.05, 0.05, 0.9], Vp, Sp)[0]


def test_torch_wedge_matches_oracle_random():
    """The contract of tests/test_uelems.py::test_wedge_matches_oracle_random
    (the same 60 seeded wedges and points): agreement with
    refimpl.intersect_wedge_ref on > 95%, values within its tolerance."""
    rs = np.random.RandomState(7)
    V_all, S_all, P_all = [], [], []
    for _ in range(60):
        V = (UNIT["wedge"] + rs.randn(6, 3).astype(np.float32) * 0.15
             ).astype(np.float32)
        S_all.append(rs.rand(6).astype(np.float32))
        P_all.append(rs.randn(3).astype(np.float32) * 0.8 + 0.3)
        V_all.append(V)
    P, V, S = (np.stack(a).astype(np.float32) for a in (P_all, V_all, S_all))
    hit, val = uelems.intersect_wedge(torch.from_numpy(P),
                                      torch.from_numpy(V),
                                      torch.from_numpy(S))
    agree = 0
    for i in range(60):
        ref_h, ref_v = refimpl.intersect_wedge_ref(P[i], V[i], S[i])
        if bool(hit[i]) == ref_h:
            agree += 1
            if ref_h:
                np.testing.assert_allclose(float(val[i]), ref_v, rtol=1e-3,
                                           atol=1e-4)
    assert agree / 60 > 0.95, agree


def test_torch_newton_counts_iterations():
    """return_iters: 1..10 iterations per point, at least 2 for a point
    that converges from the element's centre (the first step moves it),
    and equal results with and without the count."""
    P, V, S = (torch.from_numpy(a) for a in _elements("wedge", 500, 3))
    hit, val, it = uelems.newton(P, V, S, return_iters=True)
    hit2, val2 = uelems.newton(P, V, S)
    assert torch.equal(hit, hit2) and torch.equal(val, val2)
    assert it.dtype == torch.int32
    assert int(it.min()) >= 1 and int(it.max()) <= uelems.MAX_ITERATION
    assert int(it[hit].min()) >= 2


def test_torch_uelems_points_rejects_bad_shapes():
    P = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        uelems.uelems_points(P, torch.zeros(4, 7, 3), torch.zeros(4, 7))
    with pytest.raises(ValueError):
        uelems.uelems_points(P, torch.zeros(4, 6, 3), torch.zeros(4, 5))


@pytest.mark.parametrize("shape", sorted(UNIT))
def test_torch_uelems_reject_other_vertex_counts(shape):
    """Each intersector takes only its own element: given another shape's
    vertices it raises instead of inverting that shape."""
    other = {"wedge": "hex", "pyramid": "wedge", "hex": "pyramid"}[shape]
    P, V, S = _elements(other, n=4)
    with pytest.raises(ValueError, match=f"intersect_{shape}"):
        PORT_FN[shape](torch.from_numpy(P), torch.from_numpy(V),
                       torch.from_numpy(S))


#: a hand-built wedge whose top face is shifted and tilted (so the shape
#: map is not affine and Newton takes several iterations), its scalars,
#: and a point inside it whose last step (~7.7e-5) is just under the
#: convergence tolerance: the weights of the pcoords before that step and
#: after it give values ~9e-4 apart
TWISTED = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                    [0.3, -0.2, 1.0], [1.4, 0.3, 1.2], [-0.1, 1.3, 0.9]],
                   np.float32)
TWISTED_S = np.array([0, 2, 4, 6, 8, 10], np.float32)
TWISTED_P = [0.7127, 0.3669, 0.1797]


def _wedge_weights(pc):
    r, s, t = pc
    return np.array([(1 - r - s) * (1 - t), r * (1 - t), s * (1 - t),
                     (1 - r - s) * t, r * t, s * t])


def _newton_trace(p, V):
    """The wedge Newton in float64: the pcoords before each iteration and
    after the last, leaving at convergence as the f32 versions do."""
    p, V = np.asarray(p, np.float64), V.astype(np.float64)
    pc = np.full(3, 0.5)
    pcs = [pc]
    for _ in range(uelems.MAX_ITERATION):
        r, s, t = pc
        dr = [-1 + t, 1 - t, 0, -t, t, 0]
        ds = [-1 + t, 0, 1 - t, -t, 0, t]
        dt = [-1 + r + s, -r, -s, 1 - r - s, r, s]
        J = np.stack([np.dot(d, V) for d in (dr, ds, dt)], 1)
        step = np.linalg.solve(J, _wedge_weights(pc) @ V - p)
        pc = pc - step
        pcs.append(pc)
        if (np.abs(step) < uelems.CONVERGED).all():
            break
    return pcs


def test_torch_newton_takes_weights_of_last_iteration():
    """The reference's quirk, pinned: a point that converges at iteration
    k is interpolated with the weights of iteration k's pcoords before
    its update, not of the pcoords the inside test reads; the JAX
    package's intersect_wedge agrees."""
    pcs = _newton_trace(TWISTED_P, TWISTED)
    k = len(pcs) - 1
    assert k == 3
    pre = float(_wedge_weights(pcs[k - 1]) @ TWISTED_S)
    post = float(_wedge_weights(pcs[k]) @ TWISTED_S)
    assert abs(pre - post) > 5e-4
    hit, val, it = uelems.newton(torch.tensor([TWISTED_P]),
                                 torch.from_numpy(TWISTED)[None],
                                 torch.from_numpy(TWISTED_S)[None],
                                 return_iters=True)
    assert bool(hit[0]) and int(it[0]) == k
    assert abs(float(val[0]) - pre) <= 1e-5
    jhit, jval = juelems.intersect_wedge(jnp.asarray(TWISTED_P, jnp.float32),
                                         jnp.asarray(TWISTED),
                                         jnp.asarray(TWISTED_S))
    assert bool(jhit) and abs(float(jval) - float(val[0])) <= VALUE_TOL


@pytest.mark.parametrize("shape", sorted(UNIT))
def test_torch_newton_reads_scalars_only_inside(shape):
    """S is read only for points inside their element: NaN scalars on
    every element that does not contain its point leave value 0 there and
    change nothing else, in the plain version and in K9-n's wrapper."""
    P, V, S = (torch.from_numpy(a) for a in _elements(shape, 1000, 5))
    hit, val = uelems.newton(P, V, S)
    assert 0 < int(hit.sum()) < hit.numel()
    S_nan = torch.where(hit[:, None], S, float("nan"))
    for fn in (uelems.newton, uelems.uelems_points):
        hit2, val2 = fn(P, V, S_nan)
        assert torch.equal(hit2, hit) and torch.equal(val2, val)
        assert (val2[~hit] == 0).all()


def test_torch_uelems_points_bool_and_out():
    """The wrapper returns a bool flag tensor, and with out= writes into
    the given tensors and returns them; out= of another dtype or size
    raises."""
    P, V, S = (torch.from_numpy(a) for a in _elements("wedge", 300, 9))
    hit, val = uelems.uelems_points(P, V, S)
    assert hit.dtype == torch.bool and val.dtype == torch.float32
    out = (torch.zeros(300, dtype=torch.bool), torch.full((300,), 7.0))
    got = uelems.uelems_points(P, V, S, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(out[0], hit) and torch.equal(out[1], val)
    with pytest.raises(ValueError, match="out inside"):
        uelems.uelems_points(P, V, S, out=(torch.zeros(300, dtype=torch.uint8),
                                           out[1]))
    with pytest.raises(ValueError, match="out value"):
        uelems.uelems_points(P, V, S, out=(out[0], torch.zeros(299)))
