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
