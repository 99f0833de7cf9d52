"""PyTorch port, the wedge sampler's shell test and the wedge tier's layer
bracket (K9-p, K9-w).

K9-p (csrc/parity.cu `sample<kWedge>`) and its plain version
(models/wedges.py `sample_wedges`) reject a point whose squared radius lies
outside `Wedges.shell` before the locate: models/wedges.py `wedge_shell`
bounds the radii at which any wedge's Newton inversion accepts a point.
Held here on the CPU at subdivisions 1-4: no point that the plain search
accepts without the test lies outside the shell, on seeded points dense at
the bottom faces' centres, the vertices and both shell edges; the squared
radius bounds are exact; the sampler with the test equals JAX's
sample_wedges; interop's shell equals build_wedges'; a NaN point and the
origin hit nothing.  K9-w (csrc/tier_wedge.cuh) keeps each cache slot's
layer bracket in s = dot(P, n'): its replay equals the 32-ceiling count on
ragged layers and ties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models import wedges as jwedges
from icon_rt_tpu.models.cells import build_cells as jbuild_cells
from icon_rt_tpu.models.cells import find_layer as jfind_layer
from icon_rt_tpu.models.locator import build_locator as jbuild_locator
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.data import synthetic
from icon_rt_tpu_torch.data.icfile import MAX_LAYERS
from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
from icon_rt_tpu_torch.models.locator import build_locator
from icon_rt_tpu_torch.models.transfunc import make_transfunc
from icon_rt_tpu_torch.models.wedges import (_triangle_min_norm,
                                             build_wedges, in_wedge_shell,
                                             sample_wedges, shell_probes,
                                             wedge_candidates, wedge_shell)
from icon_rt_tpu_torch.ops import fast
from icon_rt_tpu_torch.utils.vecmath import sqrt_rn
from test_torch_track_bracket import (count_layers, layers_kernel_way,
                                      ragged_dataset, radii)

torch.set_num_threads(1)

#: (subdivision, layers) of the property scenes: subdivision 1's flat faces
#: sit ~300 km below its 30 km shell, subdivision 4's ~5 km
SCENES = [(1, 3), (2, 5), (3, 8), (4, 4)]
COLUMNS = 16          # seeded columns probed a scene, beside the extremes
#: hit flags and values against JAX's sample_wedges, as
#: tests/test_torch_wedges.py holds them (JAX's Newton fuses multiply-adds)
HIT_SHARE = 0.995
VALUE_TOL = 1e-5


def _scene(sub, layers):
    ds = synthetic.icosphere(sub, layers)
    return ds, build_cells(ds), build_locator(ds), build_wedges(ds)


@pytest.mark.parametrize("sub,layers", SCENES)
def test_torch_wedge_shell_holds_every_accepted_point(sub, layers):
    """The plain wedge search run without the shell test (every candidate
    column's window, Newton on each wedge): no point it accepts fails the
    shell test, and the points accepted come within 1% of the wedges'
    radial extent of its f64 extremes (the nearest bottom face, the
    farthest vertex): the probes reach the edges that the margin
    widens."""
    ds, cells, loc, w = _scene(sub, layers)
    pos = shell_probes(w, COLUMNS, seed=sub)
    c = wedge_candidates(cells, w, loc, pos)
    accepted = c["hit"].reshape(pos.shape[0], -1).any(1)
    inner = in_wedge_shell(w, pos)
    assert int(accepted.sum()) > 100
    assert bool(inner[accepted].all()), (
        f"{int((accepted & ~inner).sum())} accepted points lie outside the "
        f"wedge shell")
    r = torch.linalg.vector_norm(pos[accepted].double(), dim=1)
    v = w.verts.double().numpy()
    near = float(_triangle_min_norm(v[:, 0], v[:, 1], v[:, 2]).min())
    far = float(np.linalg.norm(v, axis=2).max())
    lo, hi = (float(x) for x in w.shell[:2])
    assert lo < near and far < hi
    assert float(r.min()) - near < 0.01 * (far - near)
    assert far - float(r.max()) < 0.01 * (far - near)
    # the shell sits below every cell's h_bot (the flat faces dip) and
    # above every h_top, by little more than the sagitta and the margin
    assert lo < float(cells.shell[0]) and hi >= float(cells.shell[1])


@pytest.mark.parametrize("sub,layers", SCENES)
def test_torch_wedge_shell_square_bounds_exact(sub, layers):
    """shell[2:] are the least and the greatest f32 squares whose
    correctly rounded roots lie in [shell[0], shell[1]], and shell[0:2]
    are rounded outward from the f64 radii."""
    w = _scene(sub, layers)[3]
    lo, hi, s_lo, s_hi = (np.float32(x) for x in w.shell.numpy())
    inf = np.float32(np.inf)
    root = lambda s: float(sqrt_rn(torch.tensor([s], dtype=torch.float32)))
    assert root(s_lo) >= lo and root(np.nextafter(s_lo, -inf)) < lo
    assert root(s_hi) <= hi and root(np.nextafter(s_hi, inf)) > hi
    v = w.verts.double()
    assert float(hi) >= float(torch.linalg.vector_norm(v, dim=2).max())
    assert 0.0 < float(lo) < float(torch.linalg.vector_norm(
        v[:, :3].mean(1), dim=1).min())


def test_torch_wedge_shell_edge_cases():
    """No wedge: an empty shell that passes nothing; a wedge with a NaN
    vertex is left out; a wedge too small for Newton's singularity test
    makes the shell everything."""
    empty = wedge_shell(np.zeros((0, 6, 3), np.float32))
    assert empty[0] == np.inf and empty[1] == -np.inf
    assert empty[2] == np.inf and empty[3] == -np.inf
    w = _scene(2, 3)[3].verts.numpy()
    bad = w.copy()
    bad[5, 2, 1] = np.nan
    np.testing.assert_array_equal(wedge_shell(bad[5:6]),
                                  wedge_shell(np.zeros((0, 6, 3))))
    assert wedge_shell(bad)[0] == wedge_shell(np.delete(w, 5, 0))[0]
    tiny = np.repeat(w[:1, :1], 6, axis=1)          # all six vertices equal
    full = wedge_shell(np.concatenate([w, tiny]))
    assert full[2] == -np.inf and full[3] == np.inf


def test_torch_sample_wedges_shell_matches_jax():
    """The port's sample_wedges (the shell test first) against JAX's (no
    test) on seeded points of the subdivision-3 scene, a third of them at
    radii inside the cells' shell, a third near the wedge shell's edges:
    hit flags equal on >= HIT_SHARE, values within VALUE_TOL where both
    hit; and equal bit for bit to the port's search without the test."""
    jds = jsyn.icosphere(3, 6)
    jc, jl, jw = jbuild_cells(jds), jbuild_locator(jds), \
        jwedges.build_wedges(jds)
    tc, tl, tw = interop.cells(jc), interop.locator(jl), interop.wedges(jw)
    st = compute_stats(interop.dataset(jds))
    rng = np.random.default_rng(3)
    n = 900
    p = rng.uniform(st.world_bounds_lo, st.world_bounds_hi, (n, 3))
    lo, hi = (float(x) for x in tw.shell[:2])
    r = np.concatenate([
        rng.uniform(st.spherical_bounds_lo[0], st.spherical_bounds_hi[0],
                    n // 3),
        rng.choice([lo, hi], n // 3) * (1 + rng.uniform(-2e-4, 2e-4,
                                                        n // 3))])
    p[: 2 * n // 3] *= (r / np.linalg.norm(p[: 2 * n // 3], axis=1))[:, None]
    pts = p.astype(np.float32)
    pos = torch.from_numpy(pts)
    hit, val = sample_wedges(tc, tw, tl, pos)
    jhit, jval = jax.vmap(lambda q: jwedges.sample_wedges(jc, jw, jl, q))(
        jnp.asarray(pts))
    jhit, jval = np.asarray(jhit), np.asarray(jval)
    assert (hit.numpy() == jhit).mean() >= HIT_SHARE
    both = hit.numpy() & jhit
    assert 0.1 < both.mean() < 0.9
    assert np.abs(val.numpy()[both] - jval[both]).max() <= VALUE_TOL
    assert (val.numpy()[~hit.numpy()] == 0.0).all()
    # the shell test changes nothing: the search without it
    c = wedge_candidates(tc, tw, tl, pos)
    hits = c["hit"].reshape(n, -1)
    first = hits.to(torch.uint8).argmax(1)
    want = c["value"].reshape(n, -1).gather(1, first[:, None])[:, 0]
    assert torch.equal(hit, hits.any(1))
    assert torch.equal(val, torch.where(hits.any(1), want, 0.0))
    assert not bool(in_wedge_shell(tw, pos).all())


@pytest.mark.parametrize("sub", [2, 4])
def test_torch_interop_wedge_shell_equals_build_wedges(sub):
    """interop.wedges computes the shell of a JAX Wedges (which keeps
    none) bit-equal to build_wedges' on the same dataset."""
    jds = jsyn.icosphere(sub, 5)
    got = interop.wedges(jwedges.build_wedges(jds)).shell
    want = build_wedges(interop.dataset(jds)).shell
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_torch_wedge_nan_and_origin_hit_nothing():
    """A NaN point and the origin fail the shell test, and hit nothing
    with it or without it (the search without the test returns no hit
    for them either, so the kernel's pre-test keeps its results)."""
    ds, cells, loc, w = _scene(3, 4)
    pos = torch.tensor([[float("nan"), 0.0, 0.0], [0.0, 0.0, 0.0],
                        [float("nan")] * 3, [1e6, float("nan"), 2e6]])
    assert not bool(in_wedge_shell(w, pos).any())
    hit, val = sample_wedges(cells, w, loc, pos)
    assert not bool(hit.any()) and bool((val == 0.0).all())
    c = wedge_candidates(cells, w, loc, pos)
    assert not bool(c["hit"].any())


@pytest.mark.parametrize("sub", [2, 3, 4])
def test_torch_wedge_bracket_layer_equals_count(sub):
    """K9-w's layer lookup (csrc/tier_wedge.cuh: the slot's bracket, else
    a binary search over the column's num_layers ceilings) replayed in
    the flat coordinate s = dot(P, n') (ops/fast.py `_WedgeTier.coord`)
    on K5a's prof rows of columns of 1..31 layers with zero-thickness
    layers: equal to the 32-ceiling count #(h < s) -- the count the wedge
    tier made before -- and to JAX's find_layer at every s of points
    walking each column's centre ray."""
    ds = ragged_dataset(sub, seed=40 + sub)
    cells = build_cells(ds)
    tf = make_transfunc(value_range=tuple(compute_stats(ds).data_range))
    packed = fast.pack_cells_wedge(cells, tf)
    ceil = packed.prof[:, :MAX_LAYERS]
    rho = radii(ceil.numpy(), ds.height[:, 0], cells.h_top.numpy(),
                seed=50 + sub)
    cl = np.cos(ds.lat)
    u = np.stack([cl * np.cos(ds.lon), cl * np.sin(ds.lon),
                  np.sin(ds.lat)], -1).mean(1)
    u = (u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    P = torch.from_numpy(u[:, None, :] * rho[:, :, None])       # (N, T, 3)
    rows = packed.test[:, None, :]
    s = fast._WedgeTier.coord(rows, P[..., 0], P[..., 1], P[..., 2], None)
    got, searched = layers_kernel_way(
        ceil, cells.num_layers.long().clamp(0, MAX_LAYERS), s)
    assert torch.equal(got, count_layers(ceil, s))
    jl = jax.vmap(jax.vmap(jfind_layer, in_axes=(None, None, 0)),
                  in_axes=(0, 0, 0))(jnp.asarray(ds.height),
                                     jnp.asarray(ds.num_layers),
                                     jnp.asarray(s.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jl))
    assert searched < 0.75


def test_torch_wedge_bracket_ties_on_ceilings():
    """Values of s exactly on each ceiling of columns with equal ceilings,
    stepped up and down by one ULP: the bracket replay equals the count."""
    ds = ragged_dataset(2, seed=9)
    cells = build_cells(ds)
    tf = make_transfunc(value_range=tuple(compute_stats(ds).data_range))
    ceil = fast.pack_cells_wedge(cells, tf).prof[:, :MAX_LAYERS]
    fin = torch.where(torch.isfinite(ceil), ceil, cells.h_top[:, None])
    inf = torch.tensor(float("inf"))
    s = torch.cat([fin, torch.nextafter(fin, inf), torch.nextafter(fin, -inf),
                   fin.flip(1)], 1)
    got, _ = layers_kernel_way(ceil, cells.num_layers.long(), s)
    assert torch.equal(got, count_layers(ceil, s))
    ties = (ceil[:, 1:] == ceil[:, :-1]) & torch.isfinite(ceil[:, 1:])
    assert int(ties.sum()) > 0
