"""PyTorch port, the wedges of the cuBQL mode (models/wedges.py, the
wedge tier's radial bands in models/shells.py): the host builders
bit-equal to the JAX package's, and the plain wedge sampler (K9-p's plain
version) against JAX's sample_wedges on the same seeded points."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models import shells as jshells
from icon_rt_tpu.models import wedges as jwedges
from icon_rt_tpu.models.cells import build_cells as jbuild_cells
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.locator import build_locator as jbuild_locator
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.models import shells, wedges
from icon_rt_tpu_torch.utils.vecmath import np_to_cartesian

torch.set_num_threads(1)

#: hit flags equal to JAX's on at least this share of the points, values
#: within VALUE_TOL where both hit (the Newton's FMA argument of
#: tests/test_torch_uelems.py).  Measured on the CPU: every hit equal on
#: both scenes, values within 1.8e-7 (bit-equal on 58%: the value is
#: bv * sum(w), and the weights' sum moves by an ULP with the rounding of
#: the Newton)
HIT_SHARE = 0.995
VALUE_TOL = 1e-5

SCENES = {
    # the 60-degree test section of tests/test_uelems.py (layer_pad > 2)
    "section": lambda: jsyn.latlon_section(n_lat=3, n_lon=4, num_layers=4,
                                           radius=100.0, thickness=30.0),
    # the synthetic icosphere with a shell thick enough for its 1000 km
    # triangles: at the default 30 km the flat faces' sagitta leaves ~99%
    # of the shell outside every wedge
    "icosphere": lambda: jsyn.icosphere(2, 5, thickness=2.0e6),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def sc(request):
    ds = SCENES[request.param]()
    cells, loc = jbuild_cells(ds), jbuild_locator(ds)
    return dict(ds=ds, tds=interop.dataset(ds), st=jstats(ds), cells=cells,
                loc=loc, w=jwedges.build_wedges(ds),
                t_cells=interop.cells(cells), t_loc=interop.locator(loc))


def test_torch_build_wedges_bit_equal(sc):
    w, jw = wedges.build_wedges(sc["tds"]), sc["w"]
    np.testing.assert_array_equal(w.verts.numpy(), np.asarray(jw.verts))
    np.testing.assert_array_equal(w.scalars.numpy(), np.asarray(jw.scalars))
    np.testing.assert_array_equal(w.cell_offset.numpy(),
                                  np.asarray(jw.cell_offset))
    assert w.layer_pad == jw.layer_pad == wedges.layer_pad(sc["tds"]) >= 1
    assert w.verts.shape[0] == int(sc["ds"].num_layers.sum())
    # interop carries JAX's Wedges across unchanged
    t = interop.wedges(jw)
    assert t.layer_pad == jw.layer_pad and torch.equal(t.verts, w.verts)


def test_torch_bv_min_norm_and_bands_bit_equal(sc):
    ds, tds = sc["ds"], sc["tds"]
    np.testing.assert_array_equal(wedges.bv_all(tds.value, tds.num_layers),
                                  jwedges.bv_all(ds.value, ds.num_layers))
    np.testing.assert_array_equal(wedges.column_min_norm(tds.lat, tds.lon),
                                  jwedges.column_min_norm(ds.lat, ds.lon))
    b = shells.build_radial_bands_wedge(tds, 16)
    jb = jshells.build_radial_bands_wedge(ds, 16)
    for got, want in ((b.edges, jb.edges), (b.value_ranges, jb.value_ranges),
                      (b.max_opacities, jb.max_opacities)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the sagitta inflation reaches below the plain bands' bottom radius
    assert float(b.edges[0]) < float(shells.build_radial_bands(tds, 16)
                                     .edges[0])


def _points(st, n=2000, seed=0):
    """n seeded points in the scene's world box, two thirds of them moved
    along their direction to a radius inside the shell."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(st.world_bounds_lo, st.world_bounds_hi,
                    (n, 3)).astype(np.float32)
    k = 2 * n // 3
    r = rng.uniform(st.spherical_bounds_lo[0], st.spherical_bounds_hi[0],
                    k).astype(np.float32)
    p[:k] *= (r / np.linalg.norm(p[:k], axis=1))[:, None]
    return p


def test_torch_sample_wedges_matches_jax(sc):
    pts = _points(sc["st"])
    w = interop.wedges(sc["w"])
    hit, val = wedges.sample_wedges(sc["t_cells"], w, sc["t_loc"],
                                    torch.from_numpy(pts))
    jhit, jval = jax.vmap(lambda p: jwedges.sample_wedges(
        sc["cells"], sc["w"], sc["loc"], p))(jnp.asarray(pts))
    jhit, jval = np.asarray(jhit), np.asarray(jval)
    assert (hit.numpy() == jhit).mean() >= HIT_SHARE
    both = hit.numpy() & jhit
    assert 0.1 < both.mean() < 0.9
    assert np.abs(val.numpy()[both] - jval[both]).max() <= VALUE_TOL
    assert (val.numpy()[~hit.numpy()] == 0.0).all()


def test_torch_wedge_sampler_mid_layer_hits():
    """tests/test_uelems.py::test_wedge_sampler_on_synthetic through the
    port: points at layer mid-heights of column centroids hit (> 90%) and
    return the layer's bv scalar."""
    ds = jsyn.latlon_section(n_lat=3, n_lon=4, num_layers=4, radius=100.0,
                             thickness=30.0)
    tds = interop.dataset(ds)
    from icon_rt_tpu_torch.models.cells import build_cells
    from icon_rt_tpu_torch.models.locator import build_locator
    cells, loc = build_cells(tds), build_locator(tds)
    w = wedges.build_wedges(tds)
    pts, want = [], []
    for i in range(0, ds.num_cells, 3):
        for L in range(int(ds.num_layers[i])):
            mid_r = 0.5 * (ds.height[i, L] + ds.height[i, L + 1])
            sph = np.stack([np.full(3, mid_r, np.float32), ds.lat[i],
                            ds.lon[i]], -1)
            pts.append(np_to_cartesian(sph).mean(axis=0))
            want.append(float(w.scalars[int(w.cell_offset[i]) + L, 0]))
    hit, val = wedges.sample_wedges(cells, w, loc,
                                    torch.from_numpy(np.stack(pts)))
    assert float(hit.float().mean()) > 0.9
    np.testing.assert_allclose(val.numpy()[hit.numpy()],
                               np.array(want)[hit.numpy()], atol=1e-5)
