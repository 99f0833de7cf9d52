"""PyTorch port, what K8 (csrc/parity.cu) does that its plain version
does not show: the whole-shell pre-test of the locator and brute samplers
(models/cells.py `shell_range`, `in_shell`; the kernel tests the squared
radius against `square_bounds`), and the launch arguments built without a
host read (ops/render.py `parity_params`).

The pre-test must never reject a point that a sampler finds, here on a
scene whose columns have different bottoms, tops and layer counts, and
against the JAX package's brute-force sampler on the same points."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data.icfile import ICDataset as JICDataset
from icon_rt_tpu.models import cells as jcells
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.data import synthetic
from icon_rt_tpu_torch.models.cells import (_radius, build_cells, in_shell,
                                            sample_brute_force, shell_range,
                                            square_bounds)
from icon_rt_tpu_torch.models.locator import build_locator, sample_locator
from icon_rt_tpu_torch.models.transfunc import make_transfunc
from icon_rt_tpu_torch.ops import render
from icon_rt_tpu_torch.ops.camera import Camera
from icon_rt_tpu_torch.utils.vecmath import sqrt_rn

torch.set_num_threads(1)

W = H = 16
UD = 2.0e4


def _ragged(sub=2, layers=6, seed=0):
    """An icosphere whose columns have different bottoms (+-20 km), tops
    (a thickness scaled by 0.5-1.5) and layer counts (3..layers); the
    ceilings still ascend in each column."""
    ds = synthetic.icosphere(sub, layers)
    rng = np.random.default_rng(seed)
    n = ds.num_cells
    h = ds.height.astype(np.float64)
    base = h[:, :1]
    shift = rng.uniform(-2.0e4, 2.0e4, (n, 1))
    scale = rng.uniform(0.5, 1.5, (n, 1))
    height = (base + shift + (h - base) * scale).astype(np.float32)
    nl = rng.integers(3, layers + 1, n).astype(np.int32)
    return dict(lat=ds.lat, lon=ds.lon, num_layers=nl, height=height,
                value=ds.value)


@pytest.fixture(scope="module")
def rg():
    """The ragged scene in both packages, with the port's tables."""
    arrays = _ragged()
    jds = JICDataset(**{k: np.array(v) for k, v in arrays.items()})
    tds = interop.dataset(jds)
    cells = build_cells(tds)
    jc = jcells.build_cells(jds)
    return dict(jds=jds, tds=tds, cells=cells, loc=build_locator(tds),
                jc=jc)


def _points(cells, n=6000, seed=1):
    """n seeded points: a third at radii across the shell and 2% beyond
    it on each side, the rest in a ball of twice the shell's top."""
    rng = np.random.default_rng(seed)
    lo, hi = (float(x) for x in cells.shell[:2])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = rng.uniform(0.0, 2.0 * hi, n)
    k = n // 3
    r[:k] = rng.uniform(lo - 0.02 * (hi - lo), hi + 0.02 * (hi - lo), k)
    return torch.from_numpy((d * r[:, None]).astype(np.float32))


@pytest.mark.parametrize("sampler", ["brute", "locator"])
def test_torch_shell_never_rejects_a_found_point(rg, sampler):
    """On 6000 seeded points: every point that sample_brute_force or
    sample_locator finds passes `in_shell`, and the JAX package's brute
    force finds the same points; the shell rejects points on both sides
    and keeps points that no cell holds (the gaps of the ragged tops)."""
    cells, pos = rg["cells"], _points(rg["cells"])
    if sampler == "brute":
        hit, _ = sample_brute_force(cells, pos)
    else:
        hit, _ = sample_locator(cells, rg["loc"], pos)
    jhit, _ = jax.vmap(lambda p: jcells.sample_brute_force(rg["jc"], p))(
        jnp.asarray(pos.numpy()))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    r = _radius(pos)
    inner = in_shell(cells, r)
    assert bool(inner[hit].all())
    assert int(hit.sum()) > 100
    lo, hi = cells.shell[:2]
    assert bool((r < lo).any()) and bool((r > hi).any())
    assert bool((inner & ~hit).any())


def _at_radius(direction, radius):
    """A point near `direction` whose f32 radius (`_radius`, correctly
    rounded) is exactly `radius`: the scale stepped an ULP at a time
    around it, the direction turned by up to 1e-4 until one lands."""
    g = np.random.default_rng(0)
    for _ in range(200):
        d = torch.as_tensor(direction, dtype=torch.float32)
        d = d / torch.linalg.norm(d)
        s = torch.tensor(radius, dtype=torch.float32)
        for _ in range(8):
            p = (d * s)[None]
            r = float(_radius(p)[0])
            if r == float(radius):
                return p
            s = torch.nextafter(s, torch.tensor(np.inf if r < radius
                                                else -np.inf, dtype=s.dtype))
        direction = np.asarray(direction) + g.uniform(-1e-4, 1e-4, 3)
    raise AssertionError("no point of that radius near the direction")


def _column_center(ds, c):
    """The unit vector of column c's mean corner direction."""
    lat, lon = ds.lat[c].astype(np.float64), ds.lon[c].astype(np.float64)
    v = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                  np.sin(lat)], axis=1).mean(axis=0)
    return v / np.linalg.norm(v)


EDGES = ["bottom", "below bottom by 1 ULP", "top", "above top by 1 ULP",
         "origin", "NaN", "inside the planet", "beyond the top"]


@pytest.mark.parametrize("case", EDGES)
def test_torch_shell_edges(rg, case):
    """The pre-test at its edges, each against both samplers: a point at
    radius exactly min h_bot (max h_top) inside the column that has it is
    kept and found; one ULP below (above) it is rejected and found by
    none; the origin (r = 0, its latitude NaN), a NaN point, a point
    inside the planet and one beyond the top are rejected and found by
    none."""
    cells, ds = rg["cells"], rg["tds"]
    lo, hi = (float(x) for x in cells.shell[:2])
    c_lo = int(np.argmin(cells.h_bot.numpy()))
    c_hi = int(np.argmax(cells.h_top.numpy()))
    down, up = (lambda x: float(np.nextafter(np.float32(x), np.float32(-1))),
                lambda x: float(np.nextafter(np.float32(x), np.float32(2 * x))))
    pos, keep = {
        "bottom": (lambda: _at_radius(_column_center(ds, c_lo), lo), True),
        "below bottom by 1 ULP": (lambda: _at_radius(
            _column_center(ds, c_lo), down(lo)), False),
        "top": (lambda: _at_radius(_column_center(ds, c_hi), hi), True),
        "above top by 1 ULP": (lambda: _at_radius(
            _column_center(ds, c_hi), up(hi)), False),
        "origin": (lambda: torch.zeros(1, 3), False),
        "NaN": (lambda: torch.tensor([[np.nan, 1.0, 2.0]]), False),
        "inside the planet": (lambda: _at_radius(
            _column_center(ds, 7), 0.5 * lo), False),
        "beyond the top": (lambda: _at_radius(
            _column_center(ds, 7), 2.0 * hi), False),
    }[case]
    p = pos()
    r = _radius(p)
    assert bool(in_shell(cells, r)[0]) is keep
    bh, _ = sample_brute_force(cells, p)
    lh, _ = sample_locator(cells, rg["loc"], p)
    assert bool(bh[0]) is keep and bool(lh[0]) is keep


def test_torch_shell_range_of_scenes(rg):
    """`shell_range` is [min h_bot, max h_top] and their squares' bounds,
    the same for the port's build and the JAX package's tables through
    interop; NaNs are ignored; a scene without cells takes [+inf, -inf]
    (and so for the squares), which rejects every radius (0, +inf,
    NaN)."""
    cells, tds = rg["cells"], rg["tds"]
    h_top = tds.height[np.arange(tds.num_cells), tds.num_layers]
    lo, hi = np.float32(tds.height[:, 0].min()), np.float32(h_top.max())
    want = np.array([lo, hi, *square_bounds(lo, hi)], np.float32)
    np.testing.assert_array_equal(cells.shell.numpy(), want)
    np.testing.assert_array_equal(interop.cells(rg["jc"]).shell.numpy(),
                                  want)
    assert hi > lo and cells.shell.dtype == torch.float32
    with_nan = cells.h_bot.numpy().copy()
    with_nan[3] = np.nan
    np.testing.assert_array_equal(
        shell_range(with_nan, cells.h_top.numpy()), want)
    empty = torch.from_numpy(shell_range(np.zeros(0), np.zeros(0)))
    np.testing.assert_array_equal(empty.numpy(),
                                  [np.inf, -np.inf, np.inf, -np.inf])
    e = cells._replace(shell=empty)
    r = torch.tensor([0.0, np.inf, np.nan, float(lo)])
    assert not bool(in_shell(e, r).any())


@pytest.mark.parametrize("shell", ["ragged", "unit", "wide", "everything",
                                   "empty"])
def test_torch_shell_bounds_of_the_square(rg, shell):
    """K8 tests the shell on the squared radius s (no square root for the
    samples it rejects) against `square_bounds`, shell[2:] of
    `shell_range`: for every s within 256 ULPs of either bound, and 0,
    +inf and NaN, s_lo <= s <= s_hi holds exactly when the correctly
    rounded radius passes `in_shell`."""
    lo, hi = {"ragged": tuple(float(x) for x in rg["cells"].shell[:2]),
              "unit": (1.0, 2.0), "wide": (3.0e-20, 5.0e18),
              "everything": (0.0, np.inf),
              "empty": (np.inf, -np.inf)}[shell]
    s_lo, s_hi = square_bounds(lo, hi)
    if shell == "ragged":
        np.testing.assert_array_equal(rg["cells"].shell[2:].numpy(),
                                      [s_lo, s_hi])
    sh = torch.tensor([lo, hi, s_lo, s_hi], dtype=torch.float32)
    cells = rg["cells"]._replace(shell=sh)
    vals = [np.float32(0), np.float32(np.inf), np.float32(np.nan)]
    for b in (s_lo, s_hi):
        if np.isfinite(b):
            x = np.float32(b)
            for _ in range(256):
                x = np.nextafter(x, np.float32(0))
            for _ in range(513):
                vals.append(x)
                x = np.nextafter(x, np.float32(np.inf))
    s = torch.tensor(np.array(vals, np.float32))
    want = in_shell(cells, sqrt_rn(s))
    got = (s >= float(s_lo)) & (s <= float(s_hi))
    assert torch.equal(got, want)
    assert bool(want.any()) is (shell != "empty")


def _camera(stats):
    cam = Camera()
    c = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    v = np.array([2.2, 0.4, 0.9], np.float32)
    v /= np.linalg.norm(v)
    cam.set_orientation(c + v * stats.spherical_bounds_hi[0] * 1.6, c,
                        np.array([0, 0, 1], np.float32), 12.0)
    return cam


# ---------------------------------------------------------------------------
# K8's launch arguments without a host read
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """A subdiv-1 scene with both accels, wedges and a 16x16 frame."""
    from icon_rt_tpu_torch.models.accel import (build_grid_accel,
                                                build_shell_accel,
                                                update_majorants)
    from icon_rt_tpu_torch.models.cells import compute_stats
    from icon_rt_tpu_torch.models.wedges import build_wedges
    ds = synthetic.icosphere(1, 3)
    st = compute_stats(ds)
    tf = make_transfunc(value_range=tuple(st.data_range), size=32)
    acc = {"sphere": build_shell_accel(ds, st.spherical_bounds_lo,
                                       st.spherical_bounds_hi, (1, 8, 8)),
           "grid": build_grid_accel(ds, st.world_bounds_lo,
                                    st.world_bounds_hi, (4, 4, 4))}
    acc = {k: update_majorants(v, tf.values, tf.value_range)
           for k, v in acc.items()}
    lp = render.make_launch_params(_camera(st).basis(W, H),
                                   st.world_bounds_lo, st.world_bounds_hi,
                                   unit_distance=UD)
    return dict(cells=build_cells(ds), loc=build_locator(ds), tf=tf,
                acc=acc, lp=lp, wedges=build_wedges(ds))


class _Read(AssertionError):
    pass


@pytest.mark.parametrize("raygen,sampler", [
    ("ae", "locator"), ("ae", "brute"), ("sphere", "locator"),
    ("sphere", "brute"), ("grid", "locator"), ("grid", "brute"),
    ("ae", "wedge")])
def test_torch_parity_params_read_nothing(small, monkeypatch, raygen,
                                          sampler):
    """ops/render.py `parity_params`, K8's launch arguments, on CPU
    tensors with every way a tensor reaches the host (tolist, item, int,
    float, bool, index, cpu, numpy) made to raise: it reads none, and
    every scalar of the frame, the TF, the cells' shell, the locator
    window and the accel bounds is passed as its tensor's address (with
    the wedge sampler the shell is the wedges', `Wedges.shell`)."""
    s = small
    accel = s["acc"].get(raygen)
    acc, fb = render.alloc_frame(W, H)
    dbg = torch.zeros(W * H, 2, dtype=torch.int32)

    def boom(*a, **k):
        raise _Read("a host read")
    for name in ("tolist", "item", "__int__", "__float__", "__bool__",
                 "__index__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    p = render.parity_params(
        s["cells"], s["tf"], s["lp"], acc, fb, width=W, height=H,
        raygen=raygen, sampler=sampler, locator=s["loc"], accel=accel,
        debug=dbg, wedges=s["wedges"] if sampler == "wedge" else None,
        locator_dims=(3, 5), accel_dims=(2, 3, 4))
    monkeypatch.undo()
    addr = lambda t: t.data_ptr()
    c, tf, lp, loc = s["cells"], s["tf"], s["lp"], s["loc"]
    shell = s["wedges"].shell if sampler == "wedge" else c.shell
    assert p.shell == addr(shell) and p.planes == addr(c.planes)
    assert (p.vr, p.opacity_scale) == (addr(tf.value_range),
                                       addr(tf.opacity_scale))
    assert (p.blo, p.bhi) == (addr(lp.bounds_lo), addr(lp.bounds_hi))
    assert (p.frame.cam_org, p.frame.accum_id, p.frame.ud) == (
        addr(lp.cam_org), addr(lp.accum_id), addr(lp.unit_distance))
    assert (p.accum, p.fb, p.dbg) == (addr(acc), addr(fb), addr(dbg))
    assert p.n_lanes == W * H and p.max_iters == render.MAX_ITERS
    if sampler == "brute":
        assert p.bins is None and p.win[0] is None
    else:
        assert list(p.win) == [addr(t) for t in (loc.lat_lo, loc.lat_hi,
                                                  loc.lon_lo, loc.lon_hi)]
        assert (p.n_lat, p.n_lon, p.k_cap) == (3, 5, loc.bins.shape[1])
    if accel is None:
        assert p.majors is None
    else:
        lo = accel.sph_lo if raygen == "sphere" else accel.world_lo
        assert (p.acc_lo, p.majors) == (addr(lo),
                                        addr(accel.max_opacities))
        assert list(p.dims) == [2, 3, 4]
    if sampler == "wedge":
        assert p.wverts == addr(s["wedges"].verts) and p.layer_pad >= 1
