"""PyTorch port, K1 and K2's layer lookup, launch arguments and row layout.

The trackers keep, per column-cache slot, the layer of its last evaluation
and the bracket (h[l - 1], h[l]] of ceilings around it; an evaluation whose
radius lies in the bracket reuses the layer, any other binary-searches the
column's ceilings (csrc/tier_f32.cuh, csrc/tier_q.cuh).  `layers_kernel_way`
below is that lookup in plain PyTorch; it is held equal to the count #(h < r)
-- and, on the f32 tier, to the JAX package's `find_layer` -- on K5a's baked
prof rows and on the quantized tier's dequantized ceilings, over walks of
radii that stay in a column, cross its ceilings, sit exactly on them, on
h_bot and above h_top, with zero-thickness layers and 1 to 31 layers a
column (24 on the quantized tier).  The table constructors refuse
ceilings that do not ascend; the launch arguments of K1 and K2 are built
without a device read; the wrappers refuse rows the kernels could not
read in 16- or 4-byte words."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.models.cells import find_layer as jfind_layer
from icon_rt_tpu_torch.data import synthetic
from icon_rt_tpu_torch.data.icfile import ICDataset, MAX_LAYERS
from icon_rt_tpu_torch.models import qcells
from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
from icon_rt_tpu_torch.models.locator import build_locator
from icon_rt_tpu_torch.models.finemap import build_finemap
from icon_rt_tpu_torch.models.shells import (build_radial_bands,
                                             update_band_majorants)
from icon_rt_tpu_torch.models.transfunc import make_transfunc
from icon_rt_tpu_torch.ops import fast, fastq
from icon_rt_tpu_torch.ops.camera import Camera
from icon_rt_tpu_torch.ops.render import alloc_frame, make_launch_params

torch.set_num_threads(1)

WALK = 48          # evaluations a lane makes in one column
SEARCH_STEPS = 6   # ceil(log2(32 + 1)) halvings cover any row


def ragged_dataset(sub, seed, max_nl=MAX_LAYERS - 1):
    """An icosphere whose columns have 1..max_nl layers and random
    ascending ceilings, a quarter of the layers of zero thickness (a
    ceiling equal to the one below it)."""
    rng = np.random.default_rng(seed)
    ds = synthetic.icosphere(sub, 8)
    n = ds.num_cells
    nl = rng.integers(1, max_nl + 1, n).astype(np.int32)
    nl[:2] = (1, max_nl)
    step = rng.uniform(50.0, 3000.0, (n, MAX_LAYERS)).astype(np.float32)
    step[rng.random((n, MAX_LAYERS)) < 0.25] = 0.0
    step[:, 0] = 0.0
    height = (ds.height[:, :1] + np.cumsum(step, axis=1)).astype(np.float32)
    return ICDataset(lat=ds.lat, lon=ds.lon, num_layers=nl, height=height,
                     value=ds.value)


def radii(ceil, h_bot, h_top, seed):
    """(M, WALK) radii a lane meets in its column: a random walk inside
    [h_bot, h_top], then the column's ceilings exactly, their f32
    neighbours, h_bot, h_top and a radius above h_top."""
    rng = np.random.default_rng(seed)
    m = ceil.shape[0]
    fin = np.where(np.isfinite(ceil), ceil, h_top[:, None])
    pick = fin[np.arange(m)[:, None], rng.integers(0, ceil.shape[1],
                                                   (m, 12))]
    walk = h_bot[:, None] + (h_top - h_bot)[:, None] * np.cumsum(
        rng.uniform(-0.08, 0.12, (m, WALK - 30)), axis=1).clip(0, 1)
    return np.concatenate([
        walk.astype(np.float32), pick,
        np.nextafter(pick, np.float32(np.inf)),
        np.nextafter(pick[:, :3], np.float32(-np.inf)),
        h_bot[:, None], h_top[:, None], (h_top * 1.001)[:, None]],
        axis=1).astype(np.float32)


def layers_kernel_way(ceil, n, r):
    """The trackers' layer of each radius in r (M, T): per lane, in order,
    the slot's cached layer while r stays in its bracket (lo, hi], else the
    lower bound of r in the first n (M,) of the lane's ascending ceilings
    ceil (M, K) (+inf past them), which refills the bracket.  Returns (the
    layers (M, T), the share of evaluations that searched)."""
    m, k = ceil.shape
    inf = torch.tensor(float("inf"))
    lo_b = torch.full((m,), float("inf"))        # the forgotten bracket
    hi_b = torch.full((m,), -float("inf"))
    l_b = torch.zeros(m, dtype=torch.long)
    out, searched = [], 0
    for j in range(r.shape[1]):
        rj = r[:, j]
        hit = (lo_b < rj) & (rj <= hi_b)
        lo, hi = torch.zeros(m, dtype=torch.long), n.clone()
        for _ in range(SEARCH_STEPS):
            go = lo < hi
            mid = torch.div(lo + hi, 2, rounding_mode="floor")
            below = ceil.gather(1, mid.clamp(max=k - 1)[:, None])[:, 0] < rj
            lo = torch.where(go & below, mid + 1, lo)
            hi = torch.where(go & ~below, mid, hi)
        assert bool((lo == hi).all())
        l_new = lo
        lo_n = torch.where(l_new > 0, ceil.gather(
            1, (l_new - 1).clamp(min=0)[:, None])[:, 0], -inf)
        hi_n = torch.where(l_new < k, ceil.gather(
            1, l_new.clamp(max=k - 1)[:, None])[:, 0], inf)
        l = torch.where(hit, l_b, l_new)
        lo_b = torch.where(hit, lo_b, lo_n)
        hi_b = torch.where(hit, hi_b, hi_n)
        l_b = l
        searched += int((~hit).sum())
        out.append(l)
    return torch.stack(out, 1), searched / r.numel()


def count_layers(ceil, r):
    """#(h < r) over each lane's ceilings, for every radius of its walk."""
    return (r[:, :, None] > ceil[:, None, :]).sum(2)


@pytest.mark.parametrize("sub", [2, 3, 4])
def test_torch_bracket_layer_f32_equals_count(sub):
    """K1's way on K5a's prof rows (the plain bake's 32 inf-padded
    ceilings): equal to #(h < r) and to JAX's find_layer at every radius of
    every walk, and most evaluations reuse the bracket."""
    ds = ragged_dataset(sub, seed=sub)
    cells = build_cells(ds)
    tf = make_transfunc(value_range=tuple(compute_stats(ds).data_range))
    prof, _ = fast._profile_rows_torch(cells.height, cells.value,
                                       cells.num_layers, tf)
    ceil = prof[:, :MAX_LAYERS]
    r = torch.from_numpy(radii(ceil.numpy(), ds.height[:, 0],
                               cells.h_top.numpy(), seed=10 + sub))
    got, searched = layers_kernel_way(
        ceil, cells.num_layers.long().clamp(0, MAX_LAYERS), r)
    assert torch.equal(got, count_layers(ceil, r))
    jl = jax.vmap(jax.vmap(jfind_layer, in_axes=(None, None, 0)),
                  in_axes=(0, 0, 0))(jnp.asarray(ds.height),
                                     jnp.asarray(ds.num_layers),
                                     jnp.asarray(r.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jl))
    assert searched < 0.75


@pytest.mark.parametrize("sub", [2, 3, 4])
def test_torch_bracket_layer_q_equals_count(sub):
    """K2's way on the quantized tier's ceilings (`_QTier._heights`: h_bot
    + hf * s, +inf past num_layers, in the JAX expression order), per-cell
    h_frac rows of 1..24 layers (Lm 24): equal to #(h < r) at every
    radius."""
    ds = ragged_dataset(sub, seed=20 + sub, max_nl=24)
    q = qcells.quantize_cells(ds)
    assert q.h_frac.shape[0] == q.num_cells and q.lm == 24
    tf = make_transfunc(value_range=tuple(compute_stats(ds).data_range))
    tier = fastq._QTier(q, build_locator(ds), tf, None)
    ceil = tier._heights(torch.arange(q.num_cells))
    t = q.test12
    r = torch.from_numpy(radii(ceil.numpy(), t[:, 9].numpy(),
                               t[:, 10].numpy(), seed=30 + sub))
    n = t[:, 11].long().clamp(0, q.lm)
    got, searched = layers_kernel_way(ceil, n, r)
    assert torch.equal(got, count_layers(ceil, r))
    assert searched < 0.75


def test_torch_bracket_layer_ties_and_one_layer():
    """Hand-made rows: zero-thickness layers (equal ceilings), a radius on
    each ceiling, one layer, and the top layer's +inf bracket."""
    ceil = torch.tensor([[1.0, 2.0, 2.0, 2.0, 3.0, float("inf")],
                         [5.0] + [float("inf")] * 5])
    n = torch.tensor([5, 1])
    r = torch.tensor([[0.5, 1.0, 1.5, 2.0, 2.0, 2.5, 3.0, 3.5, 9.0, 1.0],
                      [4.0, 5.0, 5.0, 6.0, 7.0, 5.0, 4.0, 0.0, 5.5, 5.0]])
    got, _ = layers_kernel_way(ceil, n, r)
    assert torch.equal(got, count_layers(ceil, r))
    assert got[0].tolist() == [0, 0, 1, 1, 1, 4, 4, 5, 5, 0]


@pytest.mark.parametrize("case", ["f32 swapped", "q swapped", "q h_top",
                                  "q shared row"])
def test_torch_tables_refuse_unsorted_ceilings(case):
    """build_cells and quantize_cells (and check_q_ceilings, which every
    constructor of the quantized tables calls) raise naming the first
    column whose ceilings descend; ties and a shared row that descends only
    past every column's num_layers pass."""
    ds = synthetic.icosphere(2, 6)
    h = ds.height.copy()
    if case in ("f32 swapped", "q swapped"):
        h[7, [2, 3]] = h[7, [3, 2]]
        bad = ICDataset(ds.lat, ds.lon, ds.num_layers, h, ds.value)
        build = build_cells if case == "f32 swapped" else \
            qcells.quantize_cells
        with pytest.raises(ValueError, match="column 7"):
            build(bad)
        h = ds.height.copy()
        h[7, 3] = h[7, 2]                        # a zero-thickness layer
        build(ICDataset(ds.lat, ds.lon, ds.num_layers, h, ds.value))
        return
    q = qcells.quantize_cells(ds)
    if case == "q h_top":
        t12 = q.test12.clone()
        t12[5, 10] = t12[5, 9] - 1.0
        with pytest.raises(ValueError, match="column 5"):
            qcells.check_q_ceilings(q.h_frac, t12)
        return
    assert q.h_frac.shape[0] == 1 and q.lm == 8
    row = q.h_frac.clone()
    row[0, 7] = 0.0                              # past every column's 6
    qcells.check_q_ceilings(row, q.test12)
    row[0, 4] = row[0, 3] - 1.0
    with pytest.raises(ValueError, match="column 0"):
        qcells.check_q_ceilings(row, q.test12)


def _tables():
    ds = synthetic.icosphere(3, 8)
    st = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(st.data_range))
    bands = update_band_majorants(build_radial_bands(ds, 16), tf.values,
                                  tf.value_range)
    q = qcells.bake_alpha_q(qcells.quantize_cells(ds), tf)
    cam = Camera()
    c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    cam.set_orientation(c + np.array([2.0, 0.3, 0.8], np.float32)
                        * st.spherical_bounds_hi[0], c,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(16, 16), st.world_bounds_lo,
                            st.world_bounds_hi, unit_distance=1e3)
    return dict(ds=ds, cells=cells, loc=loc, tf=tf, bands=bands, q=q,
                fm=build_finemap(loc, q.test12), lp=lp)


@pytest.fixture(scope="module")
def tabs():
    return _tables()


@pytest.mark.parametrize("tier", ["f32", "q"])
def test_torch_track_launch_args_read_nothing(tabs, tier, monkeypatch):
    """After a warm call, K1's and K2's launch arguments for a camera move,
    a new accum_id and a TF edit (K1: a new bake and majorants; K2: a new
    LUT on the same value range) are built with no tolist(), item() or
    host copy of a tensor, and carry the new frame's device addresses."""
    t = tabs
    pix = torch.arange(256, dtype=torch.int32)
    acc, fb = alloc_frame(16, 16)
    packed = fast.pack_cells(t["cells"], t["tf"])
    if tier == "f32":
        def args(lp, tf, bands, packed):
            return fast.track_params(packed, t["loc"], fast.track_common(
                bands, lp, pix, acc, fb, width=16, height=16, samples=8,
                preserve_cache=True))
    else:
        def args(lp, tf, bands, packed):
            return fastq.track_q_params(
                t["q"], t["loc"], tf, t["fm"], fast.track_common(
                    bands, lp, pix, acc, fb, width=16, height=16, samples=8,
                    preserve_cache=True, fn="track_q"))
    args(t["lp"], t["tf"], t["bands"], packed)              # warm
    lp = t["lp"]._replace(cam_org=t["lp"].cam_org * 1.01,
                          accum_id=torch.tensor(8, dtype=torch.int32))
    tf = t["tf"]._replace(values=t["tf"].values * 0.9)
    bands = update_band_majorants(t["bands"], tf.values, tf.value_range)
    packed = fast.pack_cells(t["cells"], tf)

    def boom(*a, **k):
        raise AssertionError("a host read of a tensor")
    for name in ("tolist", "item", "cpu", "numpy", "__int__", "__float__",
                 "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    p = args(lp, tf, bands, packed)
    monkeypatch.undo()
    fr = p.c.frame
    assert (fr.cam_org, fr.accum_id) == (lp.cam_org.data_ptr(),
                                         lp.accum_id.data_ptr())
    assert fr.ud == lp.unit_distance.data_ptr()
    assert p.c.majors == bands.max_opacities.data_ptr()
    if tier == "q":
        assert p.lut == tf.values.data_ptr()
    else:
        assert p.prof == packed.prof.data_ptr()


def _shifted(x, nbytes):
    """x's values in storage that starts nbytes past an aligned address."""
    flat = torch.zeros(x.numel() * x.element_size() + 16, dtype=torch.uint8)
    view = flat[nbytes:nbytes + x.numel() * x.element_size()]
    out = view.view(x.dtype).view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("table", ["test", "test12", "slots"])
def test_torch_track_rows_must_align(tabs, table):
    """The wrappers refuse tables the kernels read in words (test rows as
    float4, the fine map's 4 slots as one uint32) whose rows do not start
    on 16- and 4-byte boundaries; the same values aligned run."""
    t = tabs
    pix = torch.arange(256, dtype=torch.int32)
    acc, fb = alloc_frame(16, 16)
    kw = dict(width=16, height=16, samples=1)
    if table == "test":
        packed = fast.pack_cells(t["cells"], t["tf"])
        bad = packed._replace(test=_shifted(packed.test, 4))
        run = lambda p: fast.track_f32(p, t["loc"], t["bands"], t["lp"],
                                       pix, acc, fb, **kw)
        good = packed
    else:
        q, fm = t["q"], t["fm"]
        if table == "test12":
            bad = (q._replace(test12=_shifted(q.test12, 8)), fm)
        else:
            bad = (q, fm._replace(slots=_shifted(fm.slots, 1)))
        run = lambda qf: fastq.track_q(qf[0], t["loc"], t["bands"], t["tf"],
                                       t["lp"], pix, acc, fb,
                                       finemap=qf[1], **kw)
        good = (q, fm)
    with pytest.raises(ValueError, match="byte boundaries"):
        run(bad)
    run(good)
    assert bool(torch.isfinite(acc).all())
