"""PyTorch port, the reference-parity raygens (K8's plain version): ray
generation, the point samplers, the majorant grids and the AE and accel
renders held against the JAX package and the scalar numpy oracle
(tests/refimpl.py) on the same scenes, tables and seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refimpl
from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models import accel as jaccel
from icon_rt_tpu.models import cells as jcells
from icon_rt_tpu.models.locator import build_locator as jbuild_locator
from icon_rt_tpu.models.locator import sample_locator as jsample_locator
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.models.transfunc import post_classify as jpost_classify
from icon_rt_tpu.ops import render as jrender
from icon_rt_tpu.ops.camera import Camera
from icon_rt_tpu.ops.traverse import trace_sdda as jtrace_sdda
from icon_rt_tpu.utils.lcg import lcg_init as jlcg_init
from icon_rt_tpu.utils.vecmath import box_test as jbox_test
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.models import accel
from icon_rt_tpu_torch.models.cells import (find_layer, sample_brute_force,
                                            sample_one_cell)
from icon_rt_tpu_torch.models.locator import sample_locator
from icon_rt_tpu_torch.models.transfunc import post_classify
from icon_rt_tpu_torch.ops import render
from icon_rt_tpu_torch.ops.traverse import trace_sdda
from icon_rt_tpu_torch.utils.lcg import lcg_init
from icon_rt_tpu_torch.utils.vecmath import box_test
from test_golden import GOLDEN_FB

torch.set_num_threads(1)

W = H = 16
UD = 5.0                    # the JAX parity tests' unit distance
SHELL_DIMS, GRID_DIMS = (1, 16, 16), (8, 8, 8)

#: fb pixels of 256 (after 2 samples) where the port may differ from JAX:
#: measured 0 for every raygen x sampler; a mismatch would be a libm ULP of
#: log/asin/atan2 moving a collision across a boundary (the argument of
#: tests/test_golden.py:55-56)
JAX_FB_MISMATCH = 2
#: ... and from the scalar numpy oracle, measured 0 as well (its accum
#: equals the port's bit for bit); the JAX package's own bounds are 0.97
#: (AE) and 0.95 (accel) of the pixels (tests/test_render_ae.py:90-93,
#: tests/test_accel.py:107-118)
ORACLE_FB_MISMATCH = 2
#: accum max-abs-diff against JAX: XLA contracts the finalize lerp into an
#: FMA (ROADMAP Queue 3), 1 ULP of values <= 1
JAX_ACCUM_TOL = 2.4e-7


def _camera(stats):
    cam = Camera()
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    diag = np.linalg.norm(stats.world_bounds_hi - stats.world_bounds_lo)
    cam.set_orientation(center + np.array([0.7 * diag, 0, 0], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    return cam


@pytest.fixture(scope="module")
def sc():
    """tests/test_render_ae.py's and tests/test_accel.py's scene in both
    packages: a 2 x 2 lat/lon section, 3 layers, viewed head-on."""
    ds = jsyn.latlon_section(n_lat=2, n_lon=2, lat_range=(-30, 30),
                             lon_range=(-30, 30), num_layers=3,
                             radius=100.0, thickness=30.0)
    st = jcells.compute_stats(ds)
    cells, loc = jcells.build_cells(ds), jbuild_locator(ds)
    tf = jmake_tf(value_range=tuple(st.data_range), size=32)
    cam = _camera(st)
    lp = jrender.make_launch_params(cam.basis(W, H), st.world_bounds_lo,
                                    st.world_bounds_hi, unit_distance=UD)
    acc = {"sphere": jaccel.update_majorants(
               jaccel.build_shell_accel(ds, st.spherical_bounds_lo,
                                        st.spherical_bounds_hi, SHELL_DIMS),
               tf.values, tf.value_range),
           "grid": jaccel.update_majorants(
               jaccel.build_grid_accel(ds, st.world_bounds_lo,
                                       st.world_bounds_hi, GRID_DIMS),
               tf.values, tf.value_range)}
    t_acc = {"sphere": interop.shell_accel(acc["sphere"]),
             "grid": interop.grid_accel(acc["grid"])}
    return dict(ds=ds, tds=interop.dataset(ds), st=st, cells=cells, loc=loc,
                tf=tf, cam=cam, lp=lp, acc=acc,
                t_cells=interop.cells(cells), t_loc=interop.locator(loc),
                t_tf=interop.transfunc(tf), t_acc=t_acc)


def _points(st, n=2000, seed=0):
    """n seeded points in the scene's world box, a third of them moved
    along their direction to a radius inside the shell."""
    rng = np.random.default_rng(seed)
    lo, hi = st.world_bounds_lo, st.world_bounds_hi
    p = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    r = rng.uniform(st.spherical_bounds_lo[0], st.spherical_bounds_hi[0],
                    n // 3).astype(np.float32)
    p[: n // 3] *= (r / np.linalg.norm(p[: n // 3], axis=1))[:, None]
    return p


def test_torch_generate_ray_matches_jax(sc):
    """The LCG state after the jitter draws is bit-equal and the direction
    within 1 ULP (measured: bit-equal, with the correctly rounded square
    root of utils/vecmath.py `sqrt_rn`; PyTorch's own CPU sqrt put 8 of 768
    components 1-2 ULP off)."""
    ys, xs = np.divmod(np.arange(W * H, dtype=np.int32), W)
    aid = 3
    seed0 = (np.uint32(aid) * np.uint32(W * H) + xs.astype(np.uint32))
    j_rng = jlcg_init(jnp.asarray(seed0), jnp.asarray(ys.astype(np.uint32)))
    jorg, jd, jr = jax.vmap(lambda x, y, r: jrender.generate_ray(
        sc["lp"], x, y, r))(jnp.asarray(xs), jnp.asarray(ys), j_rng)
    tlp = interop.launch_params(sc["lp"])
    t_rng = lcg_init(torch.from_numpy(seed0.astype(np.int64)),
                     torch.from_numpy(ys.astype(np.int64)))
    torg, td, tr = render.generate_ray(tlp, torch.from_numpy(xs),
                                       torch.from_numpy(ys), t_rng)
    np.testing.assert_array_equal(tr.numpy(),
                                  np.asarray(jr).astype(np.int64))
    np.testing.assert_array_equal(torg.numpy(), np.asarray(jorg)[0])
    ulp = np.abs(td.numpy().view(np.int32).astype(np.int64)
                 - np.asarray(jd).view(np.int32).astype(np.int64))
    assert int(ulp.max()) <= 1
    # the box segment of the rays, as the JAX package's
    hit, t0, t1 = box_test(torg, td, 0.0, 1e10, tlp.bounds_lo, tlp.bounds_hi)
    jhit, jt0, jt1 = jax.vmap(lambda d: jbox_test(
        jorg[0], d, jnp.float32(0.0), jnp.float32(1e10), sc["lp"].bounds_lo,
        sc["lp"].bounds_hi))(jd)
    assert (hit.numpy() == np.asarray(jhit)).mean() >= 0.99
    assert hit.any()


def test_torch_samplers_match_jax(sc):
    """find_layer, sample_one_cell, sample_brute_force and sample_locator
    on 2000 seeded points: hit and value exactly equal to the JAX
    package's; sample_locator equals sample_brute_force."""
    pts = _points(sc["st"])
    pos = torch.from_numpy(pts)
    jpos = jnp.asarray(pts)
    c, tc = sc["cells"], sc["t_cells"]
    n = tc.num_cells
    rng = np.random.default_rng(1)
    cid = rng.integers(0, n, pts.shape[0]).astype(np.int32)
    r = np.linalg.norm(pts, axis=1).astype(np.float32)
    # find_layer on the chosen cells' heights at the points' radii
    got = find_layer(tc.height[cid], tc.num_layers[cid], torch.from_numpy(r))
    want = jax.vmap(jcells.find_layer)(c.height[cid], c.num_layers[cid],
                                       jnp.asarray(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # sample_one_cell
    gi, gv = sample_one_cell(tc, torch.from_numpy(cid), pos,
                             torch.from_numpy(r))
    wi, wv = jax.vmap(lambda i, p, rr: jcells.sample_one_cell(c, i, p, rr))(
        jnp.asarray(cid), jpos, jnp.asarray(r))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # the two samplers of the parity raygens
    bh, bv = sample_brute_force(tc, pos)
    jbh, jbv = jax.vmap(lambda p: jcells.sample_brute_force(c, p))(jpos)
    lh, lv = sample_locator(tc, sc["t_loc"], pos)
    jlh, jlv = jax.vmap(lambda p: jsample_locator(c, sc["loc"], p))(jpos)
    for got, want in ((bh, jbh), (bv, jbv), (lh, jlh), (lv, jlv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(lh, bh) and torch.equal(lv, bv)
    assert 0.2 < float(bh.float().mean()) < 0.9     # inside and outside


@pytest.mark.parametrize("mode", ["grid", "sphere"])
def test_torch_accel_build_matches_jax_and_oracle(sc, mode):
    """Value ranges bit-equal to the JAX package's and to refimpl's
    buildGrid_ICON / buildShell_ICON; majorants (K5b's plain version)
    equal to JAX's update_majorants."""
    st, ds, tds, tf = sc["st"], sc["ds"], sc["tds"], sc["t_tf"]
    if mode == "grid":
        got = accel.build_grid_accel(tds, st.world_bounds_lo,
                                     st.world_bounds_hi, GRID_DIMS)
        ref = refimpl.build_grid_icon(ds, GRID_DIMS, st.world_bounds_lo,
                                      st.world_bounds_hi)
        bounds = (got.world_lo, got.world_hi)
    else:
        got = accel.build_shell_accel(tds, st.spherical_bounds_lo,
                                      st.spherical_bounds_hi, SHELL_DIMS)
        ref = refimpl.build_shell_icon(ds, SHELL_DIMS,
                                       st.spherical_bounds_lo,
                                       st.spherical_bounds_hi)
        bounds = (got.sph_lo, got.sph_hi)
    want = sc["acc"][mode]
    vr = got.value_ranges.numpy()
    np.testing.assert_array_equal(vr, np.asarray(want.value_ranges))
    np.testing.assert_array_equal(vr[:, 0], ref[0])
    np.testing.assert_array_equal(vr[:, 1], ref[1])
    np.testing.assert_array_equal(got.dims.numpy(), np.asarray(want.dims))
    for b, jb in zip(bounds, (want[1], want[2])):
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    upd = accel.update_majorants(got, tf.values, tf.value_range)
    np.testing.assert_array_equal(upd.max_opacities.numpy(),
                                  np.asarray(want.max_opacities))
    assert float(upd.max_opacities.max()) > 0.0


@pytest.fixture(scope="module")
def oracle(sc):
    """refimpl.render_ae / render_accel, 2 samples (the contract of
    tests/test_accel.py:78-118)."""
    st, tf = sc["st"], sc["tf"]
    args = (sc["ds"], np.asarray(tf.values), np.asarray(tf.value_range),
            np.float32(1.0), sc["cam"].basis(W, H), W, H,
            st.world_bounds_lo, st.world_bounds_hi)
    out = {"ae": refimpl.render_ae(*args, unit_distance=UD, num_samples=2)}
    for mode, (key, lo, hi) in {
            "sphere": ("s", st.spherical_bounds_lo, st.spherical_bounds_hi),
            "grid": ("b", st.world_bounds_lo, st.world_bounds_hi)}.items():
        ref_accel = {"mode": mode,
                     "dims": np.asarray(SHELL_DIMS if mode == "sphere"
                                        else GRID_DIMS),
                     key + "lo": lo, key + "hi": hi,
                     "max_opacities": np.asarray(
                         sc["acc"][mode].max_opacities)}
        out[mode] = refimpl.render_accel(*args, ref_accel, unit_distance=UD,
                                         num_samples=2)
    return out


@pytest.mark.parametrize("sampler", ["brute", "locator"])
@pytest.mark.parametrize("raygen", ["ae", "sphere", "grid"])
def test_torch_parity_render_matches_jax_and_oracle(sc, oracle, raygen,
                                                    sampler):
    """Two progressive samples through render_frame_ae / render_frame_accel
    (the wrapper runs K8's plain version on CPU tensors) against the JAX
    package's renders and the numpy oracle.  Measured: 0 of 256 fb pixels
    differ from either for every case; accum equals the oracle's bit for
    bit and is within 1 ULP of JAX's."""
    a, f = jrender.alloc_frame(W, H)
    ta, tfb = render.alloc_frame(W, H)
    for s in range(2):
        lp = sc["lp"]._replace(accum_id=jnp.int32(s))
        tlp = interop.launch_params(lp)
        kw = dict(width=W, height=H, sampler=sampler)
        if raygen == "ae":
            a, f = jrender.render_frame_ae(sc["cells"], sc["tf"], lp, a, f,
                                           locator=sc["loc"], **kw)
            out = render.render_frame_ae(sc["t_cells"], sc["t_tf"], tlp, ta,
                                         tfb, locator=sc["t_loc"], **kw)
        else:
            a, f = jrender.render_frame_accel(
                sc["cells"], sc["tf"], sc["acc"][raygen], lp, a, f,
                accel_mode=raygen, locator=sc["loc"], **kw)
            out = render.render_frame_accel(
                sc["t_cells"], sc["t_tf"], sc["t_acc"][raygen], tlp, ta, tfb,
                accel_mode=raygen, locator=sc["t_loc"], **kw)
        assert out[0] is ta and out[1] is tfb       # updated in place
    fb = tfb.numpy().view(np.uint32)
    assert int((fb != np.asarray(f)).sum()) <= JAX_FB_MISMATCH
    assert float(np.abs(ta.numpy() - np.asarray(a)).max()) <= JAX_ACCUM_TOL
    accum_ref, fb_ref = oracle[raygen]
    assert int((fb != fb_ref).sum()) <= ORACLE_FB_MISMATCH
    close = np.all(np.abs(ta.numpy() - accum_ref) <= 2e-3, axis=-1)
    assert close.mean() >= 1.0 - ORACLE_FB_MISMATCH / (W * H)
    assert (fb_ref != 0).mean() > 0.05                # not a blank image


@pytest.mark.parametrize("sampler", ["brute", "locator"])
@pytest.mark.parametrize("raygen", ["ae", "sphere", "grid"])
def test_torch_parity_raw_mode(sc, raygen, sampler):
    """K8's raw mode (`out=`, plain version): wrote and colour equal to
    `_pixels`' own sample (colour 0 where the ray misses the box), the
    debug output as with the finalize; and each raw sample through K10's
    mean finalize over one rank (composite.mean_payload, finalize_mean)
    equals parity_track's own finalize bit for bit, accum and fb, over two
    samples on every pixel and on a strided subset of lanes."""
    from icon_rt_tpu_torch.ops import composite
    from icon_rt_tpu_torch.ops.fast import alloc_raw
    accel = sc["t_acc"].get(raygen)
    kw = dict(width=W, height=H, raygen=raygen, sampler=sampler,
              locator=sc["t_loc"], accel=accel)
    for pix in (None, torch.arange(3, W * H, 7, dtype=torch.int32)):
        L = W * H if pix is None else pix.shape[0]
        a_f, f_f = torch.zeros(L, 4), torch.zeros(L, dtype=torch.int32)
        a_r, f_r = a_f.clone(), f_f.clone()
        for k in range(2):
            tlp = interop.launch_params(sc["lp"])._replace(
                accum_id=torch.tensor(k, dtype=torch.int32))
            d_f, d_r = (torch.zeros(L, 2, dtype=torch.int32)
                        for _ in range(2))
            render.parity_track(sc["t_cells"], sc["t_tf"], tlp, a_f, f_f,
                                pix=pix, debug=d_f, **kw)
            raw = alloc_raw(L, torch.device("cpu"))
            render.parity_track(sc["t_cells"], sc["t_tf"], tlp, None, None,
                                pix=pix, debug=d_r, out=raw, **kw)
            lanes = torch.arange(W * H) if pix is None else pix.long()
            wrote, ca = render._pixels(
                sc["t_cells"], sc["t_tf"], tlp, lanes % W, lanes // W, W, H,
                raygen, sampler, sc["t_loc"], accel)[:2]
            assert torch.equal(raw.wrote, wrote) and bool(wrote.any())
            assert torch.equal(raw.ca, torch.where(wrote[:, None], ca, 0.0))
            assert torch.equal(d_r, d_f)
            composite.finalize_mean(composite.mean_payload(raw.wrote,
                                                           raw.ca),
                                    a_r, f_r, tlp.accum_id)
            assert torch.equal(a_r, a_f) and torch.equal(f_r, f_f)
        assert int((f_f != 0).sum()) > L // 20


def test_torch_golden_framebuffer():
    """tests/test_golden.py's pinned framebuffer through the port (AE,
    brute force, 2 samples, 8x8): at most 2 mismatching pixels, the
    golden test's own allowance; measured 0."""
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
    from icon_rt_tpu_torch.models.transfunc import make_transfunc
    ds = synthetic.latlon_section(n_lat=2, n_lon=2, lat_range=(-30, 30),
                                  lon_range=(-30, 30), num_layers=3,
                                  radius=100.0, thickness=30.0)
    st = compute_stats(ds)
    tf = make_transfunc(value_range=tuple(st.data_range), size=32)
    lp = render.make_launch_params(_camera(st).basis(8, 8),
                                   st.world_bounds_lo, st.world_bounds_hi,
                                   unit_distance=5.0)
    cells = build_cells(ds)
    acc, fb = render.alloc_frame(8, 8)
    for s in range(2):
        render.render_frame_ae(
            cells, tf, lp._replace(accum_id=torch.tensor(s, dtype=torch.int32)),
            acc, fb, width=8, height=8)
    mism = int((fb.numpy().view(np.uint32) != GOLDEN_FB).sum())
    assert mism <= 2, f"{mism} pixels differ from golden"


def test_torch_sdda_degenerate_planes_pin_rng(sc):
    """One shell-DDA ray through the section: its final LCG state and
    colour equal JAX's trace_sdda on the same ray and majorants.  The ray
    walks the zero-length diagonal visits of the degenerate r = 0 lat/lon
    planes (one draw per visit of a cell with a positive majorant), so a
    traversal that skipped them would leave another state."""
    st, tf, acc = sc["st"], sc["tf"], sc["acc"]["sphere"]
    lp = sc["lp"]
    x, y = 9, 6
    rng0 = jlcg_init(jnp.uint32(x), jnp.uint32(y))
    org, d, rng = jrender.generate_ray(lp, jnp.int32(x), jnp.int32(y), rng0)
    hit, t0, t1 = jbox_test(org, d, jnp.float32(0.0), jnp.float32(1e10),
                            lp.bounds_lo, lp.bounds_hi)
    assert bool(hit)
    classify = lambda v: jpost_classify(tf, v)
    sample = lambda p: jcells.sample_brute_force(sc["cells"], p)
    # an unreachable cell opacity majorant everywhere: no collision ends
    # the walk, every visit draws
    mo = jnp.full_like(acc.max_opacities, 1e-3)
    want = jtrace_sdda(sample, classify, mo, acc.dims, acc.sph_lo,
                       acc.sph_hi, org, d, t0, t1, rng, lp.unit_distance)
    t = lambda a: torch.from_numpy(np.array(np.asarray(a)))
    tc = sc["t_cells"]
    got = trace_sdda(lambda p: sample_brute_force(tc, p),
                     lambda v: post_classify(sc["t_tf"], v), t(mo),
                     t(acc.dims), t(acc.sph_lo), t(acc.sph_hi), t(org),
                     t(d)[None], t(t0)[None], t(t1)[None],
                     torch.tensor([int(rng)], dtype=torch.int64),
                     t(lp.unit_distance))
    assert int(got.rng[0]) == int(want.rng)
    np.testing.assert_array_equal(got.color[0].numpy(),
                                  np.asarray(want.color))
    # the shell segment, then a diagonal walk of several visits
    assert int(got.steps[0]) >= 4


def _scalar_scan(tc, cand, p, r):
    """The kernel's sample of one point in plain Python (csrc/parity.cu
    `sample`, `inside_cell`): the whole-shell test on the squared radius,
    then the first-match scan over its candidates -- the radial compare,
    then the planes in order, each test stopping at its first failure.
    Returns the counts of (radial, plane1, plane2, plane3, hit, shell)
    stops."""
    out = [0] * 6
    s_lo, s_hi = tc.shell.numpy()[2:]
    s = p[0] * p[0] + p[1] * p[1] + p[2] * p[2]         # f32, in order
    if not (s >= s_lo and s <= s_hi):
        out[5] += 1
        return out
    hb, ht = tc.h_bot.numpy(), tc.h_top.numpy()
    planes = tc.planes.numpy()
    for c in cand:
        if c < 0:
            break
        if not (r >= hb[c] and r <= ht[c]):
            out[0] += 1
            continue
        for k in range(3):
            pl = planes[c, k]
            ev = (pl[0] * p[0] + pl[1] * p[1] + pl[2] * p[2]) - pl[3]
            if not ev <= np.float32(0.0):
                out[1 + k] += 1
                break
        else:
            out[4] += 1
            return out
    return out


@pytest.mark.parametrize("sampler", ["brute", "locator"])
def test_torch_work_counts_candidate_tests(sc, sampler):
    """ops/woodcock.py `Work`, the event counts behind K8's bound: on 2000
    seeded points (half of them not counted, some outside the cells'
    shell), the samples the whole-shell test rejects, the candidate tests
    by where each stops, the hits and their layers equal a scalar replay
    of the kernel's sample; every count exact."""
    from icon_rt_tpu_torch.models.cells import _radius
    from icon_rt_tpu_torch.models.locator import locator_rows
    from icon_rt_tpu_torch.ops.woodcock import Work
    tc, loc = sc["t_cells"], sc["t_loc"]
    pos = torch.from_numpy(_points(sc["st"]))
    mask = torch.arange(pos.shape[0]) % 2 == 0
    work = Work(tc, sampler, loc if sampler == "locator" else None)
    work.sample(pos, mask)
    got = work.counts()
    r = _radius(pos).numpy()
    if sampler == "locator":
        cands = loc.bins[locator_rows(loc, pos)[1]].numpy()
    else:
        cands = np.broadcast_to(np.arange(tc.num_cells), (pos.shape[0],
                                                          tc.num_cells))
    want = np.zeros(6, np.int64)
    for i in np.nonzero(mask.numpy())[0]:
        want += _scalar_scan(tc, cands[i], pos[i].numpy(), r[i])
    names = ("radial", "plane1", "plane2", "plane3", "hit", "shell")
    assert [got[k] for k in names] == want.tolist()
    assert 0 < got["shell"] < got["eval"]
    hit, _ = sample_brute_force(tc, pos)
    assert got["eval"] == int(mask.sum())
    assert got["hit"] == int((hit & mask).sum()) > 0
    assert got["hit_layers"] == 3 * got["hit"]       # 3 layers per cell
    assert got["draw"] == got["advance"] == 0


@pytest.mark.parametrize("raygen", ["ae", "sphere", "grid"])
def test_torch_work_counts_tracking(sc, raygen):
    """`Work` through K8's plain version (one sample, 16x16): both samplers
    count the same draws, advances, samples, samples outside the shell and
    hits (they walk one RNG stream); every AE iteration draws once, and an
    accel iteration draws, advances or both."""
    from icon_rt_tpu_torch.ops.woodcock import Work
    tlp = interop.launch_params(sc["lp"])
    pix = torch.arange(W * H, dtype=torch.int32)
    counts = {}
    for sampler in ("brute", "locator"):
        work = Work(sc["t_cells"], sampler, sc["t_loc"])
        acc, fb = render.alloc_frame(W, H)
        dbg = torch.zeros(W * H, 2, dtype=torch.int32)
        render._parity_torch(sc["t_cells"], sc["t_tf"], tlp, pix, acc, fb,
                             dbg, W, H, raygen, sampler, sc["t_loc"],
                             sc["t_acc"].get(raygen), work)
        counts[sampler] = work.counts()
        steps = int(dbg[:, 1].sum())
    same = ("draw", "advance", "eval", "shell", "hit", "hit_layers",
            "hit_cells")
    assert all(counts["brute"][k] == counts["locator"][k] for k in same)
    c = counts["locator"]
    assert c["eval"] <= c["draw"] and c["hit"] > 0
    if raygen == "ae":
        assert c["draw"] == steps and c["advance"] == 0
    else:
        assert c["draw"] <= steps <= c["draw"] + c["advance"]
    assert 0 < c["entries"] and c["hit_cells"] <= c["plane_cells"] \
        <= c["radial_cells"] <= sc["t_cells"].num_cells


#: fb pixels of 256 (after 2 samples) where the wedge sampler's render may
#: differ from JAX's: measured 0 for ae, sphere and grid, the other
#: samplers' bound.  The Newton's last bits differ from JAX's (XLA
#: contracts its vertex sums into FMAs), which could move a hit at a face;
#: on this section (radius 100) that does not happen.  At the globe's
#: scale it does (tests/test_torch_app.py WEDGE_MISMATCH)
JAX_WEDGE_FB_MISMATCH = 2


@pytest.fixture(scope="module")
def wsc(sc):
    """The section's wedges in both packages."""
    from icon_rt_tpu.models.wedges import build_wedges
    w = build_wedges(sc["ds"])
    return dict(w=w, t_w=interop.wedges(w))


@pytest.mark.parametrize("raygen", ["ae", "sphere", "grid"])
def test_torch_parity_wedge_matches_jax(sc, wsc, raygen):
    """The wedge sampler (K9-p's plain version) through render_frame_ae /
    render_frame_accel against JAX's (sampler="wedge", wedges=...), two
    progressive samples on the section scene: fb within
    JAX_WEDGE_FB_MISMATCH pixels, accum within 1 ULP elsewhere (measured
    1.8e-7)."""
    a, f = jrender.alloc_frame(W, H)
    ta, tfb = render.alloc_frame(W, H)
    for s in range(2):
        lp = sc["lp"]._replace(accum_id=jnp.int32(s))
        tlp = interop.launch_params(lp)
        kw = dict(width=W, height=H, sampler="wedge")
        if raygen == "ae":
            a, f = jrender.render_frame_ae(sc["cells"], sc["tf"], lp, a, f,
                                           locator=sc["loc"], wedges=wsc["w"],
                                           **kw)
            render.render_frame_ae(sc["t_cells"], sc["t_tf"], tlp, ta, tfb,
                                   locator=sc["t_loc"], wedges=wsc["t_w"],
                                   **kw)
        else:
            a, f = jrender.render_frame_accel(
                sc["cells"], sc["tf"], sc["acc"][raygen], lp, a, f,
                accel_mode=raygen, locator=sc["loc"], wedges=wsc["w"], **kw)
            render.render_frame_accel(
                sc["t_cells"], sc["t_tf"], sc["t_acc"][raygen], tlp, ta, tfb,
                accel_mode=raygen, locator=sc["t_loc"], wedges=wsc["t_w"],
                **kw)
    fb = tfb.numpy().view(np.uint32)
    differ = fb != np.asarray(f)
    assert int(differ.sum()) <= JAX_WEDGE_FB_MISMATCH
    same = ~differ
    assert float(np.abs(ta.numpy() - np.asarray(a))[same].max()) \
        <= JAX_ACCUM_TOL
    assert (fb != 0).mean() > 0.05


def test_torch_work_counts_wedge_scan(sc, wsc):
    """ops/woodcock.py `Work` with the wedge sampler, the counts behind
    K9-p's bound: on 600 seeded points (half of them counted) the samples
    that the wedge shell test rejects, then for the others the columns
    visited, their layers, the Newtons run and their iterations, and the
    hits equal a scalar replay of csrc/parity.cu's `sample<kWedge>` (the
    shell test on x*x + y*y + z*z, then `wedge_column`: find_layer, the
    window up to the column's top, the first hit), each inversion run
    alone.  Then through K9-p's plain AE: one draw per iteration."""
    from icon_rt_tpu_torch.models.cells import _radius
    from icon_rt_tpu_torch.models.locator import locator_rows
    from icon_rt_tpu_torch.ops.uelems import newton
    from icon_rt_tpu_torch.ops.woodcock import Work
    tc, loc, w = sc["t_cells"], sc["t_loc"], wsc["t_w"]
    pos = torch.from_numpy(_points(sc["st"], 600, seed=5))
    mask = torch.arange(pos.shape[0]) % 2 == 0
    work = Work(tc, "wedge", loc, w)
    work.sample(pos, mask)
    got = work.counts()
    r = _radius(pos)
    rows = loc.bins[locator_rows(loc, pos)[1]]
    nl_all, off = tc.num_layers, w.cell_offset
    want = dict(shell=0, wcol=0, wcol_layers=0, newton=0, newton_iters=0,
                hit=0)
    s_lo, s_hi = w.shell[2].item(), w.shell[3].item()
    for i in np.nonzero(mask.numpy())[0]:
        x, y, z = pos[i]
        sq = x * x + y * y + z * z
        if not (s_lo <= sq.item() <= s_hi):
            want["shell"] += 1
            continue
        found = False
        for c in rows[i].tolist():
            if c < 0 or found:
                break
            nl = int(nl_all[c])
            want["wcol"] += 1
            want["wcol_layers"] += nl
            base = int(find_layer(tc.height[c:c + 1], nl_all[c:c + 1],
                                  r[i:i + 1])[0])
            for d in range(w.layer_pad):
                if base + d >= nl:
                    break
                k = int(off[c]) + base + d
                hit, _, it = newton(pos[i:i + 1], w.verts[k:k + 1],
                                    w.scalars[k:k + 1], return_iters=True)
                want["newton"] += 1
                want["newton_iters"] += int(it[0])
                if bool(hit[0]):
                    want["hit"] += 1
                    found = True
                    break
    assert {k: got[k] for k in want} == want
    assert got["eval"] == int(mask.sum()) and want["hit"] > 0
    assert 0 < want["shell"] < got["eval"]
    assert 0 < got["wedges_read"] <= want["newton"]
    assert 0 < got["entries"] and got["hit_cells"] <= tc.num_cells
    # through the plain AE raygen: every iteration draws once
    work = Work(tc, "wedge", loc, w)
    acc, fb = render.alloc_frame(W, H)
    dbg = torch.zeros(W * H, 2, dtype=torch.int32)
    render._parity_torch(tc, sc["t_tf"], interop.launch_params(sc["lp"]),
                         torch.arange(W * H, dtype=torch.int32), acc, fb,
                         dbg, W, H, "ae", "wedge", loc, None, work, w)
    c = work.counts()
    assert c["draw"] == int(dbg[:, 1].sum()) and c["advance"] == 0
    assert 0 < c["hit"] <= c["eval"] <= c["draw"]
    assert c["newton_iters"] >= c["newton"] >= c["hit"]


@pytest.mark.parametrize("sampler", ["locator", "wedge"])
def test_torch_woodcock_skip_draws_change_nothing(sc, wsc, sampler,
                                                  monkeypatch):
    """ops/woodcock.py `woodcock_track` through K8's and K9-p's plain AE
    (one sample, 16x16): the draws that a lock-step iteration skips past
    the sampler's shell (SKIP_DRAWS of them) leave every lane's t,
    albedo, extinction, rng and steps, and the counted work, as one draw
    an iteration (SKIP_DRAWS = 0) gives them; the scene has samples
    outside the shell, so the skipping ran."""
    from icon_rt_tpu_torch.ops import woodcock
    results = []

    def record(*args, **kw):
        results.append(woodcock.woodcock_track(*args, **kw))
        return results[-1]

    monkeypatch.setattr(render, "woodcock_track", record)
    pix = torch.arange(W * H, dtype=torch.int32)
    counts = []
    for skip in (woodcock.SKIP_DRAWS, 0):
        monkeypatch.setattr(woodcock, "SKIP_DRAWS", skip)
        work = woodcock.Work(sc["t_cells"], sampler, sc["t_loc"],
                             wsc["t_w"])
        render._pixels(sc["t_cells"], sc["t_tf"],
                       interop.launch_params(sc["lp"]), pix % W, pix // W,
                       W, H, "ae", sampler, sc["t_loc"], None, work,
                       wsc["t_w"])
        counts.append(work.counts())
    a, b = results
    for field in a._fields:
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    assert counts[0] == counts[1]
    assert 0 < counts[0]["shell"] < counts[0]["eval"]
