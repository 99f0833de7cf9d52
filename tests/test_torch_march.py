"""PyTorch port, K3 (the deterministic march): the plain version's pieces
and frames held against icon_rt_tpu/ops/march.py on the same seeded inputs,
tables and camera, against a dense-scan oracle, and against its own
determinism, fine-map and cross-tier contracts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models.cells import build_cells as jbuild_cells
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.finemap import build_finemap as jbuild_finemap
from icon_rt_tpu.models.locator import build_locator as jbuild_locator
from icon_rt_tpu.models.locator import build_locator_csr as jcsr
from icon_rt_tpu.models.locator import densify_csr as jdensify
from icon_rt_tpu.models.qcells import bake_alpha_q as jbake
from icon_rt_tpu.models.qcells import quantize_cells as jquantize
from icon_rt_tpu.models.qcells import quantize_dataset_values as jqvalues
from icon_rt_tpu.models.shells import build_radial_bands as jbands
from icon_rt_tpu.models.shells import update_band_majorants as jmajorants
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops import march as jm
from icon_rt_tpu.ops.camera import Camera
from icon_rt_tpu.ops.fast import pack_cells as jpack_cells
from icon_rt_tpu.ops.fast import pack_test_rows as jpack_test_rows
from icon_rt_tpu.ops.render import alloc_frame as jalloc
from icon_rt_tpu.ops.render import make_launch_params as jmake_lp
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.ops import march as tm
from icon_rt_tpu_torch.ops.render import alloc_frame

torch.set_num_threads(1)

W = H = 48

#: per-pixel bounds of the port's march against JAX's on the scene of
#: tests/test_march.py (subdiv 2 x 5, 48x48), measured once: accum max abs
#: diff 1.6e-5 (f32 tier), 3.0e-5 (quantized, no fine map) and 2.4e-5
#: (fine map); fb 0, 0 and 1 pixels of 2304.  The port adds the depth and
#: colour sums of a crossing in sequence over the layers, XLA in its own
#: reduction order (and contracts some products into FMAs), a few ULP of a
#: pixel's sums.
ACCUM_BOUND = 1e-4
FB_BOUND = 2                 # pixels of 48 * 48


def _f32(v):
    return torch.tensor(np.float32(v))


@pytest.fixture(scope="module")
def scene():
    """tests/test_march.py's scene in both packages: the quantized tier of
    a value-quantized subdiv 2 x 5 icosphere with its fine map, the f32
    tier of the same dataset, and the 48x48 camera."""
    ds = jsyn.icosphere(subdivisions=2, num_layers=5)
    ds_q, _, _ = jqvalues(ds)
    st = jstats(ds_q)
    tf = jmake_tf(value_range=tuple(st.data_range), size=32)
    q = jbake(jquantize(ds_q), tf)
    csr, k_cap = jcsr(ds_q)
    loc = jdensify(csr, k_cap)
    bands = jmajorants(jbands(ds_q, 16), tf.values, tf.value_range)
    cam = Camera()
    cam.set_aspect(W / H)
    c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    r = st.spherical_bounds_hi[0]
    cam.set_orientation(c + np.array([2.2 * r, 0.4 * r, 0.9 * r], np.float32),
                        c, np.array([0, 0, 1], np.float32), cam.fovy)
    lp = jmake_lp(cam.basis(W, H), st.world_bounds_lo, st.world_bounds_hi,
                  unit_distance=1e4)
    fm = jbuild_finemap(loc, q.test12, k_cap)
    cells = jbuild_cells(ds_q)
    locf = jbuild_locator(ds_q)
    packed = jpack_cells(cells, tf)
    j = dict(q=q, loc=loc, k_cap=k_cap, bands=bands, tf=tf, lp=lp, fm=fm,
             cells=cells, locf=locf, packed=packed)
    t = dict(q=interop.quantized_cells(q, n=ds.num_cells),
             loc=interop.locator_packed(loc, k_cap),
             bands=interop.radial_bands(bands), tf=interop.transfunc(tf),
             lp=interop.launch_params(lp), fm=interop.finemap(fm),
             cells=interop.cells(cells), locf=interop.locator(locf),
             packed=interop.packed_cells(packed))
    return dict(j=j, t=t, ds=ds, ds_q=ds_q)


def _port(s, tier, accum_id=0, fm=False):
    t = s["t"]
    lp = t["lp"]._replace(accum_id=torch.tensor(accum_id, dtype=torch.int32))
    acc, fb = alloc_frame(W, H)
    if tier == "q":
        tm.render_frame_march_q(t["q"], t["loc"], t["bands"], t["tf"], lp,
                                acc, fb, width=W, height=H,
                                finemap=t["fm"] if fm else None)
    else:
        tm.render_frame_march(t["cells"], t["packed"], t["locf"], t["bands"],
                              lp, acc, fb, width=W, height=H)
    return acc.numpy(), fb.numpy().view(np.uint32)


def _jax(s, tier, fm=False):
    j = s["j"]
    lp = j["lp"]._replace(accum_id=jnp.int32(0))
    if tier == "q":
        a, f = jm.render_frame_march_q(
            j["q"], j["loc"], j["k_cap"], j["bands"], j["tf"], lp,
            *jalloc(W, H), width=W, height=H, chunk=W * H,
            finemap=j["fm"] if fm else None)
    else:
        a, f = jm.render_frame_march(j["cells"], j["packed"], j["locf"],
                                     j["bands"], lp, *jalloc(W, H),
                                     width=W, height=H, chunk=W * H)
    return np.asarray(a), np.asarray(f)


# ---------------------------------------------------------------------------
# (a) the closed-form column integral
# ---------------------------------------------------------------------------

def _layered_rays(seed):
    """tests/test_march.py:81-124: a random 6-layer profile and 8 rays from
    outside r = 2 at random impact parameters, some dipping below the
    bottom sphere and re-entering."""
    rng = np.random.default_rng(seed)
    lm, h_bot = 6, 1.0
    h_edges = np.concatenate([[h_bot], np.sort(rng.uniform(1.0, 2.0, lm - 1)),
                              [2.0]])
    alphas = rng.uniform(0.0, 2.0, lm)
    colors = rng.uniform(0.0, 1.0, (lm, 3))
    rays = []
    for _ in range(8):
        b = rng.uniform(0.0, 2.2)
        d0 = rng.uniform(2.5, 4.0)
        oo, od = b * b + d0 * d0, -d0
        disc_t = od * od - oo + 4.0
        if disc_t <= 0:
            t0, t1 = d0 - 0.1, d0 + 0.1
        else:
            t0 = -od - np.sqrt(disc_t)
            disc_b = od * od - oo + h_bot * h_bot
            if disc_b > 0:
                t1 = -od - np.sqrt(disc_b)
            else:
                t1 = -od + np.sqrt(disc_t) if rng.random() < 0.5 \
                    else -od + 0.3 * np.sqrt(disc_t)
        rays.append(tuple(np.float32(v) for v in (oo, od, t0, t1)))
    return lm, h_bot, h_edges, alphas, colors, rays


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_integrate_column_vs_jax_and_quadrature(seed):
    """Per ray: within 2.4e-7 of JAX's `_integrate_column` (measured 1.2e-7:
    XLA sums the layers in another order) and within the 2e-3 of
    tests/test_march.py of a float64 quadrature of the layered profile."""
    from test_march import _quadrature
    lm, h_bot, h_edges, alphas, colors, rays = _layered_rays(seed)
    prof = np.concatenate([h_edges[1:], alphas, np.zeros(lm)]).astype(
        np.float32)[None]
    ud = np.float32(0.37)
    cols = [colors[:, c].astype(np.float32)[None] for c in range(3)]
    for oo, od, t0, t1 in rays:
        got = tm._integrate_column(
            torch.from_numpy(prof), lm, _f32([h_bot]).reshape(1),
            torch.tensor([lm], dtype=torch.int32), _f32(t0).reshape(1),
            _f32(t1).reshape(1), _f32(od).reshape(1), _f32(oo), _f32(ud),
            tuple(torch.from_numpy(c) for c in cols))
        want = jm._integrate_column(
            jnp.asarray(prof), lm, jnp.asarray([h_bot], jnp.float32),
            jnp.asarray([lm], jnp.int32), jnp.asarray([t0]),
            jnp.asarray([t1]), jnp.asarray([od]), jnp.float32(oo),
            jnp.float32(ud), tuple(jnp.asarray(c) for c in cols))
        g = np.array([float(x[0]) for x in got])
        w = np.array([float(x[0]) for x in want])
        assert np.abs(g - w).max() <= 2.4e-7, (g, w)
        rgb_ref, trans_ref = _quadrature(h_edges, alphas, colors, float(t0),
                                         float(t1), float(od), float(oo),
                                         float(ud))
        assert np.allclose(g[1:], rgb_ref, atol=2e-3), (g, rgb_ref)
        assert abs(g[0] - trans_ref) < 2e-3


def test_torch_integrate_column_past_num_layers_adds_nothing():
    """Layers past a column's num_layers (inf ceilings) contribute exactly
    nothing: a column padded with extra layers integrates bit-equal to the
    unpadded one, and a lane with nl = 0 is transparent."""
    lm, h_bot, h_edges, alphas, colors, rays = _layered_rays(3)
    pad = 4
    heights = np.concatenate([h_edges[1:], np.full(pad, np.inf)])
    prof = np.concatenate([heights, alphas, np.ones(pad)]).astype(
        np.float32)[None]
    prof0 = np.concatenate([h_edges[1:], alphas]).astype(np.float32)[None]
    cols = [colors[:, c].astype(np.float32) for c in range(3)]
    for oo, od, t0, t1 in rays[:4]:
        args = (_f32([h_bot]).reshape(1),)
        geo = (_f32(t0).reshape(1), _f32(t1).reshape(1), _f32(od).reshape(1),
               _f32(oo), _f32(0.5))
        a = tm._integrate_column(
            torch.from_numpy(prof), lm + pad, *args,
            torch.tensor([lm], dtype=torch.int32), *geo,
            tuple(torch.from_numpy(np.concatenate([c, np.full(pad, 9.0,
                                                              np.float32)]))
                  [None] for c in cols))
        b = tm._integrate_column(
            torch.from_numpy(prof0), lm, *args,
            torch.tensor([lm], dtype=torch.int32), *geo,
            tuple(torch.from_numpy(c)[None] for c in cols))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        z = tm._integrate_column(
            torch.from_numpy(prof0), lm, *args,
            torch.tensor([0], dtype=torch.int32), *geo,
            tuple(torch.from_numpy(c)[None] for c in cols))
        assert float(z[0]) == 1.0 and all(float(c) == 0.0 for c in z[1:])


# ---------------------------------------------------------------------------
# (a') the kernel's layer ranges (csrc/march.cu `integrate`, `desc_top`,
#      `asc_bottom`), emulated in f32 scalars
# ---------------------------------------------------------------------------

def _chord(h, od, oo):
    """csrc/march.cu `half_chord` (and `_integrate_column`'s half_chord) in
    f32: sqrt(max(od * od - oo + h * h, 0)), each operation rounded."""
    return np.sqrt(np.maximum(od * od - oo + h * h, np.float32(0.0)))


def _kernel_layers(h, kn, t0, t1, od, oo, search):
    """The layers the kernel's integral visits, (descending piece's,
    ascending piece's) in visiting order: an empty piece is skipped; the
    descending piece starts at the count of ceilings j < kn - 1 with
    -od - s(h_j) > t0 (binary search; without `search`, as the quantized
    tier, at the top layer) and stops where -od - s(h_k) >= tm; the
    ascending piece starts at the count of ceilings j < kn with
    !(-od + s(h_j) > tm) (without `search` at layer 0) and stops where,
    for k > 0, -od + s(h_{k-1}) >= t1."""
    tm = min(max(-od, t0), t1)
    s = lambda x: _chord(x, od, oo)
    desc, asc = [], []
    if tm > t0:
        lo, hi = 0, kn - 1
        while search and lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (mid + 1, hi) if -od - s(h[mid]) > t0 else (lo, mid)
        for k in range((lo if search else kn - 1) if kn > 0 else -1, -1,
                       -1):
            if not -od - s(h[k]) < tm:
                break
            desc.append(k)
    if t1 > tm:
        lo, hi = 0, kn
        while search and lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (mid + 1, hi) if not -od + s(h[mid]) > tm else (lo, mid)
        for k in range(lo if search else 0, kn):
            if k > 0 and not -od + s(h[k - 1]) < t1:
                break
            asc.append(k)
    return desc, asc


def _integrate_kept(prof, lm, h_bot, nl, t0, t1, od, oo, ud, colors,
                    keep1, keep2):
    """`_integrate_column`'s expressions for one lane with the lengths of
    the layers outside keep1 (descending piece) and keep2 (ascending) set
    to 0: (trans_mult, cr, cg, cb), and the lengths (len1, len2) before
    that."""
    kn = max(min(lm, int(nl[0])), 0)
    hh, aa = prof[:, :kn], prof[:, lm:lm + kn]
    hlo = torch.cat([h_bot[:, None], hh[:, :kn - 1]], dim=1)[:, :kn]
    sig = aa / ud
    tmx = torch.minimum(torch.maximum(-od, t0), t1)
    odc = od[:, None]
    chord = lambda x: torch.sqrt(torch.clamp(odc * odc - oo + x * x, min=0.0))
    s_hi, s_lo = chord(hh), chord(hlo)
    len1 = torch.clamp(torch.minimum(-odc - s_lo, tmx[:, None])
                       - torch.maximum(-odc - s_hi, t0[:, None]), min=0.0)
    len2 = torch.clamp(torch.minimum(-odc + s_hi, t1[:, None])
                       - torch.maximum(-odc + s_lo, tmx[:, None]), min=0.0)
    od1 = sig * torch.where(keep1[None, :kn], len1, 0.0)
    od2 = sig * torch.where(keep2[None, :kn], len2, 0.0)
    suf, sufs = torch.zeros(1), torch.zeros_like(od1)
    for k in range(kn - 1, -1, -1):
        suf = suf + od1[:, k]
        sufs[:, k] = suf
    c2, c2s = torch.zeros(1), torch.zeros_like(od2)
    for k in range(kn):
        c2 = c2 + od2[:, k]
        c2s[:, k] = c2
    w1 = torch.exp(-(sufs - od1)) * (1.0 - torch.exp(-od1))
    w2 = torch.exp(-(suf[:, None] + c2s - od2)) * (1.0 - torch.exp(-od2))
    rgb = torch.stack([c[:, :kn] for c in colors], dim=1)
    p1, p2 = w1[:, None, :] * rgb, w2[:, None, :] * rgb
    acc = torch.zeros((1, 3))
    for k in range(kn - 1, -1, -1):
        acc = acc + p1[:, :, k]
    for k in range(kn):
        acc = acc + p2[:, :, k]
    return ((torch.exp(-(suf + c2)), acc[:, 0], acc[:, 1], acc[:, 2]),
            (len1[0].numpy(), len2[0].numpy()))


def _range_rays(seed):
    """A column of 8 layer slots, 6 ceilings above h_bot = 1 (two equal: a
    zero-thickness layer; the top at 2), +inf past them (nl < lm), and f32
    rays (oo, od, t0, t1) of six kinds: from outside the shell
    (`_layered_rays`' draw), grazing a ceiling or h_bot (impact parameter
    within 2 ULP of it), from inside the shell (t0 = 0, both pieces where
    the ray looks down), starting past their apex (tm == t0), ending
    before it (tm == t1), and crossings cut to a short random [t0, t1]
    inside the shell."""
    f = np.float32
    rng = np.random.default_rng(seed)
    lm, nl = 8, 6
    h = np.sort(rng.uniform(1.0, 2.0, nl)).astype(f)
    h[3] = h[2]
    h[-1] = f(2.0)
    heights = np.concatenate([h, np.full(lm - nl, np.inf, f)])
    rays = []

    def shell_ray(o_r, cos_t, lo=None):
        """oo, od and the shell segment [t0, t1] of a ray from radius o_r
        at angle acos(cos_t) to the outward radial."""
        oo, od = o_r * o_r, o_r * cos_t
        disc_t = od * od - oo + 4.0
        t_top = -od + np.sqrt(max(disc_t, 0.0))
        t_in = -od - np.sqrt(max(disc_t, 0.0))
        disc_b = od * od - oo + 1.0
        t0 = max(t_in, 0.0) if lo is None else lo
        t1 = -od - np.sqrt(disc_b) if disc_b > 0 and -od > 0 else t_top
        return [f(oo), f(od), f(t0), f(t1)]

    for _ in range(6):
        d0, b = rng.uniform(2.5, 4.0), rng.uniform(0.0, 2.2)
        rays.append(("outside", shell_ray(np.hypot(b, d0), -d0 /
                                          np.hypot(b, d0))))
        g = rng.choice(np.concatenate([[1.0], h]).astype(np.float64))
        b = g * (1.0 + rng.integers(-2, 3) * 6e-8)
        rays.append(("grazing", shell_ray(np.hypot(b, d0), -d0 /
                                          np.hypot(b, d0))))
        o_r = rng.uniform(1.05, 1.95)
        rays.append(("inside", shell_ray(o_r, rng.uniform(-0.3, 0.1))))
        rays.append(("past apex", shell_ray(o_r, rng.uniform(0.05, 1.0))))
        oo, od, t0, t1 = shell_ray(np.hypot(b, d0), -d0 / np.hypot(b, d0))
        rays.append(("before apex", [oo, od, t0,
                                     f(t0 + rng.uniform(0.0, 1.0)
                                       * max(-od - t0, 0.0))]))
        t0 = f(rng.uniform(0.0, 0.5))
        rays.append(("cut", shell_ray(o_r, rng.uniform(-1.0, 1.0), lo=t0)))
        rays[-1][1][3] = f(min(rays[-1][1][3], t0 + rng.uniform(0.0, 0.4)))
    return lm, nl, f(1.0), heights, rays


@pytest.mark.parametrize("search", [True, False], ids=["f32", "q"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_torch_integrate_layer_ranges_hold_every_layer(seed, search):
    """The kernel's layer ranges (`_kernel_layers`; the f32 tier searches
    a piece's start, the quantized tier walks from its end) hold every
    layer whose length `_integrate_column` finds > 0 in each piece, and
    integrating only those layers equals `_integrate_column` bit for bit:
    on the seeded rays of `_layered_rays` and on `_range_rays` (grazing
    rays, tm == t0, tm == t1, a zero-thickness layer, +inf-padded
    ceilings past nl < lm)."""
    lm6, h_bot6, h_edges, alphas6, colors6, rays6 = _layered_rays(seed)
    lm, nl, h_bot, heights, rays = _range_rays(seed)
    rng = np.random.default_rng(seed + 10)
    cases = [(lm6, lm6, np.float32(h_bot6), h_edges[1:].astype(np.float32),
              alphas6, colors6, ("layered", r)) for r in rays6]
    alphas, colors = rng.uniform(0.0, 2.0, lm), rng.uniform(0.0, 1.0, (lm, 3))
    cases += [(lm, nl, h_bot, heights, alphas, colors, r) for r in rays]
    ud = np.float32(0.37)
    seen = {"both": 0, "tm == t0": 0, "tm == t1": 0, "saved": 0}
    for lm_, nl_, hb, h, a, c, (kind, ray) in cases:
        oo, od, t0, t1 = (np.float32(v) for v in ray)
        kn = min(nl_, lm_)
        desc, asc = _kernel_layers(h, kn, t0, t1, od, oo, search)
        prof = torch.from_numpy(np.concatenate([h, a]).astype(np.float32)
                                )[None]
        cols = tuple(torch.from_numpy(c[:, i].astype(np.float32))[None]
                     for i in range(3))
        keep1 = torch.zeros(lm_, dtype=torch.bool)
        keep2 = torch.zeros(lm_, dtype=torch.bool)
        keep1[desc], keep2[asc] = True, True
        args = (prof, lm_, _f32([hb]).reshape(1),
                torch.tensor([nl_], dtype=torch.int32), _f32(t0).reshape(1),
                _f32(t1).reshape(1), _f32(od).reshape(1), _f32(oo), _f32(ud),
                cols)
        got, (len1, len2) = _integrate_kept(*args, keep1, keep2)
        want = tm._integrate_column(*args)
        assert set(np.flatnonzero(len1 > 0)) <= set(desc), (kind, ray)
        assert set(np.flatnonzero(len2 > 0)) <= set(asc), (kind, ray)
        for x, y in zip(got, want):
            assert torch.equal(x, y), (kind, ray)
        tmv = min(max(-od, t0), t1)
        seen["both"] += bool((len1 > 0).any() and (len2 > 0).any())
        seen["tm == t0"] += bool(tmv == t0 and not desc)
        seen["tm == t1"] += bool(tmv == t1 and not asc)
        seen["saved"] += len(desc) + len(asc) < 2 * kn
    assert all(v > 0 for v in seen.values()), seen


# ---------------------------------------------------------------------------
# (b) exits and gap skips
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rays(scene):
    """64 seeded rays from the test camera's distance into the globe, with
    t_now just before the shell, and the candidate columns of the locator
    bin each ray reaches next."""
    rng = np.random.default_rng(0)
    ds_q = scene["ds_q"]
    st = jstats(ds_q)
    R = float(st.spherical_bounds_hi[0])
    org = (np.array([2.2, 0.4, 0.9]) * R).astype(np.float32)
    d = -org[None] / np.linalg.norm(org) + rng.normal(scale=0.15,
                                                      size=(64, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_now = (np.linalg.norm(org) - R
             + rng.uniform(0, 0.1 * R, 64)).astype(np.float32)
    loc = scene["j"]["locf"]
    P = org[None] + d * (t_now + np.float32(0.05 * R))[:, None]
    r = np.linalg.norm(P, axis=1)
    n_lat, n_lon = (int(v) for v in np.asarray(loc.dims))
    lat = np.arcsin(np.clip(P[:, 2] / r, -1, 1))
    lon = np.arctan2(P[:, 1], P[:, 0])
    bl = np.clip(((lat - float(loc.lat_lo)) / (float(loc.lat_hi)
                  - float(loc.lat_lo)) * n_lat).astype(np.int32), 0,
                 n_lat - 1)
    bo = np.clip(((lon - float(loc.lon_lo)) / (float(loc.lon_hi)
                  - float(loc.lon_lo)) * n_lon).astype(np.int32), 0,
                 n_lon - 1)
    bins = np.asarray(loc.bins)[bl * n_lon + bo]
    return dict(org=org, d=d, od=(d @ org).astype(np.float32),
                oo=np.float32(org @ org), t_now=t_now, bl=bl, bo=bo,
                cid=np.maximum(bins, 0), valid=bins >= 0)


def _geo(rays, lib):
    """(org, dx, dy, dz, od, oo) in the arrays of `lib` (jnp or torch)."""
    a = jnp.asarray if lib == "jax" else (
        lambda x: torch.from_numpy(np.ascontiguousarray(x)))
    s = jnp.float32 if lib == "jax" else (lambda v: torch.tensor(v))
    d = rays["d"]
    return (tuple(s(v) for v in rays["org"]), a(d[:, 0]), a(d[:, 1]),
            a(d[:, 2]), a(rays["od"]), s(rays["oo"]))


@pytest.mark.parametrize("layout", ["q12", "f32_16"])
def test_torch_candidate_entries_vs_jax(scene, rays, layout):
    """The next entry of each ray's bin candidates, on the quantized
    storage rows (w = 0) and the f32 test rows (w at 3/7/11): equal to
    JAX's (no lane without a candidate ahead in one and not the other)."""
    if layout == "q12":
        rows = scene["t"]["q"].test12.numpy()[rays["cid"]]
    else:
        rows = np.asarray(jpack_test_rows(scene["j"]["cells"]))[rays["cid"]]
    w = layout == "f32_16"
    jo, jdx, jdy, jdz, jod, joo = _geo(rays, "jax")
    to, tdx, tdy, tdz, tod, too = _geo(rays, "torch")
    want = np.asarray(jm._candidate_entries(
        jnp.asarray(rows), jnp.asarray(rays["valid"]),
        jnp.asarray(rays["t_now"]), jo, jdx, jdy, jdz, jod, joo, w_cols=w))
    got = tm._candidate_entries(
        torch.from_numpy(rows), torch.from_numpy(rays["valid"]),
        torch.from_numpy(rays["t_now"]), to, tdx, tdy, tdz, tod, too,
        w_cols=w).numpy()
    big = np.finfo(np.float32).max
    assert ((want < big).sum() > 10)
    np.testing.assert_array_equal(got, want)


def _exit_planes_behind(test, rays):
    """(M,) whether a side plane with n.D > 0 is crossed at or before
    t_now (the ray has left that column already), and the earliest such
    crossing, both in float32 as the plain version computes them."""
    t = torch.from_numpy(test)
    org = [torch.tensor(v) for v in rays["org"]]
    d = torch.from_numpy(rays["d"])
    t_now = torch.from_numpy(rays["t_now"])
    behind = torch.zeros(len(t_now), dtype=torch.bool)
    first = torch.full_like(t_now, np.finfo(np.float32).max)
    for i in (0, 4, 8):
        a = t[:, i] * org[0] + t[:, i + 1] * org[1] + t[:, i + 2] * org[2] \
            - t[:, i + 3]
        b = t[:, i] * d[:, 0] + t[:, i + 1] * d[:, 1] + t[:, i + 2] * d[:, 2]
        ti = -a / torch.clamp(b, min=1e-30)
        hit = (b > 1e-30) & (ti <= t_now)
        behind |= hit
        first = torch.where(hit, torch.minimum(first, ti), first)
    return behind.numpy(), first.numpy()


def test_torch_column_exit_and_bin_exit_vs_jax(scene, rays):
    """The exit of each ray's first candidate column: equal to JAX's on
    every lane that has not crossed one of the column's exit planes before
    t_now (test_torch_column_exit_counts_planes_behind_t0 covers the
    others); the exit of its locator bin: the same lanes finite, within 1
    ULP (the CPU libm sin of torch and XLA differ in the last place)."""
    test = np.asarray(jpack_test_rows(scene["j"]["cells"]))[rays["cid"][:, 0]]
    seg_hi = rays["t_now"] + np.float32(1e6)
    jg, tg = _geo(rays, "jax"), _geo(rays, "torch")
    want = np.asarray(jm._column_exit(
        jnp.asarray(test), jnp.asarray(rays["t_now"]), jg[0], *jg[1:5], jg[5],
        jnp.asarray(seg_hi)))
    got = tm._column_exit(
        torch.from_numpy(test), torch.from_numpy(rays["t_now"]), tg[0],
        *tg[1:5], tg[5], torch.from_numpy(seg_hi)).numpy()
    behind, _ = _exit_planes_behind(test, rays)
    assert (~behind).sum() > 20
    np.testing.assert_array_equal(got[~behind], want[~behind])
    want = np.asarray(jm._bin_exit(
        scene["j"]["locf"], jnp.asarray(rays["bl"]), jnp.asarray(rays["bo"]),
        jnp.asarray(rays["t_now"]), *jg))
    got = tm._bin_exit(
        scene["t"]["locf"], torch.from_numpy(rays["bl"]),
        torch.from_numpy(rays["bo"]), torch.from_numpy(rays["t_now"]),
        *tg).numpy()
    big = np.finfo(np.float32).max
    np.testing.assert_array_equal(got < big, want < big)
    fin = want < big
    ulp = np.abs(got[fin].view(np.int32).astype(np.int64)
                 - want[fin].view(np.int32).astype(np.int64))
    assert fin.sum() > 50 and ulp.max() <= 1, ulp.max()


def test_torch_column_exit_counts_planes_behind_t0(scene, rays):
    """A DIVERGENCE FROM JAX (ROADMAP Queue 3, F4).  Where the ray has
    crossed one of the located column's exit planes (n.D > 0) at or before
    t0, the port's exit is that crossing, so the march's floor at t + eps
    advances the lane by eps: the behaviour icon_rt_tpu/ops/march.py:44-48
    documents for an f32 tie that re-locates the column a lane just left.
    JAX's `_column_exit` drops such crossings (`ti > t0`) and returns a
    later face, and its march then integrates a column the ray has left."""
    test = np.asarray(jpack_test_rows(scene["j"]["cells"]))[rays["cid"][:, 0]]
    seg_hi = rays["t_now"] + np.float32(1e6)
    jg, tg = _geo(rays, "jax"), _geo(rays, "torch")
    want = np.asarray(jm._column_exit(
        jnp.asarray(test), jnp.asarray(rays["t_now"]), jg[0], *jg[1:5], jg[5],
        jnp.asarray(seg_hi)))
    got = tm._column_exit(
        torch.from_numpy(test), torch.from_numpy(rays["t_now"]), tg[0],
        *tg[1:5], tg[5], torch.from_numpy(seg_hi)).numpy()
    behind, first = _exit_planes_behind(test, rays)
    assert behind.sum() > 5
    np.testing.assert_array_equal(got[behind], first[behind])
    assert (got[behind] <= rays["t_now"][behind]).all()
    assert (want[behind] > rays["t_now"][behind]).all()


def test_torch_march_tie_advances_by_eps():
    """The march on the quantized tier of a subdiv 5 x 16 closeup with the
    lower half of the LUT transparent (long rays through many columns, so
    many f32 ties between adjacent columns): with the fine map and without,
    all but 0.1% of the lanes agree within 1e-4, as tests/test_march.py:
    351-366 asks of JAX.  Measured once here: 0 of 4,096 lanes (max
    5.4e-7).  With JAX's column exit in the port's march, which integrates
    on through a column the ray has left at such a tie,
    scripts/torch_march_vs_jax.py tie finds 4 of 4,096 lanes up to 0.145
    at 64x64 and 58 of 64,667 up to 0.963 at 256x256."""
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models.cells import compute_stats
    from icon_rt_tpu_torch.models.finemap import build_finemap
    from icon_rt_tpu_torch.models.locator import (build_locator_csr,
                                                  densify_csr)
    from icon_rt_tpu_torch.models.qcells import (bake_alpha_q,
                                                 quantize_cells,
                                                 quantize_dataset_values)
    from icon_rt_tpu_torch.models.shells import (build_radial_bands,
                                                 update_band_majorants)
    from icon_rt_tpu_torch.models.transfunc import make_transfunc
    from icon_rt_tpu_torch.ops.fastq import _QTier
    from icon_rt_tpu_torch.ops.order import pixel_order
    from icon_rt_tpu_torch.ops.camera import Camera as TCamera
    from icon_rt_tpu_torch.ops.render import make_launch_params
    ds = synthetic.icosphere(5, 16)
    st = compute_stats(ds)
    tf = make_transfunc(value_range=tuple(st.data_range))
    lut = tf.values.clone()
    lut[: lut.shape[0] // 2, 3] = 0.0
    tf = tf._replace(values=lut)
    bands = update_band_majorants(build_radial_bands(ds, 64), tf.values,
                                  tf.value_range)
    ds_q, lo, hi = quantize_dataset_values(ds)
    q = bake_alpha_q(quantize_cells(ds_q, value_range=(lo, hi)), tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap)
    size = 64
    cam = TCamera()        # bench.py's closeup pose (bench.py:205-222)
    theta = np.arctan(1.15 * np.tan(0.5 * cam.fovy))
    v = np.array([2.2, 0.4, 0.9], np.float32)
    c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    cam.set_orientation(c + v / np.linalg.norm(v)
                        * float(st.spherical_bounds_hi[0]) / np.sin(theta),
                        c, np.array([0, 0, 1], np.float32), cam.fovy)
    ud = 10.0 ** (np.floor(np.log10(st.spherical_bounds_lo[0])) - 3)
    lp = make_launch_params(cam.basis(size, size), st.world_bounds_lo,
                            st.world_bounds_hi, unit_distance=ud)
    perm, n_cov = pixel_order(lp, st.spherical_bounds_lo[0],
                              st.spherical_bounds_hi[0], size, size)
    pix = perm[:n_cov].contiguous()
    out = [tm._march_torch(_QTier(q, loc, tf, f), bands, lp, pix, size,
                           size)[1] for f in (build_finemap(loc, q.test12),
                                              None)]
    d = (out[0] - out[1]).abs().amax(dim=1)
    assert int((d > 1e-4).sum()) <= 1e-3 * n_cov, (int((d > 1e-4).sum()),
                                                   float(d.max()))
    assert float((out[1][:, 3] > 0).float().mean()) > 0.5


# ---------------------------------------------------------------------------
# (c) frames against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["f32", "q", "q_finemap"])
def test_torch_march_frame_vs_jax(scene, case):
    """One converged pass of the whole frame (no pixel order), the port's
    plain K3 against JAX's march on the same tables: accum within
    ACCUM_BOUND everywhere, fb differing on at most FB_BOUND pixels."""
    tier = "f32" if case == "f32" else "q"
    fm = case == "q_finemap"
    at, ft = _port(scene, tier, fm=fm)
    aj, fj = _jax(scene, tier, fm=fm)
    assert (at[:, 3] > 0).sum() > 300
    assert np.abs(at - aj).max() <= ACCUM_BOUND, np.abs(at - aj).max()
    assert (ft != fj).sum() <= FB_BOUND, (ft != fj).sum()


def test_torch_march_pixel_order_equals_natural_order(scene):
    """render_frame_march_q with a pixel permutation renders the same
    pixels bit for bit (the lanes are independent)."""
    from icon_rt_tpu.ops.order import pixel_order as jpixel_order
    j = scene["j"]
    st = jstats(scene["ds_q"])
    perm, n_act = jpixel_order(j["lp"], st.spherical_bounds_lo[0],
                               st.spherical_bounds_hi[0], W, H)
    t = scene["t"]
    acc, fb = alloc_frame(W, H)
    tm.render_frame_march_q(t["q"], t["loc"], t["bands"], t["tf"], t["lp"],
                            acc, fb, width=W, height=H,
                            pixel_perm=torch.from_numpy(perm),
                            n_active=n_act)
    nat, fnat = _port(scene, "q")
    inv = np.argsort(perm)
    np.testing.assert_array_equal(acc.numpy()[inv], nat)
    np.testing.assert_array_equal(fb.numpy().view(np.uint32)[inv], fnat)


# ---------------------------------------------------------------------------
# (d) the dense-scan oracle of tests/test_march.py
# ---------------------------------------------------------------------------

#: largest |port - oracle| over the four pixels: measured once at 1.7e-5
#: (the oracle's own 1e5-point Riemann error dominates; docs/ROUND5.md:58-66
#: reports 2e-5 for JAX); tests/test_march.py:246 asserts 3e-3 for JAX
ORACLE_BOUND = 5e-5


def test_torch_march_matches_dense_scan_oracle():
    """tests/test_march.py:148-246's oracle (containment over every cell,
    1e5-point Riemann transmittance along the full ray) at its four
    pixels, on the port's march: within 3e-3, as JAX, and within
    ORACLE_BOUND over all four."""
    from icon_rt_tpu.models.transfunc import post_classify as jpost
    from icon_rt_tpu.ops.fast import _init_lanes as jinit
    from icon_rt_tpu_torch.ops.fastq import _QTier
    ds = jsyn.icosphere(subdivisions=1, num_layers=4)
    ds_q, _, _ = jqvalues(ds)
    st = jstats(ds_q)
    tf = jmake_tf(value_range=tuple(st.data_range), size=32)
    q = jbake(jquantize(ds_q), tf)
    csr, k_cap = jcsr(ds_q)
    loc = jdensify(csr, k_cap)
    bands = jmajorants(jbands(ds_q, 8), tf.values, tf.value_range)
    cam = Camera()
    cam.set_aspect(1.0)
    c = 0.5 * (st.world_bounds_lo + st.world_bounds_hi)
    r = st.spherical_bounds_hi[0]
    cam.set_orientation(c + np.array([2.2 * r, 0.4 * r, 0.9 * r], np.float32),
                        c, np.array([0, 0, 1], np.float32), cam.fovy)
    lp = jmake_lp(cam.basis(W, H), st.world_bounds_lo, st.world_bounds_hi,
                  unit_distance=1e4)
    tq = interop.quantized_cells(q, n=ds.num_cells)
    t12 = tq.test12.numpy()
    hf = tq.h_frac.numpy()
    vqt, aqt = tq.value_q.numpy(), tq.alpha_q.numpy()
    lm, ud = q.lm, 1e4
    oo = float(np.dot(np.asarray(lp.cam_org), np.asarray(lp.cam_org)))

    def oracle(xs, ys):
        init, consts, wrote = jinit(lp, xs, ys, W, H, bands.edges,
                                    bands.max_opacities, oo,
                                    bands.num_bands, prof_w=3 * lm)
        if not bool(wrote[0]):
            return np.zeros(4)
        D = np.array([float(consts.dx[0]), float(consts.dy[0]),
                      float(consts.dz[0])])
        O = np.asarray(lp.cam_org, np.float64)
        segs = [(float(init.t[0]), float(init.seg_hi[0]))]
        if float(consts.s1_hi[0]) > float(consts.s1_lo[0]):
            segs.append((float(consts.s1_lo[0]), float(consts.s1_hi[0])))
        tauacc, rgb = 0.0, np.zeros(3)
        for a, b in segs:
            ts = np.linspace(a, b, 100000)
            dt = ts[1] - ts[0]
            P = O[None, :] + ts[:, None] * D[None, :]
            rr = np.linalg.norm(P, axis=1)
            ins = ((P @ t12[:, 0:3].T <= 0) & (P @ t12[:, 3:6].T <= 0)
                   & (P @ t12[:, 6:9].T <= 0)
                   & (rr[:, None] >= t12[None, :, 9])
                   & (rr[:, None] <= t12[None, :, 10]))
            cell = np.where(ins.any(1), np.argmax(ins, 1), -1)
            hfr = hf[np.minimum(cell, hf.shape[0] - 1)].astype(np.float64)
            heights = (t12[cell][:, 9:10] + hfr * (
                (t12[cell][:, 10] - t12[cell][:, 9])[:, None]
                * (1.0 / 65535.0)))
            nl = t12[cell][:, 11].astype(int)
            heights = np.where(np.arange(1, lm + 1)[None, :] <= nl[:, None],
                               heights, np.inf)
            lay = np.minimum((rr[:, None] > heights).sum(1), lm - 1)
            alpha = (aqt[cell, lay].astype(np.float64) / 255.0
                     * float(q.alpha_max))
            v = (float(q.value_lo) + vqt[cell, lay].astype(np.float64)
                 * (float(q.value_hi - q.value_lo) / 255.0))
            sig = np.where(cell >= 0, alpha, 0.0) / ud
            rgba = np.asarray(jpost(tf, jnp.asarray(v, jnp.float32)))
            odseg = sig * dt
            taupre = tauacc + np.concatenate([[0.0],
                                              np.cumsum(odseg)[:-1]])
            w = np.exp(-taupre) * (1 - np.exp(-odseg))
            rgb += (w[:, None] * rgba[:, :3] * (cell >= 0)[:, None]).sum(0)
            tauacc += odseg.sum()
        return np.concatenate([rgb, [1 - np.exp(-tauacc)]])

    tabs = (tq, interop.locator_packed(loc, k_cap),
            interop.radial_bands(bands), interop.transfunc(tf))
    tier = _QTier(tabs[0], tabs[1], tabs[3], None)
    tlp = interop.launch_params(lp)
    worst = 0.0
    for px_id in (W * H // 2 + W // 2, 17 * W + 23, 31 * W + 14, 12 * W + 21):
        wrote, ca, _ = tm._march_torch(tier, tabs[2], tlp, torch.tensor(
            [px_id], dtype=torch.int32), W, H)
        want = oracle(jnp.asarray([px_id % W], jnp.int32),
                      jnp.asarray([px_id // W], jnp.int32))
        err = np.abs(ca.numpy()[0] - want).max()
        worst = max(worst, err)
        assert err < 3e-3, (px_id, ca, want)
    assert worst <= ORACLE_BOUND, worst


# ---------------------------------------------------------------------------
# (e) determinism, bounds, the fine map
# ---------------------------------------------------------------------------

def test_torch_march_deterministic_and_alpha_bounds(scene):
    """The same accum_id renders bit for bit the same; alpha is a
    transmittance complement in [0, 1] and every value is finite."""
    a1, f1 = _port(scene, "q", accum_id=3)
    a2, f2 = _port(scene, "q", accum_id=3)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(f1, f2)
    a, _ = _port(scene, "f32")
    for acc in (a1, a):
        assert np.isfinite(acc).all()
        assert (acc[:, 3] >= 0.0).all() and (acc[:, 3] <= 1.0).all()


def test_torch_march_finemap_two_stage_matches(scene):
    """tests/test_march.py:351-366 on the port: the march with the fine map
    renders the image of the march without it within 1e-4."""
    a0, _ = _port(scene, "q")
    a1, _ = _port(scene, "q", fm=True)
    np.testing.assert_allclose(a1, a0, atol=1e-4)


def test_torch_march_accumulates_passes(scene):
    """A second pass (accum_id 1) averages into the first: accum is the mean
    of the two single-pass images (a fresh frame at accum_id 1 holds half
    of its pass), on every pixel whose two jittered rays both meet the
    shell or both miss it (a pass whose ray misses leaves the pixel as it
    was)."""
    t = scene["t"]
    acc, fb = alloc_frame(W, H)
    for aid in (0, 1):
        tm.render_frame_march_q(t["q"], t["loc"], t["bands"], t["tf"],
                                t["lp"]._replace(accum_id=torch.tensor(
                                    aid, dtype=torch.int32)),
                                acc, fb, width=W, height=H)
    a0, f0 = _port(scene, "q", accum_id=0)
    a1, f1 = _port(scene, "q", accum_id=1)
    same = (f0 != 0) == (f1 != 0)
    assert same.sum() > 0.97 * W * H
    np.testing.assert_allclose(acc.numpy()[same], (a1 + 0.5 * a0)[same],
                               atol=1e-6)


# ---------------------------------------------------------------------------
# (f) rmse_q
# ---------------------------------------------------------------------------

def test_torch_march_rmse_q_equals_jax(scene):
    """tests/test_march.py:317-324 and bench.py `_rmse_q_vs_f32`: march_q
    against march_f32 on the value-quantized scene measures the pure u8/u16
    quantization error; the port's value equals JAX's within 1e-5
    (measured once: 3.6837e-4 against 3.6780e-4; both accums agree with
    JAX within ACCUM_BOUND per pixel)."""
    def rmse(am, aq):
        both = (am[:, 3] > 0) & (aq[:, 3] > 0)
        return float(np.sqrt(np.mean((am[both] - aq[both]) ** 2)))

    r_t = rmse(_port(scene, "f32")[0], _port(scene, "q")[0])
    r_j = rmse(_jax(scene, "f32")[0], _jax(scene, "q")[0])
    assert 0.0 < r_t < 0.05
    assert abs(r_t - r_j) <= 1e-5, (r_t, r_j)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def test_torch_march_wrappers_reject_bad_inputs(scene):
    t = scene["t"]
    pix = torch.arange(W * H, dtype=torch.int32)
    acc, fb = alloc_frame(W, H)
    kw = dict(width=W, height=H)
    qa = (t["q"], t["loc"], t["bands"], t["tf"], t["lp"])
    with pytest.raises(ValueError):
        tm.march_q(*qa, pix, acc.double(), fb, **kw)
    with pytest.raises(ValueError):
        tm.march_q(*qa, pix[:10], acc, fb, **kw)
    with pytest.raises(ValueError):
        tm.march_q(t["q"]._replace(alpha_q=t["q"].alpha_q.int()), *qa[1:],
                   pix, acc, fb, **kw)
    fa = (t["packed"], t["locf"], t["bands"], t["lp"])
    with pytest.raises(ValueError):
        tm.march_f32(t["packed"]._replace(prof=t["packed"].prof[:, :32]),
                     *fa[1:], pix, acc, fb, **kw)
    with pytest.raises(ValueError):
        tm.march_f32(*fa, pix, acc, fb.long(), **kw)


# ---------------------------------------------------------------------------
# the cost output (JAX's return_cost)
# ---------------------------------------------------------------------------

#: lanes of 48 * 48 whose march cost differs from JAX's (by one iteration
#: each), measured once: 41 (f32 tier) and 43 (quantized).  A locate at
#: t + eps just past a column's exit face falls between two columns in one
#: package's rounding and inside the next column in the other's (XLA
#: contracts the plane tests into FMAs), and the miss costs one zero-width
#: gap-skip iteration; mostly in JAX (40 lanes), on 1-2 lanes in the port.
COST_MISMATCH_BOUND = 64


@pytest.mark.parametrize("tier", ["f32", "q"])
def test_torch_march_cost_vs_jax(scene, tier):
    """The plain K3's per-lane cost (the iterations a lane entered, the one
    that ends it included) against JAX's `march_rays(_q)(...,
    return_cost=True)` without the fine map: JAX counts a batch's global
    iterations, so each lane is marched there as a batch of its own.  Equal
    on all but COST_MISMATCH_BOUND lanes, within one iteration on those,
    so the frame's maximum is within one of the frame's `n_it`; 0 on every
    lane that misses the shell, >= 1 on every other; the frame is the one
    the wrapper renders without `cost`, bit for bit."""
    import jax
    t, j = scene["t"], scene["j"]
    pix = torch.arange(W * H, dtype=torch.int32)
    ys, xs = np.divmod(np.arange(W * H, dtype=np.int32), W)
    lp = j["lp"]._replace(accum_id=jnp.int32(0))
    if tier == "q":
        march = lambda x, y: jm.march_rays_q(
            j["q"], j["loc"], j["k_cap"], j["bands"], j["tf"], lp, x, y, W,
            H, return_cost=True)
        run = lambda acc, fb, **kw: tm.march_q(
            t["q"], t["loc"], t["bands"], t["tf"], t["lp"], pix, acc, fb,
            width=W, height=H, **kw)
    else:
        march = lambda x, y: jm.march_rays(
            j["cells"], j["packed"], j["locf"], j["bands"], lp, x, y, W, H,
            return_cost=True)
        run = lambda acc, fb, **kw: tm.march_f32(
            t["packed"], t["locf"], t["bands"], t["lp"], pix, acc, fb,
            width=W, height=H, **kw)
    wrote, _, n_it = march(jnp.asarray(xs), jnp.asarray(ys))
    lane = jax.jit(lambda x, y: march(x, y)[2])
    want = np.array([int(lane(jnp.asarray(xs[i:i + 1]),
                              jnp.asarray(ys[i:i + 1])))
                     for i in range(W * H)])
    assert want.max() == int(n_it)
    cost = torch.full((W * H,), -1, dtype=torch.int32)
    acc, fb = alloc_frame(W, H)
    run(acc, fb, cost=cost)
    acc0, fb0 = alloc_frame(W, H)
    run(acc0, fb0)
    assert torch.equal(acc, acc0) and torch.equal(fb, fb0)
    c = cost.numpy()
    wrote = np.asarray(wrote)
    assert wrote.sum() > 300 and (~wrote).sum() > 100
    assert (c[~wrote] == 0).all() and (c[wrote] >= 1).all()
    d = c - want
    assert np.abs(d).max() <= 1
    assert int((d != 0).sum()) <= COST_MISMATCH_BOUND, int((d != 0).sum())
    assert abs(int(c.max()) - int(n_it)) <= 1


def _tf_range(tf_t, tf_j, which):
    """Both packages' TFs at one of three value ranges: the scene's, a
    narrower one inside the values and one past their top."""
    lo, hi = (float(v) for v in tf_t.value_range)
    rng = {"scene": (lo, hi), "narrow": (lo + 0.25 * (hi - lo),
                                         lo + 0.5 * (hi - lo)),
           "past top": (hi, hi + 0.7 * (hi - lo))}[which]
    r = np.array(rng, np.float32)
    return (tf_t._replace(value_range=torch.from_numpy(r.copy())),
            tf_j._replace(value_range=jnp.asarray(r)))


def _code_table_kernel_way(value_lo, v_scale, lut, tf_range):
    """The (256, 3) RGB code table the way K3-q's card builds it
    (csrc/march.cu `code_table_kernel`): code k one f32 scalar at a time,
    v = value_lo + k * v_scale through postClassify, from the tier's host
    scalars value_lo and v_scale (floats) and the TF's (S, 4) LUT and (2,)
    range."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    lut, rng = lut.cpu(), tf_range.cpu()
    S = lut.shape[0]
    lo, v_scale = f(value_lo), f(v_scale)
    out = torch.empty((256, 3), dtype=torch.float32)
    for k in range(256):
        v = lo + f(float(k)) * v_scale
        vn = (v - rng[0]) / (rng[1] - rng[0])
        vs = vn * f(float(S))
        idx = int(vs.to(torch.int32))
        frac = vs - f(float(idx))
        l1 = lut[min(max(idx, 0), S - 1), :3]
        l2 = lut[min(max(idx + 1, 0), S - 1), :3]
        out[k] = l1 * frac + l2 * (f(1.0) - frac)
    return out


@pytest.mark.parametrize("which", ["scene", "narrow", "past top"])
def test_torch_march_q_code_table_kernel_way_bit_equal(scene, which):
    """The code table the way K3-q's card builds it
    (`_code_table_kernel_way`: one f32 scalar at a time from the tier's
    host scalars, `march_q_scales`) is bit-equal to the plain version's
    (`_QTier.code_table`, post_classify on tensors) and to JAX's
    `_vq_rgb_table`, RGB; the host scales equal the plain tier's.  On the
    card, `test_cuda_march_q_after_tf_edit_matches_plain` holds the
    kernel's own table to the plain version through its frames."""
    from icon_rt_tpu_torch.ops import fastq
    t, j = scene["t"], scene["j"]
    tf_t, tf_j = _tf_range(t["tf"], j["tf"], which)
    tier = fastq._QTier(t["q"], t["loc"], tf_t, None)
    scales = tm.march_q_scales(t["q"])
    for got, want in zip(scales, (tier.a_scale, tier.v_scale,
                                  tier.inv_span)):
        assert np.float32(got) == want.numpy()
    tab = _code_table_kernel_way(float(t["q"].value_lo), scales[1],
                                 tf_t.values, tf_t.value_range)
    assert torch.equal(tab, tier.code_table[:, :3])
    jtab = np.asarray(jm._vq_rgb_table(j["q"], tf_j)).reshape(256, 4)
    np.testing.assert_array_equal(tab.numpy(), jtab[:, :3])


def test_torch_march_q_launch_args_follow_edits(scene):
    """K3-q's launch arguments, built without a device read: a new
    accum_id, a camera move and a TF edit each reach them (the kernel reads
    lp's and the TF's tensors at the addresses given; an in-place LUT edit
    through tf.values' own address), and the tables' host copies
    (`host_values`) are read once and again after an in-place write or a
    rebind of the storage; K3-f32's arguments have no TF range, and its
    locator scalars (`track_params`, K1's too) equal a host read's."""
    from icon_rt_tpu_torch.ops.fast import (host_values, track_common,
                                            track_frame, track_params)
    from icon_rt_tpu_torch.ops.fastq import track_q_params
    t = scene["t"]
    cpu = torch.device("cpu")
    lp, tf = t["lp"], t["tf"]
    f0 = track_frame(lp, cpu)
    lp_id = lp._replace(accum_id=torch.tensor(5, dtype=torch.int32))
    f1 = track_frame(lp_id, cpu)
    assert f1.accum_id == lp_id.accum_id.data_ptr() != f0.accum_id
    assert f1.cam_org == f0.cam_org == lp.cam_org.data_ptr()
    lp_mv = lp._replace(cam_org=lp.cam_org * 1.01)
    f2 = track_frame(lp_mv, cpu)
    assert f2.cam_org == lp_mv.cam_org.data_ptr() != f0.cam_org
    tf2 = tf._replace(value_range=tf.value_range * 0.5)
    tab = torch.empty((256, 4))
    assert tm.march_args(t["q"], tf2, tab).tf_range == \
        tf2.value_range.data_ptr() != tm.march_args(t["q"], tf, tab).tf_range
    with pytest.raises(ValueError, match="accum_id"):
        track_frame(lp._replace(accum_id=torch.tensor(1)), cpu, "march_q")
    m32 = tm.march_args(None, None, None)          # K3-f32: no TF range
    assert m32.tf_range is None and m32.tab is None

    q = t["q"]._replace(value_lo=t["q"].value_lo.clone())
    pix = torch.arange(W * H, dtype=torch.int32)
    acc, fb = alloc_frame(W, H)
    c = track_common(t["bands"], lp, pix, acc, fb, width=W, height=H,
                     samples=1, preserve_cache=False)
    assert (c.frame.accum_id, c.frame.cam_org) == (
        lp.accum_id.data_ptr(), lp.cam_org.data_ptr())
    p0 = track_q_params(q, t["loc"], tf2, t["fm"], c)
    assert p0.lut == tf2.values.data_ptr() and p0.use_fine == 1
    assert host_values(q.value_lo) is host_values(q.value_lo)
    s0 = tm.march_q_scales(q)
    q.value_lo.sub_(0.25)                        # an in-place write
    p1 = track_q_params(q, t["loc"], tf2, t["fm"], c)
    assert p1.value_lo == pytest.approx(p0.value_lo - 0.25, abs=1e-6)
    assert tm.march_q_scales(q)[1] > s0[1]
    q.value_lo.data = torch.tensor(0.125)        # a rebind of its storage
    assert host_values(q.value_lo) == 0.125
    assert (p1.n_lat, p1.n_lon) == tuple(t["loc"].dims.tolist())
    # K1's and K3-f32's: the locator's scalars, as a host read gives them
    locf = t["locf"]
    pf = track_params(t["packed"], locf, c)
    win = torch.stack([locf.lat_lo, locf.lat_hi, locf.lon_lo,
                       locf.lon_hi]).to(torch.float32).tolist()
    assert [pf.lat_lo, pf.lat_hi, pf.lon_lo, pf.lon_hi] == win
    assert [pf.n_lat, pf.n_lon] == locf.dims.tolist()
