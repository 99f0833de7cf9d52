"""Deterministic transmittance march — the zero-variance integrator of the
fast tiers.

The classified field is piecewise constant per (cell, layer): within a
column, alpha(r) and the colour are step functions of the radius whose
breakpoints are the layer ceilings.  Along a ray the optical depth of each
piece is closed form, so one front-to-back march over the ray's column
crossings computes exactly the expectation that the Woodcock trackers
(ops/fast.py, ops/fastq.py) converge to over many samples:

    E[rgb]   = ambient * INT sigma(t) e^{-tau(t)} c(t) dt,
               sigma = classified_alpha / unit_distance
    E[alpha] = 1 - e^{-tau(inf)}

One pass per launch; only the pixel jitter varies between passes.  Rays stop
at transmittance below ET_EPS (standard early ray termination).

Per iteration a lane: advances to the second shell segment or ends; skips a
zero-majorant radial band to its exit; otherwise locates the column at
t + eps and integrates the crossing [t, t_exit] in closed form
(`_integrate_column`, exit from `_column_exit`), or on a locate miss jumps
to the exact next event, the minimum of the bin's candidates' next entries
(`_candidate_entries`), the locator-bin boundary (`_bin_exit`) and the band
exit.  Colours come from the baked rgb rows on the f32 tier and from a
256-entry code table through the live TF on the quantized tier.

Kernel of this module:

  K3 `march_f32` / `march_q` (CUDA C++, csrc/march.cu, one source with an
     instantiation per tier; the lane setup and the tiers are shared with K1
     and K2) — one thread per ray, epilogue fused.  Plain version:
     `_march_frame_torch`, the lock-step loop `_march_torch` over the
     still-active lanes, on the tiers of ops/fast.py and ops/fastq.py.

The plain version writes the sums of `_integrate_column` as explicit loops
over the layers, in the order the kernel streams them (the descending piece
from the top layer down, then the ascending piece from the bottom up), so
kernel and plain version agree bit for bit; the JAX package's XLA
reductions add in another order and are held to a tolerance in the tests.

The JAX package's TPU scheduling is not ported: generational compaction,
the fine map's two-stage tail cap with its rank-gather merge, and the
lax.map chunking only decide when a lane's work runs.  One difference
remains: JAX's `max_outer` counts global iterations, in which a lane that
the tail cap did not serve retries; here it counts the lane's own
iterations.  The two agree whenever every pending lane is served, which
holds without the fine map, and no lane of the tests or of chip_smoke.py
comes near the cap.  The same holds for the cost (`cost=` of the
wrappers, JAX's `return_cost`): JAX returns `n_it`, the batch's global
iterations; the port stores per lane the iterations the lane entered,
counting the one in which it ends -- at the start of a body, where its
shell segments run out, or at its end, where T < ET_EPS -- as JAX counts
the body that sets `done`, and 0 for a lane that misses the shell.  So
without the fine map a lane's cost is JAX's `n_it` of that lane marched
alone, and the batch maximum is `n_it`, up to f32 ties: a locate at t +
eps just past a column's exit face may fall between two columns in one
package's rounding and in the next column in the other's (XLA contracts
the plane tests into FMAs), and that miss costs one zero-width gap-skip
iteration (41 and 43 of 2,304 lanes differ by one at the scene of
tests/test_torch_march.py).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.cells import Cells
from ..models.finemap import FineMap
from ..models.locator import Locator
from ..models.qcells import QuantizedCells
from ..models.shells import RadialBands
from ..models.transfunc import Transfunc
from ..utils import cuda_build
from .fast import (F32, PROF_W, RGB_W, TEST_W, PackedCells, _band_exit,
                   _band_of, _check, _F32Tier, _init_lanes, _r_of,
                   _select_band, _TrackParams, check_rows, frame_lanes,
                   frame_on, host_values, track_common, track_params)
from .fastq import _QTier, _TrackQParams, check_q_tables, track_q_params
from .render import _finalize

#: early-ray-termination transmittance floor: the tail below it is dropped
ET_EPS = 1e-3
#: iteration cap of a lane (the JAX march's max_outer)
MAX_OUTER = 8192

#: kernel launches of K3 per tier, those with the cost output apart (the
#: wrappers count only CUDA launches)
launches = {"march_f32": 0, "march_q": 0, "march_f32_cost": 0,
            "march_q_cost": 0}

_BIG = torch.finfo(torch.float32).max


# ===========================================================================
# Closed-form pieces (plain versions of the kernel's device functions)
# ===========================================================================

def _integrate_column(prof, lm: int, h_bot, nl, t0, t1, od, oo, ud,
                      colors):
    """Emission-absorption integral of one column crossing [t0, t1].

    prof: (M, >= 2 lm) rows of lm ceilings (ascending, +inf past num_layers)
    then lm classified alphas; h_bot, nl (M,) from the test row; colors the
    per-layer (R, G, B), each (M, lm); od (M,), oo and ud () tensors.  The
    ray is inside the column over [t0, t1], so only the radial layers
    matter: r(t) descends to its apex at t* = -od and ascends after, so the
    crossing splits at tm = clip(t*, t0, t1) into a descending piece (front
    to back = layer k descending) and an ascending piece (k ascending), and
    a constant (sigma, c) segment of length dt at depth tau_in adds
    c e^{-tau_in} (1 - e^{-sigma dt}).

    The depth and colour sums are sequential loops: the descending piece
    from the top layer down (suffix depth `suf`), then the ascending piece
    from the bottom up (prefix depth `c2`); layers past every lane's nl add
    exactly nothing and are left out.  Returns (trans_mult, cr, cg, cb):
    the caller multiplies its transmittance by trans_mult and adds T * c."""
    M = prof.shape[0]
    kn = min(lm, int(nl.max())) if M else 0
    kn = max(kn, 0)
    hh = prof[:, :kn]
    aa = prof[:, lm:lm + kn]
    hlo = torch.cat([h_bot[:, None], hh[:, :kn - 1]], dim=1)[:, :kn]
    k1 = torch.arange(1, kn + 1, device=prof.device)
    sig = torch.where(k1[None, :] <= nl[:, None], aa, 0.0) / ud
    tm = torch.minimum(torch.maximum(-od, t0), t1)
    odc = od[:, None]

    def half_chord(h):   # sqrt(max(od^2 - oo + h^2, 0)); +inf for h = +inf
        return torch.sqrt(torch.clamp(odc * odc - oo + h * h, min=0.0))

    s_hi, s_lo = half_chord(hh), half_chord(hlo)
    # descending piece [t0, tm]: layer k spans [t_dec(h_k), t_dec(h_{k-1})]
    len1 = torch.clamp(torch.minimum(-odc - s_lo, tm[:, None])
                       - torch.maximum(-odc - s_hi, t0[:, None]), min=0.0)
    # ascending piece [tm, t1]: layer k spans [t_inc(h_{k-1}), t_inc(h_k)]
    len2 = torch.clamp(torch.minimum(-odc + s_hi, t1[:, None])
                       - torch.maximum(-odc + s_lo, tm[:, None]), min=0.0)
    od1 = sig * len1
    od2 = sig * len2

    zero = torch.zeros(M, dtype=F32, device=prof.device)
    suf, sufs = zero, torch.zeros_like(od1)
    for k in range(kn - 1, -1, -1):     # inclusive suffix, from the top
        suf = suf + od1[:, k]
        sufs[:, k] = suf
    tau1 = suf
    c2, c2s = zero, torch.zeros_like(od2)
    for k in range(kn):                 # inclusive prefix, from the bottom
        c2 = c2 + od2[:, k]
        c2s[:, k] = c2
    w1 = torch.exp(-(sufs - od1)) * (1.0 - torch.exp(-od1))
    w2 = torch.exp(-(tau1[:, None] + c2s - od2)) * (1.0 - torch.exp(-od2))
    rgb = torch.stack([c[:, :kn] for c in colors], dim=1)      # (M, 3, kn)
    p1, p2 = w1[:, None, :] * rgb, w2[:, None, :] * rgb
    acc = torch.zeros((M, 3), dtype=F32, device=prof.device)
    for k in range(kn - 1, -1, -1):
        acc = acc + p1[:, :, k]
    for k in range(kn):
        acc = acc + p2[:, :, k]
    return torch.exp(-(tau1 + c2)), acc[:, 0], acc[:, 1], acc[:, 2]


def _column_exit(test16, t0, org, dx, dy, dz, od, oo, seg_hi):
    """Where the ray leaves the located column: the minimum of the three
    side-plane crossings with n.D > 0, the inward bottom-sphere crossing
    after t0 and the outward top-sphere crossing after t0, clamped to the
    shell segment end.  test16: (M, 16) rows (n, w) x 3, h_bot, h_top.

    A side plane with n.D > 0 counts even where it is crossed at or before
    t0.  Such a crossing means the ray had left the column already: an f32
    tie re-located the column the lane just left (a point eps past a
    shared face lies in both columns' half-spaces).  The caller's floor at
    t + eps then advances the lane by eps, the bias the JAX package
    documents (icon_rt_tpu/ops/march.py:44-48).  JAX's `_column_exit`
    drops these crossings (its `ti > t0`), so there a tie integrates the
    left column on to its far face: up to 0.96 of a pixel's colour at
    subdiv 5 x 16 with a half-transparent TF (ROADMAP Queue 3, F4)."""
    ox, oy, oz = org
    t_exit = torch.clamp(seg_hi, max=_BIG)
    for i in (0, 4, 8):
        nx, ny, nz, w = (test16[:, i], test16[:, i + 1], test16[:, i + 2],
                         test16[:, i + 3])
        a = nx * ox + ny * oy + nz * oz - w
        b = nx * dx + ny * dy + nz * dz
        ti = torch.where(b > 1e-30, -a / torch.clamp(b, min=1e-30), _BIG)
        t_exit = torch.minimum(t_exit, ti)
    h_bot, h_top = test16[:, 12], test16[:, 13]
    disc_b = od * od - oo + h_bot * h_bot
    tb_in = -od - torch.sqrt(torch.clamp(disc_b, min=0.0))
    t_exit = torch.minimum(t_exit, torch.where((disc_b > 0.0) & (tb_in > t0),
                                               tb_in, _BIG))
    tt_out = -od + torch.sqrt(torch.clamp(od * od - oo + h_top * h_top,
                                          min=0.0))
    return torch.minimum(t_exit, torch.where(tt_out > t0, tt_out, _BIG))


def _candidate_entries(trows, valid, t_now, org, dx, dy, dz, od, oo,
                       w_cols: bool = False):
    """Exact next entry t >= t_now of each lane's nearest candidate column.

    trows: (M, K, 12) quantized storage rows (normals at 0/3/6, the planes
    pass through the origin, h_bot/h_top at 9/10) or, with w_cols, (M, K,
    16) f32 test rows ((n, w) x 3, h_bot/h_top at 12/13); valid (M, K).  A
    column is three half-spaces (an interval [pl_lo, pl_hi] in t) and the
    annulus [h_bot, h_top] (up to two intervals when the ray dips below
    h_bot).  Returns (M,), FLT_MAX where no candidate lies ahead."""
    ox, oy, oz = org
    pl_lo = torch.full(trows.shape[:2], -_BIG, dtype=F32, device=trows.device)
    pl_hi = torch.full_like(pl_lo, _BIG)
    nonempty = valid
    dxc, dyc, dzc = dx[:, None], dy[:, None], dz[:, None]
    stride = 4 if w_cols else 3
    for i in (0, stride, 2 * stride):
        nx, ny, nz = trows[..., i], trows[..., i + 1], trows[..., i + 2]
        a = nx * ox + ny * oy + nz * oz
        if w_cols:
            a = a - trows[..., i + 3]
        b = nx * dxc + ny * dyc + nz * dzc
        tcross = -a / torch.where(torch.abs(b) > 1e-30, b, 1e-30)
        pl_hi = torch.minimum(pl_hi, torch.where(b > 1e-30, tcross, _BIG))
        pl_lo = torch.maximum(pl_lo, torch.where(b < -1e-30, tcross, -_BIG))
        nonempty = nonempty & ~((torch.abs(b) <= 1e-30) & (a > 0.0))
    h_bot = trows[..., 12 if w_cols else 9]
    h_top = trows[..., 13 if w_cols else 10]
    odc = od[:, None]
    disc_b = odc * odc - oo + h_bot * h_bot
    disc_t = odc * odc - oo + h_top * h_top
    has_b = disc_b > 0.0
    sb = torch.sqrt(torch.clamp(disc_b, min=0.0))
    st = torch.sqrt(torch.clamp(disc_t, min=0.0))
    tt0, tt1 = -odc - st, -odc + st
    tb0, tb1 = -odc - sb, -odc + sb
    nonempty = nonempty & (disc_t > 0.0)
    # annulus piece 1: [tt0, has_b ? min(tb0, tt1) : tt1]
    i1_hi = torch.where(has_b, torch.minimum(tb0, tt1), tt1)
    # annulus piece 2 (re-entry after dipping below h_bot): [tb1, tt1]
    i2_lo = torch.maximum(tb1, tt0)
    tnc = t_now[:, None]
    ent = torch.full_like(pl_lo, _BIG)
    for lo, hi, ok in ((tt0, i1_hi, nonempty), (i2_lo, tt1, nonempty & has_b)):
        lo2 = torch.maximum(torch.maximum(lo, pl_lo), tnc)
        hi2 = torch.minimum(hi, pl_hi)
        ent = torch.minimum(ent, torch.where(ok & (hi2 >= lo2), lo2, _BIG))
    return ent.amin(dim=1) if ent.shape[1] else t_now.new_full(
        t_now.shape, _BIG)


def _bin_exit(loc: Locator, bl, bo, t_now, org, dx, dy, dz, od, oo):
    """First crossing after t_now of the locator bin (bl, bo)'s boundary:
    two latitude cones |z| = sin(lat_e) r, solved squared (so the mirror
    cone adds spurious EARLIER crossings, which only shorten the skip) and
    two longitude planes through the z axis."""
    ox, oy, oz = org
    dims = loc.dims.to(F32)
    lat_step = (loc.lat_hi - loc.lat_lo) / dims[0]
    lon_step = (loc.lon_hi - loc.lon_lo) / dims[1]
    out = torch.full(t_now.shape, _BIG, dtype=F32, device=t_now.device)
    for e in (0, 1):
        s = torch.sin(loc.lat_lo + (bl.to(F32) + e) * lat_step)
        s2 = s * s
        A = dz * dz - s2
        B = 2.0 * (oz * dz - s2 * od)
        C = oz * oz - s2 * oo
        disc = B * B - 4.0 * A * C
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        quad = torch.abs(A) > 1e-30
        lin = ~quad & (torch.abs(B) > 1e-30)
        safe_a = torch.where(quad, 2.0 * A, 1e-30)
        r1 = (-B - sq) / safe_a
        r2 = (-B + sq) / safe_a
        rl = -C / torch.where(torch.abs(B) > 1e-30, B, 1e-30)
        for root, ok in ((r1, quad & (disc > 0.0)), (r2, quad & (disc > 0.0)),
                         (rl, lin)):
            out = torch.minimum(out, torch.where(ok & (root > t_now), root,
                                                 _BIG))
    for e in (0, 1):
        le = loc.lon_lo + (bo.to(F32) + e) * lon_step
        nx, ny = -torch.sin(le), torch.cos(le)
        a = nx * ox + ny * oy
        b = nx * dx + ny * dy
        ok = torch.abs(b) > 1e-30
        tc = -a / torch.where(ok, b, 1e-30)
        out = torch.minimum(out, torch.where(ok & (tc > t_now), tc, _BIG))
    return out


# ===========================================================================
# K3 plain version: the lock-step march over the still-active lanes
# ===========================================================================

def _march_torch(tier, bands: RadialBands, lp, pix, width: int,
                 height: int):
    """The march of the rays of `pix` ((L,) pixel ids) on a storage tier
    (ops/fast.py `_F32Tier` or ops/fastq.py `_QTier`).  Returns (wrote (L,)
    bool, color_alpha (L, 4) f32, cost (L,) int32): the converged expected
    radiance of the jittered ray of sample lp.accum_id, alpha = 1 -
    transmittance, and the iterations each lane entered, the one that ends
    it included (0 for a lane that misses the shell; the module docstring
    has how its maximum relates to JAX's `n_it`).

    All still-active lanes take one iteration together; the set shrinks as
    lanes end.  The tier gives test_rows(cid) -> (M, 16), locate(px, py,
    pz, r, return_rows=True) -> (cid, hit, rows, valid, bl, bo), w_cols, ml,
    loc, march_prof(cid) -> (M, >= 2 ml) and march_colors(cid, prof)."""
    dev = pix.device
    L = pix.shape[0]
    nb = bands.max_opacities.shape[0]
    edges, majors = bands.edges, bands.max_opacities
    xs = torch.remainder(pix, width).to(torch.int64)
    ys = torch.div(pix, width, rounding_mode="floor").to(torch.int64)
    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    org = (ox, oy, oz)
    oo = ox * ox + oy * oy + oz * oz
    ud = lp.unit_distance
    ln = _init_lanes(lp, xs, ys, width, height, edges, majors, oo, nb,
                     lp.accum_id.to(torch.int64))
    t, seg_hi, si = ln.t.clone(), ln.seg_hi.clone(), ln.si.clone()
    trans = torch.ones(L, dtype=F32, device=dev)
    rgb = torch.zeros((L, 3), dtype=F32, device=dev)
    eps_abs = ud * 1e-4

    a = torch.nonzero(~ln.done).squeeze(1)
    cost = torch.zeros(L, dtype=torch.int32, device=dev)
    it = 0
    while a.numel() and it < MAX_OUTER:
        it += 1
        cost[a] += 1
        # shell-segment advance; a lane past its last segment ends
        ta, sha = t[a], seg_hi[a]
        at_end = ta >= sha
        to1 = at_end & ~si[a] & (ln.s1_hi[a] > ln.s1_lo[a])
        ta = torch.where(to1, ln.s1_lo[a], ta)
        sha = torch.where(to1, ln.s1_hi[a], sha)
        seg_hi[a] = sha
        si[a] = si[a] | to1
        keep = torch.nonzero(~(at_end & ~to1)).squeeze(1)
        a, ta, sha = a[keep], ta[keep], sha[keep]
        dx, dy, dz, od = ln.dx[a], ln.dy[a], ln.dz[a], ln.od[a]

        eps = torch.maximum(eps_abs, torch.abs(ta) * 4e-7)
        tl = ta + eps
        r = _r_of(tl, od, oo)
        band = _band_of(r, edges, nb)
        seg_end, _ = _band_exit(tl, band, sha, od, oo, edges)
        t_new = torch.maximum(seg_end, tl)       # zero-majorant band: skip it
        p = torch.nonzero(~(_select_band(majors, band) <= 0.0)).squeeze(1)
        if p.numel():
            cid, hit, rows, valid, bl, bo = tier.locate(
                ox + dx[p] * tl[p], oy + dy[p] * tl[p], oz + dz[p] * tl[p],
                r[p], return_rows=True)
            h = torch.nonzero(hit).squeeze(1)
            if h.numel():          # hit: integrate the crossing [t, t_exit]
                k, c = p[h], cid[h]
                test = tier.test_rows(c)
                t_exit = torch.maximum(_column_exit(
                    test, ta[k], org, dx[k], dy[k], dz[k], od[k], oo,
                    sha[k]), tl[k])
                prof = tier.march_prof(c)
                tmul, cr, cg, cb = _integrate_column(
                    prof, tier.ml, test[:, 12], test[:, 14].to(torch.int32),
                    ta[k], t_exit, od[k], oo, ud,
                    tier.march_colors(c, prof))
                g = a[k]
                tg = trans[g]
                rgb[g] = rgb[g] + tg[:, None] * torch.stack([cr, cg, cb], 1)
                trans[g] = tg * tmul
                t_new[k] = t_exit
            mi = torch.nonzero(~hit).squeeze(1)
            if mi.numel():         # miss: the exact next event of the gap
                k = p[mi]
                geo = (tl[k], org, dx[k], dy[k], dz[k], od[k], oo)
                skip = torch.minimum(
                    _candidate_entries(rows[mi], valid[mi], *geo,
                                       w_cols=tier.w_cols),
                    _bin_exit(tier.loc, bl[mi], bo[mi], *geo))
                t_new[k] = torch.maximum(torch.minimum(skip, seg_end[k]),
                                         tl[k])
        t[a] = t_new
        a = a[~(trans[a] < ET_EPS)]

    amb = lp.ambient_color * lp.ambient_radiance
    ca = torch.cat([rgb * amb, (1.0 - trans)[:, None]], dim=1)
    return ln.wrote, torch.where(ln.wrote[:, None], ca, 0.0), cost


def _march_frame_torch(tier, bands: RadialBands, lp, pix, accum, fb,
                       width: int, height: int, cost=None):
    """Plain-PyTorch K3: `_march_torch` and the epilogue (`_finalize`);
    updates accum (L, 4) and fb (L,) in place, and with `cost` ((W*H,)
    int32) stores each lane's iterations at its pixel."""
    wrote, ca, steps = _march_torch(tier, bands, lp, pix, width, height)
    acc, pixels = _finalize(wrote, ca, accum, fb, lp.accum_id)
    accum.copy_(acc)
    fb.copy_(pixels)
    if cost is not None:
        cost[pix.long()] = steps


# ===========================================================================
# K3 kernel: build, bind, launch
# ===========================================================================

class _MarchArgs(ctypes.Structure):
    """Mirror of `MarchArgs` in csrc/march.cu (same field order)."""
    _fields_ = [
        ("tab", ctypes.c_void_p),
        ("a_scale", ctypes.c_float), ("v_scale", ctypes.c_float),
        ("inv_span", ctypes.c_float), ("et_eps", ctypes.c_float),
        ("max_outer", ctypes.c_int), ("tf_range", ctypes.c_void_p),
    ]


def build_march():
    """Compile csrc/march.cu for sm_90a (utils/cuda_build.py) and bind its
    two C entry points; returns the ctypes library."""
    lib = cuda_build.build("march")
    for f, params in ((lib.march_f32_launch, _TrackParams),
                      (lib.march_q_launch, _TrackQParams)):
        f.argtypes = [ctypes.POINTER(params), ctypes.POINTER(_MarchArgs),
                      ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.march_occupancy.argtypes = [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)]
    lib.march_occupancy.restype = ctypes.c_int
    return lib


def march_occupancy(tier: str) -> dict:
    """{'blocks_per_sm', 'registers', 'local_bytes'} of K3's kernel of
    `tier` ("f32" or "q"): its resident 128-thread blocks an SM, registers
    and local (stack and spill) bytes a thread."""
    out = (ctypes.c_int * 3)()
    cuda_build.check("march_occupancy", build_march().march_occupancy(
        ("f32", "q").index(tier), out))
    return {"blocks_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2]}


def march_q_scales(q: QuantizedCells):
    """(a_scale, v_scale, inv_span) of the q tier from host copies of its
    scalars (`host_values`), in f32 as `_QTier` computes them: alpha_max /
    255, (hi - lo) / 255 and 255 / max(hi - lo, 1e-30)."""
    f = np.float32
    lo, hi, amax = (f(host_values(x)) for x in (q.value_lo, q.value_hi,
                                                q.alpha_max))
    span = f(hi - lo)
    return (float(f(amax / f(255.0))), float(f(span / f(255.0))),
            float(f(f(255.0) / max(span, f(1e-30)))))


def march_args(q: QuantizedCells | None, tf: Transfunc | None,
               tab) -> _MarchArgs:
    """K3's own launch arguments: on the q tier (q, tf and the (256, 4)
    code-table buffer `tab` given) its scales from host copies
    (`march_q_scales`) and the TF's value range as a device address, which
    the code-table kernel reads on the card; on the f32 tier (all None)
    zeros."""
    if q is None:
        return _MarchArgs(et_eps=ET_EPS, max_outer=MAX_OUTER)
    a_scale, v_scale, inv_span = march_q_scales(q)
    return _MarchArgs(tab=tab.data_ptr(), a_scale=a_scale, v_scale=v_scale,
                      inv_span=inv_span, et_eps=ET_EPS, max_outer=MAX_OUTER,
                      tf_range=tf.value_range.data_ptr())


def _check_lanes(fn, bands: RadialBands, pix, accum, fb, cost, n_pixels):
    dev = pix.device
    nb = bands.max_opacities.shape[0]
    L = pix.shape[0]
    for name, x, dt, shape in (
            ("bands.edges", bands.edges, F32, (nb + 1,)),
            ("bands.max_opacities", bands.max_opacities, F32, (nb,)),
            ("pix", pix, torch.int32, (L,)), ("accum", accum, F32, (L, 4)),
            ("fb", fb, torch.int32, (L,))):
        _check(name, x, dt, shape, dev, fn=fn)
    if cost is not None:
        _check("cost", cost, torch.int32, (n_pixels,), dev, fn=fn)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")


def march_f32(packed: PackedCells, loc: Locator, bands: RadialBands, lp,
              pix, accum, fb, *, width: int, height: int, cost=None):
    """K3 wrapper, f32 tier: one converged pass of sample lp.accum_id for
    the lanes of `pix` ((L,) int32 pixel ids), averaged into accum (L, 4)
    f32 and packed into fb (L,) int32 IN PLACE; with `cost` ((W*H,) int32,
    natural pixel order) also each lane's march iterations at its pixel
    (the counterpart of icon_rt_tpu/ops/march.py `march_rays(...,
    return_cost=True)`, per lane where JAX returns the batch maximum).
    CUDA tensors launch csrc/march.cu; CPU tensors run
    `_march_frame_torch`; anything else raises.  A launch reads nothing
    back from the card: the kernel reads lp's scalars from their tensors
    (ops/fast.py `track_frame`), and the tables' scalars come from
    `host_values`."""
    dev = pix.device
    n = packed.test.shape[0]
    for name, x, w in (("packed.test", packed.test, TEST_W),
                       ("packed.prof", packed.prof, PROF_W),
                       ("packed.rgb", packed.rgb, RGB_W)):
        _check(name, x, F32, (n, w), dev, fn="march_f32")
    check_rows("march_f32", "packed.test", packed.test, 16)
    _check("loc.bins", loc.bins, torch.int32, (None, None), dev,
           fn="march_f32")
    _check_lanes("march_f32", bands, pix, accum, fb, cost, width * height)
    if dev.type == "cpu":
        _march_frame_torch(_F32Tier(packed, loc), bands, lp, pix, accum, fb,
                           width, height, cost)
        return
    lp = frame_on(lp, dev)
    p = track_params(packed, loc, track_common(
        bands, lp, pix, accum, fb, width=width, height=height, samples=1,
        preserve_cache=False, cost=cost, fn="march_f32"))
    m = march_args(None, None, None)
    cuda_build.check("march_f32", build_march().march_f32_launch(
        ctypes.byref(p), ctypes.byref(m),
        torch.cuda.current_stream(dev).cuda_stream))
    launches["march_f32" if cost is None else "march_f32_cost"] += 1


def march_q(q: QuantizedCells, loc: Locator, bands: RadialBands,
            tf: Transfunc, lp, pix, accum, fb, *, width: int, height: int,
            finemap: FineMap | None = None, cost=None):
    """K3 wrapper, quantized tier: as `march_f32` (`cost` too; JAX's
    `march_rays_q(..., return_cost=True)`), on the u8/u16 tables; with
    `finemap` a locate tries the fine map first.  The layer colours go
    through the (256, 4) code table of the live TF, which a one-block
    kernel writes into a buffer of this call ahead of the march, on the
    same stream (the plain version: `_QTier`'s `code_table`).  A launch
    reads nothing back from the card, as `march_f32`'s: the TF's range is
    read by the kernel too (`march_args`)."""
    dev = pix.device
    check_q_tables("march_q", q, loc, tf, finemap, dev)
    _check_lanes("march_q", bands, pix, accum, fb, cost, width * height)
    if dev.type == "cpu":
        _march_frame_torch(_QTier(q, loc, tf, finemap), bands, lp, pix,
                           accum, fb, width, height, cost)
        return
    if q.lm > 32:
        raise ValueError("march_q: the kernel takes at most 32 layers a "
                         "column (q.lm <= 32)")
    lp = frame_on(lp, dev)
    p = track_q_params(q, loc, tf, finemap, track_common(
        bands, lp, pix, accum, fb, width=width, height=height, samples=1,
        preserve_cache=False, cost=cost, fn="march_q"))
    tab = torch.empty((256, 4), dtype=F32, device=dev)
    m = march_args(q, tf, tab)
    cuda_build.check("march_q", build_march().march_q_launch(
        ctypes.byref(p), ctypes.byref(m),
        torch.cuda.current_stream(dev).cuda_stream))
    launches["march_q" if cost is None else "march_q_cost"] += 1


# ===========================================================================
# Frame drivers
# ===========================================================================

def render_frame_march(cells: Cells, packed: PackedCells, loc: Locator,
                       bands: RadialBands, lp, accum, fb, *, width: int,
                       height: int, pixel_perm=None,
                       n_active: int | None = None):
    """Full-frame deterministic march on the f32 tier — the peer of
    ops/fast.render_frame_fast (same pixel_perm / n_active contract).  Each
    call adds ONE converged pass of the jitter of lp.accum_id.  accum (P, 4)
    f32 and fb (P,) int32 are updated IN PLACE and returned."""
    pix, n = frame_lanes(width, height, pixel_perm, n_active, accum.device)
    march_f32(packed, loc, bands, lp, pix, accum[:n], fb[:n], width=width,
              height=height)
    return accum, fb


def render_frame_march_q(q: QuantizedCells, loc: Locator,
                         bands: RadialBands, tf: Transfunc, lp, accum, fb, *,
                         width: int, height: int, pixel_perm=None,
                         n_active: int | None = None,
                         finemap: FineMap | None = None):
    """Full-frame deterministic march on the quantized tier — the peer of
    ops/fastq.render_frame_fast_q; `finemap` turns the two-stage locate
    on.  accum and fb are updated IN PLACE and returned."""
    pix, n = frame_lanes(width, height, pixel_perm, n_active, accum.device)
    march_q(q, loc, bands, tf, lp, pix, accum[:n], fb[:n], width=width,
            height=height, finemap=finemap)
    return accum, fb
