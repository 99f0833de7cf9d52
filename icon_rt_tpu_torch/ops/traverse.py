"""Majorant traversals fused with Woodcock tracking, batched over lanes: the
plain versions of the accel raygen's loops inside kernel K8
(csrc/parity.cu).

The reference drives Woodcock tracking through per-cell majorants with two
traversals -- a Cartesian 3-DDA (ref: icon_rt/DDA.h:37-136) and a
spherical-shell DDA (ref: icon_rt/ShellAccel.h:82-229) -- with device-side
callbacks.  Here each traversal and its tracking is one state machine per
lane: every iteration performs at most one Woodcock step and, when the
current cell segment is over, one DDA advance.  The lanes run in lock step
(ops/woodcock.py `lockstep`).

RNG parity: zero-majorant cells draw nothing (the reference breaks before
drawing, deviceCode.cu:161-162); every tentative collision draws once;
the acceptance draw happens only when the point lies inside a cell.

Faithful reference quirk (do NOT "fix"): sdda builds its lat/lon boundary
planes with radius 0 (ref: ShellAccel.h:150-155, 186-199), which yields
all-zero planes whose evaluation is identically 0.  The traversal
therefore gives the whole shell segment the ENTRY cell's majorant and then
steps lat and lon together through zero-length visits, one draw each where
the cell's majorant is positive.  The Cartesian grid mode skips for real.

Every `tnext + dist` and comparison is written out as the reference's, so
the axes that step together on an f32 tie are the same in the kernel
(built with -fmad=false) and here.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.lcg import lcg_next
from ..utils.vecmath import sqrt_rn
from .woodcock import MAX_ITERS, lockstep

FLT_MAX = float(np.finfo(np.float32).max)


class TraceResult(NamedTuple):
    color: torch.Tensor   # (L, 3) f32 albedo (pre-ambient)
    alpha: torch.Tensor   # (L,) f32
    rng: torch.Tensor     # (L,) i64 holding the u32 LCG state
    steps: torch.Tensor   # (L,) i32 loop iterations of the lane


def _woodcock_step(rng, wt, seg0, seg1, majorant, unit_distance,
                   sample_fn, classify_fn, org, direction, work=None,
                   live=None):
    """One tentative collision per lane (ref: deviceCode.cu:160-183) plus
    the collision-window check of woodcockFunc (ref: deviceCode.cu:304-323).
    Returns (rng, wt, seg_over, collided, rgba (L, 4)).  `work`, if given,
    counts the draws and samples of the `live` lanes."""
    active = majorant > 0.0
    rng1, xi = lcg_next(rng)
    wt_new = wt - torch.log(1.0 - xi) / (majorant / unit_distance)
    rng = torch.where(active, rng1, rng)
    wt = torch.where(active, wt_new, wt)
    beyond = wt > seg1
    pos = org + direction * wt[:, None]
    hit, value = sample_fn(pos)
    if work is not None:
        work.add("draw", live & active)
        work.sample(pos, live & active & ~beyond)
    rgba = classify_fn(value)
    rng2, u = lcg_next(rng)
    sampled = active & ~beyond & hit
    accept = sampled & (rgba[:, 3] >= u * majorant)
    rng = torch.where(sampled, rng2, rng)
    # woodcockFunc records the hit only for t strictly inside (t0, t1)
    collided = accept & (wt > seg0) & (wt < seg1)
    seg_over = ~active | beyond | accept
    return rng, wt, seg_over, collided, rgba


def _linear_index(cell, dims):
    """z-major linearization (ref: DDA.h:16-21); cell (L, 3), dims (3,)."""
    return (cell[:, 2].long() * int(dims[0]) * int(dims[1])
            + cell[:, 1].long() * int(dims[0]) + cell[:, 0].long())


def _trace(state, ids, step, L, dev, rng, max_iters) -> TraceResult:
    """The lock-step loop of both traversals over the live lanes `ids`
    (ops/woodcock.py `lockstep`), from the per-row `state`."""
    out = dict(color=torch.zeros(L, 3, dtype=torch.float32, device=dev),
               alpha=torch.zeros(L, dtype=torch.float32, device=dev),
               rng=rng.clone(),
               steps=torch.zeros(L, dtype=torch.int32, device=dev))
    n = ids.shape[0]
    state.update(rng=rng[ids], color=torch.zeros(n, 3, device=dev),
                 alpha=torch.zeros(n, device=dev),
                 steps=torch.zeros(n, dtype=torch.int32, device=dev))
    lockstep(state, ids, step, out, max_iters)
    return TraceResult(out["color"], out["alpha"], out["rng"], out["steps"])


def _collide(S, collided, rgba):
    """The colour and binary alpha of a collision."""
    return dict(color=torch.where(collided[:, None], rgba[:, :3],
                                  S["color"]),
                alpha=torch.where(collided,
                                  torch.where(rgba[:, 3] > 0.0, 1.0, 0.0),
                                  S["alpha"]))


# ===========================================================================
# Cartesian grid (dda3, ref: DDA.h:37-136)
# ===========================================================================

def trace_dda3(sample_fn: Callable, classify_fn: Callable,
               max_opacities, dims, box_lo, box_hi,
               org, direction, tmin, tmax, rng, unit_distance,
               active=None, max_iters: int = MAX_ITERS,
               work=None) -> TraceResult:
    """Woodcock tracking through a Cartesian majorant grid, L lanes.

    org (3,) or (L, 3), direction (L, 3), tmin/tmax (L,) (the box
    segment), rng (L,) i64, dims (3,) i32, box_lo/box_hi (3,) f32, all on
    one device; lanes with active False (missed rays) skip the loop.
    `work`, an ops/woodcock.py `Work`, if given, counts the run's
    events."""
    L, dev = direction.shape[0], direction.device
    org = org.expand(L, 3)
    dims_t = dims.to(torch.int32)
    dims_l = [int(d) for d in dims.tolist()]
    dimsf = dims_t.to(torch.float32)
    ray_tmin = tmin
    org_s = org + ray_tmin[:, None] * direction       # shifted so tmin = 0
    tmax_s = tmax - ray_tmin
    rcp = 1.0 / direction
    lo = (box_lo - org_s) * rcp
    hi = (box_hi - org_s) * rcp
    tnear = torch.minimum(lo, hi)
    tfar = torch.maximum(lo, hi)
    # projectOnGrid (ref: DDA.h:24-31): clamped trunc-toward-zero
    v01 = (org_s - box_lo) / (box_hi - box_lo)
    cell0 = torch.clamp((v01 * dimsf).to(torch.int32),
                        torch.zeros_like(dims_t), dims_t - 1)
    dist = torch.clamp((tfar - tnear) / dimsf, min=0.0)
    pos_dir = direction > 0.0
    step = torch.where(pos_dir, 1, -1).to(torch.int32)
    stop = torch.where(pos_dir, dims_t, -1).to(torch.int32)
    tnext0 = torch.where(pos_dir,
                         tnear + (cell0 + 1).to(torch.float32) * dist,
                         tnear + (dims_t - cell0).to(torch.float32) * dist)

    def visit(cell, tnext, t0, rt, tm):
        """A cell visit's segment and majorant (loop head of DDA.h:98-100);
        cells outside the grid read a clamped bin nothing uses."""
        t1 = torch.minimum(tnext.amin(dim=1), tm)
        cl = torch.minimum(torch.clamp(cell, min=0), dims_t - 1)
        return t1, rt + t0, rt + t1, max_opacities[_linear_index(cl, dims_l)]

    ids = torch.arange(L, device=dev)
    if active is not None:
        ids = ids[active]
    t0 = torch.zeros(ids.shape[0], dtype=torch.float32, device=dev)
    rt, tm = ray_tmin[ids], tmax_s[ids]
    t1, seg0, seg1, m = visit(cell0[ids], tnext0[ids], t0, rt, tm)
    state = dict(org=org[ids], d=direction[ids], cell=cell0[ids],
                 tnext=tnext0[ids], dist=dist[ids], step=step[ids],
                 stop=stop[ids], rt=rt, tm=tm, t0=t0, t1=t1, seg0=seg0,
                 seg1=seg1, m=m, wt=seg0)

    def body(S, live):
        rng, wt, seg_over, collided, rgba = _woodcock_step(
            S["rng"], S["wt"], S["seg0"], S["seg1"], S["m"], unit_distance,
            sample_fn, classify_fn, S["org"], S["d"], work, live)
        # DDA advance (ref: DDA.h:110-133), sequential axis updates
        adv = seg_over & ~collided
        if work is not None:
            work.add("advance", live & adv)
        t_closest = S["tnext"].amin(dim=1)
        tnext, cell = S["tnext"].clone(), S["cell"].clone()
        out = torch.zeros_like(adv)
        for k in range(3):
            mk = adv & ~out & (tnext[:, k] == t_closest)
            tnext[:, k] = torch.where(mk, tnext[:, k] + S["dist"][:, k],
                                      tnext[:, k])
            cell[:, k] = torch.where(mk, cell[:, k] + S["step"][:, k],
                                     cell[:, k])
            out = out | (mk & (cell[:, k] == S["stop"][:, k]))
        goes_on = adv & ~out
        t1, seg0, seg1, m = visit(cell, tnext, S["t1"], S["rt"], S["tm"])
        new = dict(_collide(S, collided, rgba), rng=rng, cell=cell,
                   tnext=tnext, t0=torch.where(goes_on, S["t1"], S["t0"]),
                   t1=torch.where(goes_on, t1, S["t1"]),
                   seg0=torch.where(goes_on, seg0, S["seg0"]),
                   seg1=torch.where(goes_on, seg1, S["seg1"]),
                   m=torch.where(goes_on, m, S["m"]),
                   wt=torch.where(goes_on, seg0, wt))
        return new, collided | (adv & out)

    return _trace(state, ids, body, L, dev, rng, max_iters)


# ===========================================================================
# Spherical shell (sdda, ref: ShellAccel.h:82-229)
# ===========================================================================

def _intersect_sphere(org, direction, radius):
    """Origin-centered sphere (ref: ShellAccel.h:34-53): (hit, t_near,
    t_far) per lane; org (L, 3), direction (L, 3)."""
    d, o = direction, org
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    b = (d[:, 0] * o[:, 0] + d[:, 1] * o[:, 1] + d[:, 2] * o[:, 2]) * 2.0
    c = (o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1] + o[:, 2] * o[:, 2]) \
        - radius * radius
    disc = b * b - 4.0 * a * c
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - sq), -0.5 * (b + sq))
    t1 = q / a
    t2 = c / q
    return disc >= 0.0, torch.minimum(t1, t2), torch.maximum(t1, t2)


def _project_spherical(sph, dims, slo, shi):
    """Unclamped, (dims-1)-scaled projection truncated toward zero (ref:
    ShellAccel.h:57-68); sph (L, 3), dims (3,) i32."""
    scaled = (sph - slo) / (shi - slo) * (dims - 1).to(torch.float32)
    return scaled.to(torch.int32)


def _to_spherical(p):
    """(L, 3) Cartesian -> (r, asin(z / r), atan2(y, x))."""
    r = sqrt_rn(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2])
    return torch.stack([r, torch.asin(p[:, 2] / r),
                        torch.atan2(p[:, 1], p[:, 0])], dim=1)


def trace_sdda(sample_fn: Callable, classify_fn: Callable,
               max_opacities, dims, sph_lo, sph_hi,
               org, direction, tmin, tmax, rng, unit_distance,
               active=None, max_iters: int = MAX_ITERS,
               work=None) -> TraceResult:
    """Woodcock tracking through the spherical-shell grid, L lanes --
    faithful to the reference sdda including its degenerate lat/lon planes
    (see the module docstring).  Arguments as `trace_dda3`; sph_lo/sph_hi
    are the (r, lat, lon) bounds.  tmax is unused, as in the reference."""
    L, dev = direction.shape[0], direction.device
    org = org.expand(L, 3)
    dims_t = dims.to(torch.int32)
    dims_l = [int(d) for d in dims.tolist()]
    hit1, ts1, ts4 = _intersect_sphere(org, direction, sph_hi[0])
    hit2, ts2, ts3 = _intersect_sphere(org, direction, sph_lo[0])
    none = (~hit1 & ~hit2) | (ts4 < tmin)
    # segment table (ref: ShellAccel.h:94-111)
    outer_only = hit1 & ~hit2
    front = tmin < ts2
    big = torch.full_like(ts1, FLT_MAX)
    ranges = (  # (rlo, rhi) of segments 0 and 1
        (torch.where(outer_only | front, ts1, ts3),
         torch.where(outer_only, ts4, torch.where(front, ts2, ts4))),
        (torch.where(outer_only, big, torch.where(front, ts3, big)),
         torch.where(outer_only, -big, torch.where(front, ts4, -big))))
    eps = sph_lo[0] * 1e-6

    def range_setup(si):
        """Enter segment si of every lane (ref: ShellAccel.h:113-162):
        (invalid, cell, step, stop, tnext, t)."""
        rlo, rhi = ranges[si]
        sp1 = _to_spherical(org + direction * (rlo + eps)[:, None])
        sp2 = _to_spherical(org + direction * (rhi - eps)[:, None])
        cell = _project_spherical(sp1, dims_t, sph_lo, sph_hi)
        step = torch.where(sp1 < sp2, 1, -1).to(torch.int32)
        stop = _project_spherical(sp2, dims_t, sph_lo, sph_hi) + step
        # lat/lon planes are degenerate (r = 0, a zero plane): eval == 0
        zero = torch.zeros_like(rhi)
        return (rhi <= rlo, cell, step, stop,
                torch.stack([rhi, zero, zero], dim=1), rlo)

    def visit(cell, tnext, t):
        """Loop-head visit (ref: ShellAccel.h:163-172): t1 = the smallest
        tnext >= t (FLT_MAX if none); the bin of the wrapped cell."""
        t1 = torch.where(tnext >= t[:, None], tnext, FLT_MAX).amin(dim=1)
        wrapped = torch.remainder(cell, dims_t)    # floored, as jnp.mod
        return t1, max_opacities[_linear_index(wrapped, dims_l)]

    inv0, cell, step, stop, tnext, t = range_setup(0)
    # the second range, entered when the first is left (set up once)
    inv1, cell1, step1, stop1, tnext1, t_1 = range_setup(1)
    live = ~(none | inv0)
    if active is not None:
        live = live & active
    ids = torch.nonzero(live).squeeze(1)
    t1, m = visit(cell[ids], tnext[ids], t[ids])
    state = dict(org=org[ids], d=direction[ids],
                 si=torch.zeros(ids.shape[0], dtype=torch.int32, device=dev),
                 cell=cell[ids], step=step[ids], stop=stop[ids],
                 tnext=tnext[ids], t=t[ids], t1=t1, m=m, wt=t[ids],
                 inv1=inv1[ids], cell1=cell1[ids], step1=step1[ids],
                 stop1=stop1[ids], tnext1=tnext1[ids], t_1=t_1[ids])

    def body(S, live):
        rng, wt, seg_over, collided, rgba = _woodcock_step(
            S["rng"], S["wt"], S["t"], S["t1"], S["m"], unit_distance,
            sample_fn, classify_fn, S["org"], S["d"], work, live)
        # advance (ref: ShellAccel.h:174-201), sequential, break on stop
        adv = seg_over & ~collided
        if work is not None:
            work.add("advance", live & adv)
        t_closest = S["tnext"].amin(dim=1)
        tnext, cell = S["tnext"].clone(), S["cell"].clone()
        # radial axis: no tnext update on advance (stays at range end)
        m0 = adv & (tnext[:, 0] == t_closest)
        cell[:, 0] = torch.where(m0, cell[:, 0] + S["step"][:, 0],
                                 cell[:, 0])
        out = m0 & (cell[:, 0] == S["stop"][:, 0])
        for k in (1, 2):
            mk = adv & ~out & (tnext[:, k] == t_closest)
            cell[:, k] = torch.where(mk, cell[:, k] + S["step"][:, k],
                                     cell[:, k])
            outk = mk & (cell[:, k] == S["stop"][:, k])
            # degenerate plane re-evaluated -> 0 (only when not stopping)
            tnext[:, k] = torch.where(mk & ~outk, 0.0, tnext[:, k])
            out = out | outk
        # stepping out of a range: the next range, or finished
        switch = adv & out
        si = S["si"] + switch.to(torch.int32)
        finished = switch & ((si > 1) | S["inv1"])
        nr = switch & ~finished
        r2 = nr[:, None]
        cell = torch.where(r2, S["cell1"], cell)
        tnext = torch.where(r2, S["tnext1"], tnext)
        t_new = torch.where(nr, S["t_1"],
                            torch.where(adv & ~out, t_closest, S["t"]))
        t1, m = visit(cell, tnext, t_new)
        goes_on = adv & ~finished
        new = dict(_collide(S, collided, rgba), rng=rng, si=si, cell=cell,
                   step=torch.where(r2, S["step1"], S["step"]),
                   stop=torch.where(r2, S["stop1"], S["stop"]),
                   tnext=tnext, t=torch.where(goes_on, t_new, S["t"]),
                   t1=torch.where(goes_on, t1, S["t1"]),
                   m=torch.where(goes_on, m, S["m"]),
                   wt=torch.where(goes_on, t_new, wt))
        return new, collided | finished

    return _trace(state, ids, body, L, dev, rng, max_iters)
