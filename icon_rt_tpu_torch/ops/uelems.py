"""Unstructured-element point containment and interpolation by Newton
iteration on parametric coordinates, batched over lanes.

Port of the reference's OpenVKL-derived intersectors (ref: icon_rt/
UElems.h): pyramid (5 vertices, :78-172), wedge/prism (6, :215-311 -- the
one ICON columns use), hexahedron (8, :374-471), as the JAX package's
icon_rt_tpu/ops/uelems.py: one masked Newton loop over shape-function
tables; 10 iterations at most, convergence 1e-4, divergence 1e6, outside
tolerance 1e-6, determinant tolerance |bbox.size()|^2 * 1e-6.

Faithful quirk: the interpolation weights are those of the LAST EXECUTED
iteration (from its pre-update pcoords) while the inside test uses the
post-update pcoords.

Every sum runs in vertex order as explicit adds and every 3x3
determinant is one fixed expression (`_det3`), so the CUDA device
functions of csrc/uelems.cuh repeat this arithmetic operation for
operation: the kernels that call them (K9-n here, K9-p in csrc/parity.cu)
equal these plain versions bit for bit.

Kernel of this module: K9-n `uelems_points` (CUDA C++, csrc/uelems.cu),
the three intersectors on a batch of points, one thread per point.  No
render path calls it; it holds csrc/uelems.cuh against the plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import cuda_build

F32 = torch.float32
MAX_ITERATION = 10
#: the tolerances as the f32 values both the plain version and the kernel
#: compare against
CONVERGED = float(np.float32(1e-4))
DIVERGED = float(np.float32(1e6))
TINY = float(np.float32(1e-30))
BOX_LO = float(np.float32(0.0 - 1e-6))
BOX_HI = float(np.float32(1.0 + 1e-6))
TOL_SCALE = float(np.float32(1e-6))

#: K9-n kernel launches (the wrapper counts only CUDA launches)
launches = {"uelems_points": 0}


def _wedge_tables(r, s, t, zero):
    """Shape weights and their r, s, t derivatives of the wedge, each a
    list of 6 tensors (v0..v2 the bottom face t = 0, v3..v5 the top)."""
    rs = 1 - r - s
    tm = 1 - t
    w = [rs * tm, r * tm, s * tm, rs * t, r * t, s * t]
    dr = [-1 + t, tm, zero, -t, t, zero]
    ds = [-1 + t, zero, tm, -t, zero, t]
    dt = [-1 + r + s, -r, -s, rs, r, s]
    return w, dr, ds, dt


def _pyramid_tables(r, s, t, zero):
    rm, sm, tm = 1 - r, 1 - s, 1 - t
    w = [rm * sm * tm, r * sm * tm, r * s * tm, rm * s * tm, t]
    dr = [-(s - 1) * (t - 1), (s - 1) * (t - 1), s - s * t, s * (t - 1),
          zero]
    ds = [-(r - 1) * (t - 1), r * (t - 1), r - r * t, (r - 1) * (t - 1),
          zero]
    dt = [-(r - 1) * (s - 1), r * (s - 1), -r * s, (r - 1) * s, zero + 1]
    return w, dr, ds, dt


def _hex_tables(r, s, t, zero):
    rm, sm, tm = 1 - r, 1 - s, 1 - t
    w = [rm * sm * tm, r * sm * tm, r * s * tm, rm * s * tm,
         rm * sm * t, r * sm * t, r * s * t, rm * s * t]
    dr = [-sm * tm, sm * tm, s * tm, -s * tm, -sm * t, sm * t, s * t, -s * t]
    ds = [-rm * tm, -r * tm, r * tm, rm * tm, -rm * t, -r * t, r * t, rm * t]
    dt = [-rm * sm, -r * sm, -r * s, -rm * s, rm * sm, r * sm, r * s, rm * s]
    return w, dr, ds, dt


_TABLES = {5: _pyramid_tables, 6: _wedge_tables, 8: _hex_tables}
#: the vertices whose weight in the r and s derivative columns is the
#: constant 0, and whose t derivative is the constant 1, by vertex count:
#: the column sums leave the first out and take V itself for the second.
#: x + 0 * v is x and 1 * v is v for every x other than a zero (whose sign
#: the left-out term could flip), so the sums keep their values
#: (csrc/uelems.cuh `vsum`, Shape's kZeroR, kZeroS, kOneT)
_ZERO = {5: ((4,), (4,)), 6: ((2, 5), (1, 4)), 8: ((), ())}
_ONE = {5: (4,), 6: (), 8: ()}


def _det3(a, b, c):
    """Determinants of the 3x3 matrices with columns a, b, c ((..., 3)
    each): a . (b x c), summed x, y, z in order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    c0, c1, c2 = c.unbind(-1)
    return (a0 * (b1 * c2 - b2 * c1) + a1 * (b2 * c0 - b0 * c2)
            + a2 * (b0 * c1 - b1 * c0))


def _vsum(V, w, zero=(), one=()):
    """sum_k w[k] V[:, k] in vertex order ((M, 3)), without the vertices
    in `zero` and with V itself for those in `one`."""
    acc = None
    for k in range(V.shape[1]):
        if k in zero:
            continue
        term = V[:, k] if k in one else w[k][:, None] * V[:, k]
        acc = term if acc is None else acc + term
    return acc


def newton(P, V, S, return_iters: bool = False):
    """Masked Newton inversion of M points in M elements: P (M, 3), V (M,
    nv, 3), S (M, nv) f32 (nv 5 pyramid, 6 wedge, 8 hex).  Returns (inside
    (M,) bool, value (M,) f32, 0 outside), with return_iters also the
    iterations each point ran (M,) int32.  All 10 iterations run masked
    (no host sync), so a CUDA graph can capture the call.

    As csrc/uelems.cuh: the loop carries the pcoords from before the last
    accepted update, and the weights of that iteration are evaluated from
    them once after it (the same expressions on the same inputs, so the
    same bits); a point outside its element has value 0 whatever the
    element's scalars (the kernels read them only for a point inside)."""
    nv = V.shape[1]
    tables = _TABLES[nv]
    M = P.shape[0]
    bbox = V.amax(dim=1) - V.amin(dim=1)
    tol = (bbox[:, 0] * bbox[:, 0] + bbox[:, 1] * bbox[:, 1]
           + bbox[:, 2] * bbox[:, 2]) * TOL_SCALE
    zero = torch.zeros(M, dtype=F32, device=P.device)
    pc = torch.full((M, 3), 0.5, dtype=F32, device=P.device)
    last = pc
    converged = torch.zeros(M, dtype=torch.bool, device=P.device)
    failed = torch.zeros_like(converged)
    iters = torch.zeros(M, dtype=torch.int32, device=P.device)
    for _ in range(MAX_ITERATION):
        active = ~(converged | failed)
        iters += active.to(torch.int32)
        w, dr, ds, dt = tables(pc[:, 0], pc[:, 1], pc[:, 2], zero)
        fcol = _vsum(V, w) - P
        rcol = _vsum(V, dr, zero=_ZERO[nv][0])
        scol = _vsum(V, ds, zero=_ZERO[nv][1])
        tcol = _vsum(V, dt, one=_ONE[nv])
        # d, then the three Cramer numerators, as one (M, 4) determinant
        dets = _det3(torch.stack([rcol, fcol, rcol, rcol], 1),
                     torch.stack([scol, scol, fcol, scol], 1),
                     torch.stack([tcol, tcol, tcol, fcol], 1))
        d = dets[:, 0]
        fail_now = active & (torch.abs(d) < tol)
        ok = active & ~fail_now
        d_safe = torch.where(torch.abs(d) < TINY, 1.0, d)
        step = dets[:, 1:] / d_safe[:, None]
        pc_new = pc - step
        conv_now = ok & (torch.abs(step) < CONVERGED).all(dim=1)
        div_now = ok & ~conv_now & (torch.abs(pc_new) > DIVERGED).any(dim=1)
        last = torch.where(ok[:, None], pc, last)
        pc = torch.where(ok[:, None], pc_new, pc)
        converged = converged | conv_now
        failed = failed | fail_now | div_now
    in_box = ((pc >= BOX_LO) & (pc <= BOX_HI)).all(dim=1)
    inside = converged & ~failed & in_box
    if nv == 6:
        inside = inside & (pc[:, 0] + pc[:, 1] <= BOX_HI)
    w_last = tables(last[:, 0], last[:, 1], last[:, 2], zero)[0]
    value = w_last[0] * S[:, 0]
    for k in range(1, nv):
        value = value + w_last[k] * S[:, k]
    value = torch.where(inside, value, 0.0)
    return (inside, value, iters) if return_iters else (inside, value)


def _intersect(P, V, S, nv, name):
    """`newton` on elements that must have nv vertices."""
    if V.dim() != 3 or V.shape[1] != nv or S.shape[-1] != nv:
        raise ValueError(f"{name}: V must be (M, {nv}, 3) and S (M, {nv})")
    return newton(P, V, S)


def intersect_wedge(P, V, S):
    """Point-in-wedge and interpolated scalar (ref: UElems.h:215-311),
    batched: P (M, 3), V (M, 6, 3), S (M, 6) -> (inside, value)."""
    return _intersect(P, V, S, 6, "intersect_wedge")


def intersect_pyramid(P, V, S):
    """ref: UElems.h:78-172, batched: V (M, 5, 3), S (M, 5)."""
    return _intersect(P, V, S, 5, "intersect_pyramid")


def intersect_hex(P, V, S):
    """ref: UElems.h:374-471, batched: V (M, 8, 3), S (M, 8)."""
    return _intersect(P, V, S, 8, "intersect_hex")


# ===========================================================================
# K9-n kernel: build, bind, launch
# ===========================================================================

def build_uelems():
    """Compile csrc/uelems.cu for sm_90a (utils/cuda_build.py) and bind its
    C entry points; returns the ctypes library."""
    lib = cuda_build.build("uelems")
    lib.uelems_points_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.uelems_points_launch.restype = ctypes.c_int
    lib.uelems_occupancy.argtypes = [ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.uelems_occupancy.restype = ctypes.c_int
    return lib


def uelems_occupancy(nv: int) -> dict:
    """{'blocks_per_sm', 'registers', 'local_bytes', 'block'} of K9-n's
    kernel of nv vertices: its resident blocks an SM, registers and local
    bytes a thread, and its threads a block."""
    out = (ctypes.c_int * 4)()
    cuda_build.check("uelems_occupancy",
                     build_uelems().uelems_occupancy(nv, out))
    return {"blocks_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2], "block": out[3]}


def uelems_points(P, V, S, out=None):
    """K9-n wrapper: the intersector of V's vertex count (5 pyramid, 6
    wedge, 8 hex) on M points, one element each: P (M, 3), V (M, nv, 3),
    S (M, nv) f32 -> (inside (M,) bool, value (M,) f32), written into
    `out` = (inside, value) where given, so that repeated calls allocate
    nothing.  CUDA tensors launch csrc/uelems.cu (one launch, nothing
    else); CPU tensors run `newton`; anything else raises.

    Replaces the XLA-fused icon_rt_tpu/ops/uelems.py `intersect_wedge`
    :126, `intersect_pyramid` :133 and `intersect_hex` :138.  Kernel
    design: one thread per point, the element's vertices in registers,
    the Newton of csrc/uelems.cuh leaving at convergence or failure (the
    plain version's masked iterations change nothing after that), the
    scalars read only for a point inside, the flag written as a bool.
    Bound on the card by the issue of the unfused Newton
    (csrc/uelems.cu)."""
    from .fast import _check
    dev = P.device
    M = P.shape[0]
    nv = V.shape[1] if V.dim() == 3 else -1
    if nv not in _TABLES:
        raise ValueError("uelems_points: V must be (M, 5|6|8, 3)")
    _check("P", P, F32, (M, 3), dev, fn="uelems_points")
    _check("V", V, F32, (M, nv, 3), dev, fn="uelems_points")
    _check("S", S, F32, (M, nv), dev, fn="uelems_points")
    if out is not None:
        inside, value = out
        _check("out inside", inside, torch.bool, (M,), dev,
               fn="uelems_points")
        _check("out value", value, F32, (M,), dev, fn="uelems_points")
    if dev.type == "cpu":
        got = newton(P, V, S)
        if out is None:
            return got
        inside.copy_(got[0])
        value.copy_(got[1])
        return inside, value
    if dev.type != "cuda":
        raise ValueError(f"uelems_points: unsupported device {dev}")
    if out is None:
        inside = torch.empty(M, dtype=torch.bool, device=dev)
        value = torch.empty(M, dtype=F32, device=dev)
    if M:
        lib = build_uelems()
        cuda_build.check("uelems_points", lib.uelems_points_launch(
            P.data_ptr(), V.data_ptr(), S.data_ptr(), inside.data_ptr(),
            value.data_ptr(), M, nv,
            torch.cuda.current_stream(dev).cuda_stream))
        launches["uelems_points"] += 1
    return inside, value
