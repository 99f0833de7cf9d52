"""Ray ordering: sort pixels by expected tracking length (kernel K6).

Sorting pixels by the analytic chord length of the central ray through the
outer shell groups similar-cost rays into neighbouring lanes (on the GPU:
into the same warps, so a warp's lanes finish together), and puts the
pixels whose rays miss the volume at the back, so the covered prefix can be
rendered alone.  The permutation depends only on the camera and the shell
radii, so it is computed once per camera move; accumulation and
framebuffer live in permuted order and are unpermuted at present time.

K6 `chord_keys` (CUDA C++, csrc/order.cu) replaces the XLA-fused
icon_rt_tpu/ops/order.py `_chord_keys` and the count of finite keys of its
`pixel_order`: one elementwise pass over W*H pixels, about 60 operations
and up to four square roots per pixel, one f32 store, and the covered
count in the same pass (one atomicAdd a block).  Its bound is the
4-byte-per-pixel store (8.3 MB at 1080p), but the IEEE roots make it
issue-bound, so a pixel takes only the roots its key uses; it reads the
camera's four (3,) vectors on the card, once a block, and nothing per
pixel.  The sort that follows is `torch.sort(stable=True)`; `pixel_order`'s
one host read is the count.

K6b, the measured-cost re-sort (icon_rt_tpu/ops/order.py
`refine_order_device` :109 and `repermute_device` :124), re-sorts the
covered prefix by the steps each lane took in the last launch
(render_frame_fast's `return_cost`) and carries accum and fb over to the
new order.  Three kernels, all pure gathers with no reuse, so bound by
their bytes: `refine_keys` (CUDA C++, csrc/order.cu) gathers
cost_nat[perm[i]] for the covered prefix; `torch.sort(stable=True)` orders
the keys, as K6; `refine_perm` (CUDA C++, csrc/order.cu) writes the new
permutation, perm[order[i]] on the prefix and perm[i] on the tail, reading
the sort's int64 indices as they come; `repermute` (Triton) moves each
lane's 16-byte accum row and 4-byte fb word in one launch, lane i reading
the old lane inv_old[new_perm[i]] (JAX's scatter into natural order and
gather out of it, in one step).  At 1080p these launches are a few tens
of microseconds, about the launch latency, so a call's host work decides
its time: the CUDA C++ kernels bind their C entry points through ctypes,
and each wrapper checks its inputs once and allocates its outputs.  The
pixel's RNG stream is keyed by the pixel (track_common.cuh `init_lane`)
and the column cache lives within one launch, so a re-sort between
launches leaves the unpermuted image bit-identical.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import cuda_build

#: K6 launches (kernel launches only; CPU plain-version runs do not count)
launches = 0
#: K6b launches, the same rule
refine_launches = {"refine_keys": 0, "refine_perm": 0, "repermute": 0}

tl = None          # triton.language, bound on first launch
_REPERMUTE = None
_BLOCK = 1024
_LIB = None        # csrc/order.cu with its entry points bound, on first use


def _triton():
    """Import Triton on first launch (this module is imported on machines
    without it); binds the module's `tl` for the kernels' annotations."""
    global tl
    import triton
    import triton.language as tl_
    tl = tl_
    return triton


def _camera(lp):
    """The camera of launch params `lp` as chord_keys takes it: (org,
    dir00, du, dv), each a (3,) f32 tensor."""
    return lp.cam_org, lp.cam_dir00, lp.cam_du, lp.cam_dv


def _chord_keys_torch(cam, r_in, r_out, width: int, height: int):
    """Plain-PyTorch K6.  cam: (org, dir00, du, dv), (3,) f32 tensors;
    r_in/r_out: () f32 tensors.  Returns ((W*H,) f32 keys, +inf for misses;
    (1,) int32 count of finite keys)."""
    org, dir00, du, dv = cam
    dev = org.device
    total = width * height
    ids = torch.arange(total, dtype=torch.int32, device=dev)
    ys = torch.div(ids, width, rounding_mode="floor")
    xs = ids - ys * width
    ox, oy, oz = org[0], org[1], org[2]
    oo = ox * ox + oy * oy + oz * oz
    u = xs.to(torch.float32) + 1.0   # central ray (pixel + 0.5 + mean jitter)
    v = ys.to(torch.float32) + 1.0
    dx = dir00[0] + u * du[0] + v * dv[0]
    dy = dir00[1] + u * du[1] + v * dv[1]
    dz = dir00[2] + u * du[2] + v * dv[2]
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    od = ox * dx + oy * dy + oz * dz

    def chord(radius):
        disc = od * od - oo + radius * radius
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        return (disc > 0.0) & (-od + sq > 0.0), 2.0 * sq

    hit_o, c_o = chord(r_out)
    hit_i, c_i = chord(r_in)
    # conservative coverage: a jittered ray lands up to ~1.5 pixels from
    # the center, so classify against the outer radius inflated by a few
    # pixel footprints at the closest-approach distance
    pix = torch.sqrt(du[0] * du[0] + du[1] * du[1] + du[2] * du[2]) \
        + torch.sqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2])
    margin = 4.0 * pix * torch.abs(od)
    rm = r_out + margin
    disc_m = od * od - oo + rm * rm
    covered = (disc_m > 0.0) & (-od + torch.sqrt(torch.clamp(disc_m, min=0.0))
                                > 0.0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    length = torch.where(hit_o, c_o - torch.where(hit_i, c_i, zero), zero)
    keys = torch.where(covered, length, float("inf"))
    return keys, torch.isfinite(keys).sum().to(torch.int32).reshape(1)


def build_order_kernel():
    """Compile csrc/order.cu for sm_90a and bind its entry points."""
    lib = cuda_build.build("order")
    p = ctypes.c_void_p
    lib.chord_keys_launch.argtypes = [p] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
        p, p, p]
    lib.refine_keys_launch.argtypes = [p] * 3 + [ctypes.c_longlong, p]
    lib.refine_perm_launch.argtypes = [p, p, ctypes.c_int, p,
                                       ctypes.c_longlong, ctypes.c_longlong,
                                       p]
    for fn in (lib.chord_keys_launch, lib.refine_keys_launch,
               lib.refine_perm_launch):
        fn.restype = ctypes.c_int
    return lib


def _order_lib():
    global _LIB
    if _LIB is None:
        _LIB = build_order_kernel()
    return _LIB


def chord_keys(cam, r_in: float, r_out: float, width: int, height: int):
    """K6 wrapper: csrc/order.cu for a CUDA camera, the plain version for a
    CPU one.  cam: (org, dir00, du, dv), contiguous (3,) f32 tensors on one
    device (`_camera(lp)`); the radii are rounded to f32.  Returns ((W*H,)
    f32 keys, +inf for misses; (1,) int32 count of finite keys), both on
    cam's device."""
    global launches
    total = width * height
    if len(cam) != 4 or not 0 < total < 2 ** 31 or width < 1:
        raise ValueError("chord_keys: cam must be four (3,) tensors, "
                         "0 < W*H < 2^31")
    dev = cam[0].device
    for v in cam:
        if v.dtype != torch.float32 or v.shape != (3,) \
                or not v.is_contiguous() or v.device != dev:
            raise ValueError("chord_keys: cam must be four contiguous (3,) "
                             "float32 tensors on one device")
    if dev.type == "cpu":
        f32 = lambda r: torch.tensor(r, dtype=torch.float32)
        return _chord_keys_torch(cam, f32(r_in), f32(r_out), width, height)
    if dev.type != "cuda":
        raise ValueError(f"chord_keys: unsupported device {dev}")
    # two allocations: on the host they cost less than slicing and viewing
    # one; the radii round to f32 in ctypes' c_float
    keys = torch.empty(total, dtype=torch.float32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    cuda_build.check("chord_keys", _order_lib().chord_keys_launch(
        cam[0].data_ptr(), cam[1].data_ptr(), cam[2].data_ptr(),
        cam[3].data_ptr(), r_in, r_out, width, total, keys.data_ptr(),
        count.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index)))
    launches += 1
    return keys, count


def pixel_order(lp, r_in, r_out, width: int, height: int
                ) -> tuple[torch.Tensor, int]:
    """(permutation of pixel ids sorted by expected ray cost, n_covered).

    Covered pixels (central ray hits the inflated outer shell) come first,
    cheapest to costliest; misses trail.  Rendering only the first
    n_covered positions skips the all-background tail — those rays never
    write (the reference's early return, deviceCode.cu:294).  The
    permutation is an int32 tensor on lp's device."""
    keys, n_covered = chord_keys(_camera(lp), r_in, r_out, width, height)
    perm = torch.sort(keys, stable=True).indices.to(torch.int32)
    return perm, int(n_covered.item())


def inverse_order(perm):
    """Inverse permutation (tensor in, tensor out; numpy in, numpy out)."""
    if isinstance(perm, np.ndarray):
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
        return inv
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                    device=perm.device)
    return inv



# ---------------------------------------------------------------------------
# K6b: the measured-cost re-sort
# ---------------------------------------------------------------------------

def refine_order(perm, n_active: int, cost_nat) -> np.ndarray:
    """Host numpy re-sort (icon_rt_tpu/ops/order.py `refine_order`): the
    covered prefix of `perm` stable-sorted by the measured per-pixel cost
    (natural pixel order), the tail untouched.  Returns a new (total,)
    permutation."""
    perm = np.asarray(perm)
    head = perm[:n_active]
    key = np.asarray(cost_nat)[head]
    out = perm.copy()
    out[:n_active] = head[np.argsort(key, kind="stable")]
    return out


def repermute(arr, old_perm, new_perm):
    """Host numpy: a buffer stored in old_perm order (arr[i] holds pixel
    old_perm[i]'s data) re-indexed into new_perm order."""
    arr = np.asarray(arr)
    nat = np.empty_like(arr)
    nat[np.asarray(old_perm)] = arr
    return nat[np.asarray(new_perm)]


def _repermute_kernel(new_ptr, inv_ptr, acc_ptr, fb_ptr, acc_out, fb_out, n,
                      BLOCK: tl.constexpr):
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    msk = i < n
    src = tl.load(inv_ptr + tl.load(new_ptr + i, mask=msk, other=0),
                  mask=msk, other=0)
    ch = tl.arange(0, 4)
    m2 = msk[:, None]
    row = tl.load(acc_ptr + src[:, None] * 4 + ch[None, :], mask=m2)
    tl.store(acc_out + i[:, None] * 4 + ch[None, :], row, mask=m2)
    tl.store(fb_out + i, tl.load(fb_ptr + src, mask=msk), mask=msk)


def _check_perm(fn, name, x, n, device):
    if x.dtype != torch.int32 or x.shape != (n,) or not x.is_contiguous() \
            or x.device != device:
        raise ValueError(f"{fn}: {name} must be a contiguous ({n},) int32 "
                         f"tensor on {device}")


def _refine_keys_torch(perm, n_active: int, cost_nat):
    """Plain K6b keys: cost_nat[perm[:n_active]]."""
    return cost_nat[perm[:n_active].long()]


def refine_keys(perm, n_active: int, cost_nat):
    """K6b wrapper, the keys of the re-sort: (n_active,) int32
    cost_nat[perm[i]].  perm and cost_nat: contiguous (total,) int32 on one
    device, perm 16-byte aligned on the card.  A CUDA perm launches
    csrc/order.cu, a CPU one runs the plain version."""
    dev = perm.device
    if perm.dtype != torch.int32 or cost_nat.dtype != torch.int32 \
            or perm.dim() != 1 or cost_nat.shape != perm.shape \
            or not (perm.is_contiguous() and cost_nat.is_contiguous()) \
            or cost_nat.device != dev or not 0 <= n_active <= perm.shape[0] \
            or (dev.type == "cuda" and perm.data_ptr() % 16):
        raise ValueError("refine_keys: perm and cost_nat must be contiguous "
                         "(total,) int32 tensors on one device (perm 16-byte "
                         "aligned on the card), 0 <= n_active <= total")
    if dev.type == "cpu":
        return _refine_keys_torch(perm, n_active, cost_nat)
    if dev.type != "cuda":
        raise ValueError(f"refine_keys: unsupported device {dev}")
    out = torch.empty(n_active, dtype=torch.int32, device=dev)
    if n_active:
        cuda_build.check("refine_keys", _order_lib().refine_keys_launch(
            perm.data_ptr(), cost_nat.data_ptr(), out.data_ptr(), n_active,
            torch._C._cuda_getCurrentRawStream(dev.index)))
        refine_launches["refine_keys"] += 1
    return out


def _refine_perm_torch(perm, n_active: int, order):
    """Plain K6b permutation: perm[:n_active][order], then perm's tail."""
    return torch.cat([perm[:n_active][order.long()], perm[n_active:]])


def refine_perm(perm, n_active: int, order):
    """K6b wrapper, the re-sorted permutation: (total,) int32 with
    perm[order[i]] for i < n_active and perm[i] past it.  order: the
    (n_active,) int64 (as torch.sort returns it) or int32 sorting
    permutation of the covered prefix's keys.  perm and order contiguous
    on one device, 16-byte aligned on the card.  A CUDA perm launches
    csrc/order.cu, a CPU one runs the plain version."""
    dev = perm.device
    total = perm.shape[0]
    if perm.dtype != torch.int32 or perm.dim() != 1 \
            or not 0 <= n_active <= total \
            or order.dtype not in (torch.int32, torch.int64) \
            or order.shape != (n_active,) or order.device != dev \
            or not (perm.is_contiguous() and order.is_contiguous()) \
            or (dev.type == "cuda"
                and (perm.data_ptr() % 16
                     or n_active and order.data_ptr() % 16)):
        raise ValueError("refine_perm: perm must be a contiguous (total,) "
                         "int32 tensor and order a contiguous (n_active,) "
                         "int32 or int64 one on its device (both 16-byte "
                         "aligned on the card), 0 <= n_active <= total")
    if dev.type == "cpu":
        return _refine_perm_torch(perm, n_active, order)
    if dev.type != "cuda":
        raise ValueError(f"refine_perm: unsupported device {dev}")
    out = torch.empty_like(perm)
    if total:
        cuda_build.check("refine_perm", _order_lib().refine_perm_launch(
            perm.data_ptr(), order.data_ptr(), order.dtype == torch.int64,
            out.data_ptr(), n_active, total,
            torch._C._cuda_getCurrentRawStream(dev.index)))
        refine_launches["refine_perm"] += 1
    return out


def refine_order_device(perm, n_active: int, cost_nat):
    """Device re-sort (icon_rt_tpu/ops/order.py `refine_order_device`): the
    covered prefix of the (total,) int32 permutation stable-sorted by the
    (total,) int32 measured cost in natural pixel order (K6b keys,
    `torch.sort(stable=True)`, K6b permutation); the tail untouched.
    Returns a new permutation on perm's device."""
    keys = refine_keys(perm, n_active, cost_nat)
    return refine_perm(perm, n_active,
                       torch.sort(keys, stable=True).indices)


def _repermute_torch(accum, fb, new_perm, inv_old):
    """Plain K6b repermute: lane i takes lane inv_old[new_perm[i]]."""
    src = inv_old[new_perm.long()].long()
    return accum[src], fb[src]


def repermute_device(accum, fb, new_perm, inv_old):
    """Device repermute (icon_rt_tpu/ops/order.py `repermute_device`, for
    accum and fb together): accum (L, 4) f32 and fb (L,) int32 stored in
    the order of a permutation whose inverse is inv_old (inverse_order of
    the old perm) -> new (accum, fb) in new_perm order.  CUDA tensors
    launch the Triton kernel, CPU tensors run the plain version."""
    global _REPERMUTE
    dev = fb.device
    total = fb.shape[0]
    for name, x in (("new_perm", new_perm), ("inv_old", inv_old),
                    ("fb", fb)):
        _check_perm("repermute_device", name, x, total, dev)
    if accum.dtype != torch.float32 or accum.shape != (total, 4) \
            or not accum.is_contiguous() or accum.device != dev:
        raise ValueError(f"repermute_device: accum must be a contiguous "
                         f"({total}, 4) float32 tensor on {dev}")
    if dev.type == "cpu":
        return _repermute_torch(accum, fb, new_perm, inv_old)
    if dev.type != "cuda":
        raise ValueError(f"repermute_device: unsupported device {dev}")
    if _REPERMUTE is None:
        _REPERMUTE = _triton().jit(_repermute_kernel)
    acc_out, fb_out = torch.empty_like(accum), torch.empty_like(fb)
    _REPERMUTE[(-(-total // _BLOCK),)](
        new_perm, inv_old, accum, fb, acc_out, fb_out, total, BLOCK=_BLOCK)
    refine_launches["repermute"] += 1
    return acc_out, fb_out
