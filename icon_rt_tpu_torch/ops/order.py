"""Ray ordering: sort pixels by expected tracking length (kernel K6).

Sorting pixels by the analytic chord length of the central ray through the
outer shell groups similar-cost rays into neighbouring lanes (on the GPU:
into the same warps, so a warp's lanes finish together), and puts the
pixels whose rays miss the volume at the back, so the covered prefix can be
rendered alone.  The permutation depends only on the camera and the shell
radii, so it is computed once per camera move; accumulation and
framebuffer live in permuted order and are unpermuted at present time.

K6 `chord_keys` (Triton) replaces the XLA-fused icon_rt_tpu/ops/order.py
`_chord_keys`: one elementwise pass over W*H pixels, about 20 flops and two
square roots per pixel, one f32 store.  On the H100 it is bound by its
4-byte-per-pixel store and launch latency (8 MB at 1080p); the design keeps
the 12 camera scalars in registers and computes pixel coordinates from the
program id, so it reads nothing per pixel.  The sort that follows is
`torch.sort(stable=True)`.

K6b, the measured-cost re-sort (icon_rt_tpu/ops/order.py
`refine_order_device` :109 and `repermute_device` :124), re-sorts the
covered prefix by the steps each lane took in the last launch
(render_frame_fast's `return_cost`) and carries accum and fb over to the
new order.  Three kernels, all pure gathers with no reuse, so bound by
their bytes: `refine_keys` (CUDA C++, csrc/order.cu) gathers
cost_nat[perm[i]] for the covered prefix; `torch.sort(stable=True)` orders
the keys, as K6; `refine_perm` (Triton) writes the new permutation,
perm[order[i]] on the prefix and perm[i] on the tail; `repermute` (Triton)
moves each lane's 16-byte accum row and 4-byte fb word in one launch, lane
i reading the old lane inv_old[new_perm[i]] (JAX's scatter into natural
order and gather out of it, in one step).  At 1080p these launches are a
few tens of microseconds, about the launch latency, so a call's host work
decides its time: `refine_keys` binds its C entry point through ctypes and
does one check and one allocation a call.  The
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
_KERNEL = None
_K6B = {}
_BLOCK = 1024
_KEYS_LAUNCH = None  # csrc/order.cu refine_keys_launch, bound on first use


def _triton():
    """Import Triton on first launch (this module is imported on machines
    without it); binds the module's `tl` for the kernels' annotations."""
    global tl
    import triton
    import triton.language as tl_
    tl = tl_
    return triton


def _chord_keys_torch(cam, r_in, r_out, width: int, height: int):
    """Plain-PyTorch K6.  cam: (12,) f32 = org | dir00 | du | dv;
    r_in/r_out: () f32 tensors.  Returns (W*H,) f32 keys, +inf for misses."""
    total = width * height
    ids = torch.arange(total, dtype=torch.int32, device=cam.device)
    ys = torch.div(ids, width, rounding_mode="floor")
    xs = ids - ys * width
    ox, oy, oz = cam[0], cam[1], cam[2]
    oo = ox * ox + oy * oy + oz * oz
    u = xs.to(torch.float32) + 1.0   # central ray (pixel + 0.5 + mean jitter)
    v = ys.to(torch.float32) + 1.0
    dx = cam[3] + u * cam[6] + v * cam[9]
    dy = cam[4] + u * cam[7] + v * cam[10]
    dz = cam[5] + u * cam[8] + v * cam[11]
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
    pix = torch.sqrt(cam[6] * cam[6] + cam[7] * cam[7] + cam[8] * cam[8]) \
        + torch.sqrt(cam[9] * cam[9] + cam[10] * cam[10] + cam[11] * cam[11])
    margin = 4.0 * pix * torch.abs(od)
    rm = r_out + margin
    disc_m = od * od - oo + rm * rm
    covered = (disc_m > 0.0) & (-od + torch.sqrt(torch.clamp(disc_m, min=0.0))
                                > 0.0)
    zero = torch.zeros((), dtype=torch.float32, device=cam.device)
    length = torch.where(hit_o, c_o - torch.where(hit_i, c_i, zero), zero)
    return torch.where(covered, length, float("inf"))


def _chord_keys_kernel(cam_ptr, out_ptr, total, width, r_in, r_out,
                       BLOCK: tl.constexpr):
    ids = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    msk = ids < total
    ys = ids // width
    xs = ids - ys * width
    ox = tl.load(cam_ptr + 0)
    oy = tl.load(cam_ptr + 1)
    oz = tl.load(cam_ptr + 2)
    oo = ox * ox + oy * oy + oz * oz
    u = xs.to(tl.float32) + 1.0
    v = ys.to(tl.float32) + 1.0
    dx = tl.load(cam_ptr + 3) + u * tl.load(cam_ptr + 6) \
        + v * tl.load(cam_ptr + 9)
    dy = tl.load(cam_ptr + 4) + u * tl.load(cam_ptr + 7) \
        + v * tl.load(cam_ptr + 10)
    dz = tl.load(cam_ptr + 5) + u * tl.load(cam_ptr + 8) \
        + v * tl.load(cam_ptr + 11)
    inv = tl.math.div_rn(1.0, tl.sqrt_rn(dx * dx + dy * dy + dz * dz))
    dx = dx * inv
    dy = dy * inv
    dz = dz * inv
    od = ox * dx + oy * dy + oz * dz
    disc_o = od * od - oo + r_out * r_out
    sq_o = tl.sqrt_rn(tl.maximum(disc_o, 0.0))
    hit_o = (disc_o > 0.0) & (-od + sq_o > 0.0)
    disc_i = od * od - oo + r_in * r_in
    sq_i = tl.sqrt_rn(tl.maximum(disc_i, 0.0))
    hit_i = (disc_i > 0.0) & (-od + sq_i > 0.0)
    du0 = tl.load(cam_ptr + 6)
    du1 = tl.load(cam_ptr + 7)
    du2 = tl.load(cam_ptr + 8)
    dv0 = tl.load(cam_ptr + 9)
    dv1 = tl.load(cam_ptr + 10)
    dv2 = tl.load(cam_ptr + 11)
    pix = tl.sqrt_rn(du0 * du0 + du1 * du1 + du2 * du2) \
        + tl.sqrt_rn(dv0 * dv0 + dv1 * dv1 + dv2 * dv2)
    margin = 4.0 * pix * tl.abs(od)
    rm = r_out + margin
    disc_m = od * od - oo + rm * rm
    covered = (disc_m > 0.0) & (-od + tl.sqrt_rn(tl.maximum(disc_m, 0.0))
                                > 0.0)
    length = tl.where(hit_o, 2.0 * sq_o - tl.where(hit_i, 2.0 * sq_i, 0.0),
                      0.0)
    key = tl.where(covered, length, float("inf"))
    tl.store(out_ptr + ids, key, mask=msk)


def chord_keys(cam, r_in: float, r_out: float, width: int, height: int):
    """K6 wrapper: the Triton kernel for a CUDA `cam`, the plain version for
    a CPU one.  cam: contiguous (12,) f32 (org | dir00 | du | dv).
    Returns (W*H,) f32 keys on cam's device."""
    global launches, _KERNEL
    if cam.dtype != torch.float32 or cam.shape != (12,) \
            or not cam.is_contiguous():
        raise ValueError("chord_keys: cam must be a contiguous (12,) float32")
    r_in = float(np.float32(r_in))
    r_out = float(np.float32(r_out))
    if cam.device.type == "cpu":
        f32 = lambda r: torch.tensor(r, dtype=torch.float32)
        return _chord_keys_torch(cam, f32(r_in), f32(r_out), width, height)
    if cam.device.type != "cuda":
        raise ValueError(f"chord_keys: unsupported device {cam.device}")
    if _KERNEL is None:
        _KERNEL = _triton().jit(_chord_keys_kernel)
    total = width * height
    out = torch.empty(total, dtype=torch.float32, device=cam.device)
    block = 1024
    _KERNEL[(-(-total // block),)](cam, out, total, width, r_in, r_out,
                                   BLOCK=block, enable_fp_fusion=False)
    launches += 1
    return out


def _camera_vector(lp) -> torch.Tensor:
    return torch.cat([lp.cam_org, lp.cam_dir00, lp.cam_du,
                      lp.cam_dv]).to(torch.float32).contiguous()


def pixel_order(lp, r_in, r_out, width: int, height: int
                ) -> tuple[torch.Tensor, int]:
    """(permutation of pixel ids sorted by expected ray cost, n_covered).

    Covered pixels (central ray hits the inflated outer shell) come first,
    cheapest to costliest; misses trail.  Rendering only the first
    n_covered positions skips the all-background tail — those rays never
    write (the reference's early return, deviceCode.cu:294).  The
    permutation is an int32 tensor on lp's device."""
    keys = chord_keys(_camera_vector(lp), r_in, r_out, width, height)
    perm = torch.sort(keys, stable=True).indices.to(torch.int32)
    n_covered = int(torch.isfinite(keys).sum().item())
    return perm, n_covered


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


def _refine_perm_kernel(perm_ptr, order_ptr, out_ptr, n_active, total,
                        BLOCK: tl.constexpr):
    i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    msk = i < total
    head = i < n_active
    src = tl.where(head, tl.load(order_ptr + i, mask=head, other=0), i)
    tl.store(out_ptr + i, tl.load(perm_ptr + src, mask=msk, other=0),
             mask=msk)


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


def _k6b(name: str):
    if name not in _K6B:
        fn = {"refine_perm": _refine_perm_kernel,
              "repermute": _repermute_kernel}[name]
        _K6B[name] = _triton().jit(fn)
    return _K6B[name]


def _check_perm(fn, name, x, n, device):
    if x.dtype != torch.int32 or x.shape != (n,) or not x.is_contiguous() \
            or x.device != device:
        raise ValueError(f"{fn}: {name} must be a contiguous ({n},) int32 "
                         f"tensor on {device}")


def _refine_keys_torch(perm, n_active: int, cost_nat):
    """Plain K6b keys: cost_nat[perm[:n_active]]."""
    return cost_nat[perm[:n_active].long()]


def build_order_kernel():
    """Compile csrc/order.cu for sm_90a and bind its entry point."""
    lib = cuda_build.build("order")
    lib.refine_keys_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    lib.refine_keys_launch.restype = ctypes.c_int
    return lib


def refine_keys(perm, n_active: int, cost_nat):
    """K6b wrapper, the keys of the re-sort: (n_active,) int32
    cost_nat[perm[i]].  perm and cost_nat: contiguous (total,) int32 on one
    device, perm 16-byte aligned on the card.  A CUDA perm launches
    csrc/order.cu, a CPU one runs the plain version."""
    global _KEYS_LAUNCH
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
        if _KEYS_LAUNCH is None:
            _KEYS_LAUNCH = build_order_kernel().refine_keys_launch
        cuda_build.check("refine_keys", _KEYS_LAUNCH(
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
    (n_active,) int32 sorting permutation of the covered prefix's keys.  A
    CUDA perm launches the Triton kernel, a CPU one runs the plain
    version."""
    dev = perm.device
    total = perm.shape[0]
    _check_perm("refine_perm", "perm", perm, total, dev)
    if not 0 <= n_active <= total:
        raise ValueError("refine_perm: n_active outside [0, total]")
    _check_perm("refine_perm", "order", order, n_active, dev)
    if dev.type == "cpu":
        return _refine_perm_torch(perm, n_active, order)
    if dev.type != "cuda":
        raise ValueError(f"refine_perm: unsupported device {dev}")
    out = torch.empty_like(perm)
    if total:
        _k6b("refine_perm")[(-(-total // _BLOCK),)](
            perm, order, out, n_active, total, BLOCK=_BLOCK)
        refine_launches["refine_perm"] += 1
    return out


def refine_order_device(perm, n_active: int, cost_nat):
    """Device re-sort (icon_rt_tpu/ops/order.py `refine_order_device`): the
    covered prefix of the (total,) int32 permutation stable-sorted by the
    (total,) int32 measured cost in natural pixel order (K6b keys,
    `torch.sort(stable=True)`, K6b permutation); the tail untouched.
    Returns a new permutation on perm's device."""
    keys = refine_keys(perm, n_active, cost_nat)
    order = torch.sort(keys, stable=True).indices.to(torch.int32)
    return refine_perm(perm, n_active, order)


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
    acc_out, fb_out = torch.empty_like(accum), torch.empty_like(fb)
    _k6b("repermute")[(-(-total // _BLOCK),)](
        new_perm, inv_old, accum, fb, acc_out, fb_out, total, BLOCK=_BLOCK)
    refine_launches["repermute"] += 1
    return acc_out, fb_out
