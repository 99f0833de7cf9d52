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
"""
from __future__ import annotations

import numpy as np
import torch

#: K6 launches (kernel launches only; CPU plain-version runs do not count)
launches = 0

tl = None          # triton.language, bound on first launch
_KERNEL = None


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
    global launches, _KERNEL, tl
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
        import triton
        import triton.language as tl
        _KERNEL = triton.jit(_chord_keys_kernel)
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

