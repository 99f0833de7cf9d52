"""K10: the multi-device composites around the collectives.

A rank of a sharded frame traces its lanes in raw mode (ops/fast.py
`track_f32`, ops/fastq.py `track_q` with `out=`): per lane whether the ray
met the shell, the sample's colour and alpha, and the accepted collision's
ray parameter t.  The ranks' samples are joined by `torch.distributed`
collectives (parallel/comm.py); these kernels build what a rank sends and
turn what comes back into the frame:

  * first hit over latitude slabs (parallel/scene_shard.py; JAX's
    `_argmin_select`, icon_rt_tpu/parallel/scene_shard.py:162): MIN of t,
    then `select_candidates` -> MIN of the candidate slab (ties go to the
    lowest slab), then `select_payload` -> SUM of the winner's colour, then
    `finalize_first_hit`;
  * mean over the samples axis (parallel/sharded.py; JAX's psum mean,
    icon_rt_tpu/parallel/sharded.py:127-131, :243-248): `mean_payload` ->
    one SUM of [wrote ? ca : 0, wrote] -> `finalize_mean`.

Kernels (CUDA C++, csrc/composite.cu): `composite_mask` (the three send
buffers) and `composite_finalize` (the two epilogues, through the trackers'
own blend and RGBA8 pack; it reads the launch's sample id, a () int32
tensor on the card, there, so a call reads nothing back).  Plain versions:
`_mask_torch`, `_finalize_torch` (torch.where chains, then ops/render.py
`_finalize`).  CUDA tensors launch the kernels, CPU tensors run the plain
versions, anything else raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from .fast import F32, _check
from .render import _finalize

#: kernel launches of K10 (the wrappers count only CUDA launches)
launches = {"composite_mask": 0, "composite_finalize": 0}

#: composite_mask modes
CAND, PAYLOAD, MEAN = 0, 1, 2
#: composite_finalize modes
FIRST_HIT, MEAN_FIN = 0, 1


class _CompositeParams(ctypes.Structure):
    """Mirror of `CompositeParams` in csrc/composite.cu (same field order)."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "t", "t_min", "win", "ca", "wrote", "sum", "cand", "send", "accum",
        "fb", "accum_id")] + [(n, ctypes.c_int) for n in (
            "n_lanes", "mode", "rank", "n_ranks")]


def build_composite():
    """Compile csrc/composite.cu for sm_90a (utils/cuda_build.py) and bind
    its two C entry points; returns the ctypes library."""
    lib = cuda_build.build("composite")
    for fn in (lib.composite_mask_launch, lib.composite_finalize_launch):
        fn.argtypes = [ctypes.POINTER(_CompositeParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.composite_occupancy.argtypes = [ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
    lib.composite_occupancy.restype = ctypes.c_int
    return lib


def composite_occupancy(kernel: str) -> dict:
    """{'blocks_per_sm', 'registers', 'local_bytes'} of K10's kernel
    `kernel` ("mask" or "finalize"): its resident 256-thread blocks an SM,
    registers and local bytes a thread."""
    out = (ctypes.c_int * 3)()
    cuda_build.check("composite_occupancy", build_composite().
                     composite_occupancy(("mask", "finalize").index(kernel),
                                         out))
    return {"blocks_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2]}


def _mask_torch(mode: int, rank: int, n_ranks: int, t=None, t_min=None,
                win=None, ca=None, wrote=None):
    """Plain composite_mask: the send buffer of `mode`."""
    if mode == CAND:
        return torch.where(t == t_min, rank, n_ranks).to(torch.int32)
    if mode == PAYLOAD:
        mine = (t == t_min) & (win == rank)
        return torch.where(mine[:, None], ca, 0.0)
    return torch.cat([torch.where(wrote[:, None], ca, 0.0),
                      wrote.to(F32)[:, None]], dim=1)


def _finalize_torch(mode: int, total, accum, fb, accum_id, t_min=None,
                    wrote=None):
    """Plain composite_finalize: the composited sample of `mode`, then
    `_finalize` into accum and fb in place."""
    if mode == FIRST_HIT:
        ca = torch.where(torch.isfinite(t_min)[:, None], total, 0.0)
    else:
        n = total[:, 4]
        wrote = n > 0.0
        ca = total[:, :4] / torch.clamp(n, min=1.0)[:, None]
    acc, pixels = _finalize(wrote, ca, accum, fb, accum_id)
    accum.copy_(acc)
    fb.copy_(pixels)


def _launch(kernel: str, mode: int, n: int, dev, *, rank=0, n_ranks=1,
            **tensors):
    """Launch composite_<kernel> over n lanes with the given tensors."""
    lib = build_composite()
    p = _CompositeParams(n_lanes=n, mode=mode, rank=rank, n_ranks=n_ranks,
                         **{k: v.data_ptr() for k, v in tensors.items()})
    name = f"composite_{kernel}"
    cuda_build.check(name, getattr(lib, f"{name}_launch")(
        ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream))
    launches[name] += 1


def _device(fn: str, x) -> torch.device:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    return x.device


def select_candidates(t, t_min, rank: int, n_ranks: int):
    """(L,) int32: `rank` where this slab's t equals the minimum over the
    slabs, else n_ranks (reduced by MIN, the lowest tied slab wins)."""
    dev = _device("select_candidates", t)
    L = t.shape[0]
    _check("t", t, F32, (L,), dev, fn="select_candidates")
    _check("t_min", t_min, F32, (L,), dev, fn="select_candidates")
    if dev.type == "cpu":
        return _mask_torch(CAND, rank, n_ranks, t=t, t_min=t_min)
    cand = torch.empty(L, dtype=torch.int32, device=dev)
    _launch("mask", CAND, L, dev, rank=rank, n_ranks=n_ranks, t=t,
            t_min=t_min, cand=cand)
    return cand


def select_payload(t, t_min, win, ca, rank: int):
    """(L, 4) f32: this slab's colour where it holds the first hit and is
    the winning slab `win`, else 0 (reduced by SUM)."""
    dev = _device("select_payload", t)
    L = t.shape[0]
    ck = lambda name, x, dt, shape: _check(name, x, dt, shape, dev,
                                           fn="select_payload")
    ck("t", t, F32, (L,))
    ck("t_min", t_min, F32, (L,))
    ck("win", win, torch.int32, (L,))
    ck("ca", ca, F32, (L, 4))
    if dev.type == "cpu":
        return _mask_torch(PAYLOAD, rank, 0, t=t, t_min=t_min, win=win, ca=ca)
    send = torch.empty((L, 4), dtype=F32, device=dev)
    _launch("mask", PAYLOAD, L, dev, rank=rank, t=t, t_min=t_min, win=win,
            ca=ca, send=send)
    return send


def mean_payload(wrote, ca):
    """(L, 5) f32: [wrote ? ca : 0, wrote], one buffer for the samples
    axis's SUM (JAX's two psums)."""
    dev = _device("mean_payload", ca)
    L = ca.shape[0]
    _check("wrote", wrote, torch.bool, (L,), dev, fn="mean_payload")
    _check("ca", ca, F32, (L, 4), dev, fn="mean_payload")
    if dev.type == "cpu":
        return _mask_torch(MEAN, 0, 0, ca=ca, wrote=wrote)
    send = torch.empty((L, 5), dtype=F32, device=dev)
    _launch("mask", MEAN, L, dev, wrote=wrote, ca=ca, send=send)
    return send


def _check_frame(fn, accum, fb, accum_id, L, dev):
    _check("accum", accum, F32, (L, 4), dev, fn=fn)
    _check("fb", fb, torch.int32, (L,), dev, fn=fn)
    if dev.type == "cuda":   # the kernel reads it on the card
        _check("accum_id", accum_id, torch.int32, (), dev, fn=fn)


def finalize_first_hit(total, t_min, wrote, accum, fb, accum_id):
    """Accumulate the first hit over the slabs into accum (L, 4) and fb (L,)
    IN PLACE: the reduced payload where t_min is finite, else 0, written
    where the ray met the shell (`wrote`); accum_id the launch's sample id
    ((), int32 tensor, on the card for CUDA tensors)."""
    dev = _device("finalize_first_hit", total)
    L = total.shape[0]
    ck = lambda name, x, dt, shape: _check(name, x, dt, shape, dev,
                                           fn="finalize_first_hit")
    ck("total", total, F32, (L, 4))
    ck("t_min", t_min, F32, (L,))
    ck("wrote", wrote, torch.bool, (L,))
    _check_frame("finalize_first_hit", accum, fb, accum_id, L, dev)
    if dev.type == "cpu":
        _finalize_torch(FIRST_HIT, total, accum, fb, accum_id, t_min=t_min,
                        wrote=wrote)
        return
    _launch("finalize", FIRST_HIT, L, dev, accum_id=accum_id, sum=total,
            t_min=t_min, wrote=wrote, accum=accum, fb=fb)


def finalize_mean(total, accum, fb, accum_id):
    """Accumulate the mean of the samples axis into accum (L, 4) and fb (L,)
    IN PLACE: the reduced (L, 5) [sum of ca, count] as ca / max(count, 1),
    written where the count is > 0; accum_id as `finalize_first_hit`."""
    dev = _device("finalize_mean", total)
    L = total.shape[0]
    _check("total", total, F32, (L, 5), dev, fn="finalize_mean")
    _check_frame("finalize_mean", accum, fb, accum_id, L, dev)
    if dev.type == "cpu":
        _finalize_torch(MEAN_FIN, total, accum, fb, accum_id)
        return
    _launch("finalize", MEAN_FIN, L, dev, accum_id=accum_id, sum=total,
            accum=accum, fb=fb)
