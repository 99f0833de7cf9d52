"""Bit-exact counter-based RNG matching the reference renderer.

The reference seeds a linear-congruential generator with a 4-round
Tiny-Encryption-Algorithm mix of two 32-bit values and then draws 24-bit
uniforms (ref: common/dvr_course-common-both.h:41-88, LCG<4>).

PyTorch's uint32 tensors support only `*`, `^`, `&` and casts on the CPU
(`+`, `>>` and `>` raise), so the tensor version keeps each stream in an
int64 tensor holding the u32 value and masks with `& 0xFFFFFFFF` after
every step that can carry past bit 31.  The CUDA kernel (csrc/track_f32.cu)
uses native uint32_t arithmetic and gives the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

_TEA_DELTA = 0x9E3779B9
_TEA_K0, _TEA_K1 = 0xA341316C, 0xC8013EA4
_TEA_K2, _TEA_K3 = 0xAD90777D, 0x7E95761E
_LCG_A = 1664525
_LCG_C = 1013904223
_MASK24 = 0x00FFFFFF
_MASK32 = 0xFFFFFFFF
_INV_2_24 = 1.0 / float(0x01000000)


def lcg_init(val0, val1, rounds: int = 4) -> torch.Tensor:
    """TEA-mix two u32 seeds (integer tensors) into an initial LCG state:
    an int64 tensor holding the u32 value."""
    v0 = torch.as_tensor(val0).to(torch.int64) & _MASK32
    v1 = torch.as_tensor(val1).to(torch.int64) & _MASK32
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + _TEA_DELTA) & _MASK32
        v0 = (v0 + ((((v1 << 4) + _TEA_K0) ^ (v1 + s0)
                     ^ ((v1 >> 5) + _TEA_K1)) & _MASK32)) & _MASK32
        v1 = (v1 + ((((v0 << 4) + _TEA_K2) ^ (v0 + s0)
                     ^ ((v0 >> 5) + _TEA_K3)) & _MASK32)) & _MASK32
    return v0


def lcg_next(state: torch.Tensor):
    """Advance the LCG; returns (new_state, uniform float32 in [0, 1))."""
    state = (state * _LCG_A + _LCG_C) & _MASK32
    value = (state & _MASK24).to(torch.float32) * _INV_2_24
    return state, value


# ---------------------------------------------------------------------------
# NumPy twin (host-side oracle / tooling; identical bit behavior)
# ---------------------------------------------------------------------------

def np_lcg_init(val0, val1, rounds: int = 4):
    with np.errstate(over="ignore"):
        v0 = np.asarray(val0, dtype=np.uint32)
        v1 = np.asarray(val1, dtype=np.uint32)
        s0 = np.uint32(0)
        for _ in range(rounds):
            s0 = np.uint32((int(s0) + _TEA_DELTA) & 0xFFFFFFFF)
            v0 = v0 + (((v1 << np.uint32(4)) + np.uint32(_TEA_K0))
                       ^ (v1 + s0)
                       ^ ((v1 >> np.uint32(5)) + np.uint32(_TEA_K1)))
            v1 = v1 + (((v0 << np.uint32(4)) + np.uint32(_TEA_K2))
                       ^ (v0 + s0)
                       ^ ((v0 >> np.uint32(5)) + np.uint32(_TEA_K3)))
        return v0


def np_lcg_next(state):
    with np.errstate(over="ignore"):
        state = np.uint32(_LCG_A) * state + np.uint32(_LCG_C)
    value = np.float32(state & np.uint32(_MASK24)) * np.float32(_INV_2_24)
    return state, value
