"""Image metrics and per-phase timing.

The reference's only instruments are an EWMA fps readout and a
center-pixel printf gate (SURVEY §5).  These add the image RMSE of packed
framebuffers, the accumulation RMSE, the tonemap-LSB fidelity criterion
and a phase timer usable around builds, TF edits and frames; with a
`trace_dir` a phase runs under torch.profiler and leaves a Chrome trace
there.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .color import unpack_rgba


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def image_rmse(fb_a, fb_b) -> float:
    """RMSE between two packed RGBA8 framebuffers, in 8-bit channel units
    (the BASELINE.json fidelity metric: 'image RMSE vs CUDA reference')."""
    a = unpack_rgba(_host(fb_a)).astype(np.float64)
    b = unpack_rgba(_host(fb_b)).astype(np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def accum_rmse(accum_a, accum_b) -> float:
    """RMSE between two float accumulation buffers."""
    a = _host(accum_a).astype(np.float64)
    b = _host(accum_b).astype(np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def within_tonemap_lsb(fb_a, fb_b, tolerance_lsb: int = 1,
                       fraction: float = 0.999) -> bool:
    """True when at least `fraction` of channel values differ by at most
    `tolerance_lsb` 8-bit steps (the north-star fidelity criterion)."""
    a = unpack_rgba(_host(fb_a)).astype(np.int32)
    b = unpack_rgba(_host(fb_b)).astype(np.int32)
    return float((np.abs(a - b) <= tolerance_lsb).mean()) >= fraction


class PhaseTimer:
    """Named-phase wall timing with EWMA per phase (the reference's
    avg = 0.8 avg + 0.2 dt, ref: common/pipeline.cu:605) and totals."""

    def __init__(self):
        self.ewma: dict[str, float] = {}
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, trace_dir: str | None = None):
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            ctx = profile(activities=acts)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx as prof:
            yield
        dt = time.perf_counter() - t0
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir,
                                                  f"{name}.json"))
        self.ewma[name] = 0.8 * self.ewma.get(name, dt) + 0.2 * dt
        self.total[name] = self.total.get(name, 0.0) + dt
        self.count[name] = self.count.get(name, 0) + 1

    def fps(self, name: str = "frame") -> float:
        return 1.0 / max(self.ewma.get(name, 0.0), 1e-8)

    def mray_per_s(self, width: int, height: int, name: str = "frame") -> float:
        return width * height / max(self.ewma.get(name, 0.0), 1e-8) / 1e6

    def report(self) -> str:
        lines = []
        for name in self.total:
            lines.append(f"{name}: n={self.count[name]} "
                         f"total={self.total[name]:.3f}s "
                         f"ewma={self.ewma[name] * 1e3:.1f}ms")
        return "\n".join(lines)
