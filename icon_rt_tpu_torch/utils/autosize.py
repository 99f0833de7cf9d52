"""Samples per launch from a measured probe and a wall-clock budget
(the arithmetic of icon_rt_tpu/utils/autosize.py `auto_spp`).

`auto_spp` picks the largest power-of-two samples per launch whose
estimated wall stays under a budget.  The app's `--samples auto` passes its
own budget (icon_rt_tpu_torch/app.py `AUTO_BUDGET_S`); the 40 s default
here is the JAX package's, kept so that both functions answer alike.
"""
from __future__ import annotations

#: candidate samples-per-launch values, powers of two
SPP_TIERS = (1, 2, 4, 8, 16, 32, 64)

#: the default per-launch wall budget of the JAX package's auto_spp
DEFAULT_BUDGET_S = 40.0

#: in-lane batching amortization measured on the synthetic scene family
#: (a samples=S launch costs ~S/3 samples=1 launches there); the default
#: model is linear, the safe one for an unknown scene
SYNTH_AMORT = 1.0 / 3.0
AMORT = 1.0


def auto_spp(probe_s: float, budget_s: float = DEFAULT_BUDGET_S,
             cap: int = 64, probe_spp: int = 1,
             amort: float = AMORT) -> int:
    """Largest power-of-two spp <= cap whose estimated launch wall,
    spp * (probe_s / probe_spp) * amort, stays under budget_s (1 if none
    does).  The amortization applies only to probes of <= 4 samples."""
    per = max(probe_s / max(probe_spp, 1), 1e-9)
    a = amort if probe_spp <= 4 else 1.0
    spp = 1
    for t in SPP_TIERS:
        if t <= cap and t * per * a <= budget_s:
            spp = t
    return spp
