"""PyTorch port, the image metrics and the phase timer
(icon_rt_tpu_torch/utils/metrics.py) against the JAX package's
(icon_rt_tpu/utils/metrics.py) on the same seeded frames: the counterpart
of tests/test_metrics.py."""
import numpy as np
import pytest
import torch

from icon_rt_tpu.utils import metrics as jmetrics
from icon_rt_tpu_torch.utils import metrics
from icon_rt_tpu_torch.utils.color import make_rgba

torch.set_num_threads(1)


def _frames(seed, n=4096):
    """Two packed RGBA8 frames (int32 tensors holding the u32 bits) and
    their float sources: b is a perturbed by up to 3 LSB on some pixels."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (n, 4)).astype(np.float32)
    b = a.copy()
    sel = rng.random(n) < 0.3
    b[sel] += rng.uniform(-3 / 256, 3 / 256, (int(sel.sum()), 4)) \
        .astype(np.float32)
    b = np.clip(b, 0.0, 1.0)
    return (make_rgba(torch.from_numpy(a)), make_rgba(torch.from_numpy(b)),
            a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_metrics_match_jax(seed):
    """image_rmse, accum_rmse and within_tonemap_lsb equal the JAX
    package's on the same frames (a tensor and its u32 view alike)."""
    fa, fb, a, b = _frames(seed)
    ua, ub = (f.numpy().view(np.uint32) for f in (fa, fb))
    assert metrics.image_rmse(fa, fb) == jmetrics.image_rmse(ua, ub)
    assert metrics.image_rmse(fa, fa) == 0.0
    assert metrics.accum_rmse(torch.from_numpy(a), b) == \
        jmetrics.accum_rmse(a, b)
    for tol in (0, 1, 3):
        for frac in (0.9, 0.999):
            assert metrics.within_tonemap_lsb(fa, fb, tol, frac) == \
                jmetrics.within_tonemap_lsb(ua, ub, tol, frac)
    assert metrics.within_tonemap_lsb(fa, fb, 3) and \
        not metrics.within_tonemap_lsb(fa, fb, 0)


def test_torch_phase_timer(tmp_path):
    """The EWMA, counts, fps and report of tests/test_metrics.py; with a
    trace_dir the phase leaves a Chrome trace there."""
    t = metrics.PhaseTimer()
    for _ in range(3):
        with t.phase("frame"):
            torch.ones(8).sum()
    assert t.count["frame"] == 3
    assert t.fps("frame") > 0 and t.mray_per_s(8, 8) > 0
    assert "frame" in t.report()
    with t.phase("traced", trace_dir=str(tmp_path)):
        torch.ones(8).sum()
    assert (tmp_path / "traced.json").exists()
    assert t.count["traced"] == 1
