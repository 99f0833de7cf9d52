"""PyTorch port, the app's interactive front: the preview tier (--preview N)
and --samples auto against apps/icon_rt.py on the same arguments, and the
pipeline's frame count across a preview (fault F2 of the JAX pipeline, not
copied)."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "apps"))

import icon_rt  # noqa: E402

from icon_rt_tpu.utils import autosize as jautosize  # noqa: E402
from icon_rt_tpu.utils.png import read_png  # noqa: E402
from icon_rt_tpu_torch import app  # noqa: E402
from icon_rt_tpu_torch.utils import autosize  # noqa: E402
from test_torch_fast import FB_MISMATCH_BOUND  # noqa: E402
from test_torch_fastq import APP_TF_MISMATCH_BOUND  # noqa: E402

torch.set_num_threads(1)

ARGS = ["--synthetic", "3:8", "--size", "64", "64"]
#: per-pixel mismatch bound of the presented preview against the JAX app's,
#: by tier (the full-res bounds of tests/test_torch_fast.py and
#: test_torch_fastq.py; one preview pixel covers 16 presented ones);
#: measured 0 of 4096 on f32, --quantized and --march
PREVIEW_BOUND = {"f32": FB_MISMATCH_BOUND, "q": APP_TF_MISMATCH_BOUND}


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' fine-map caches in an empty directory of the test."""
    from icon_rt_tpu.data import bigscene as jbigscene
    from icon_rt_tpu_torch.data import bigscene
    monkeypatch.setattr(jbigscene, "_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(bigscene, "CACHE_DIR", str(tmp_path / "torch"))
    return tmp_path


def _preview_sequence(pl):
    """tests/test_app.py `test_app_preview_tier`'s sequence: a full-res
    launch, a reset, the preview launch (checked as there); returns the
    presented (H*W,) preview fb as uint32."""
    pl.launch()
    assert pl.samples_per_launch >= 1
    pl.reset_accumulation()
    assert pl.preview_pending
    pl.launch()
    assert not pl.preview_pending and pl.samples_per_launch == 0
    fb = np.asarray(pl._last_fb)
    assert isinstance(pl._last_fb, np.ndarray)     # already on the host
    assert fb.shape == (pl.width * pl.height,)
    img = fb.reshape(pl.height // 4, 4, pl.width // 4, 4)
    assert (img == img[:, :1, :, :1]).all()        # constant 4 x 4 blocks
    return fb.view(np.uint32)


#: the tracker and march calls of test_torch_preview_matches_jax_app's
#: sequence by tier: (function, width, samples); the quantized tier goes
#: through render_frame_fast_q
PREVIEW_CALLS = {
    "f32": [("render_frame_fast", 64, 4), ("render_frame_fast", 16, 1)],
    "q": [],
    "march": [("render_frame_march", 64, 1), ("render_frame_fast", 16, 1)],
}


@pytest.mark.parametrize("tier", ["f32", "q", "march"])
def test_torch_preview_matches_jax_app(caches, monkeypatch, tier):
    """--preview 4: the presented preview (one sample at 16 x 16 through
    K6 and K1, or K2 with --quantized, upscaled in natural order) agrees
    with the JAX app's per pixel within its tier's bound; under --march the
    preview is a Woodcock frame (K1), as in JAX, and the march renders no
    preview."""
    from icon_rt_tpu_torch.ops import fast, march
    calls = []
    for mod, name in ((fast, "render_frame_fast"),
                      (march, "render_frame_march")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append((_name, k["width"], k.get("samples", 1)))
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    flags = {"f32": [], "q": ["--quantized"], "march": ["--march"]}[tier]
    argv = [*ARGS, "--sample-limit", "4", "--preview", "4", *flags]
    fb_t = _preview_sequence(app.build(["--device", "cpu", *argv]))
    fb_j = _preview_sequence(icon_rt.build(argv))
    assert calls == PREVIEW_CALLS[tier]
    differ = int((fb_t != fb_j).sum())
    assert differ <= PREVIEW_BOUND["q" if tier == "q" else "f32"], differ
    assert int((fb_t >> 24 > 0).sum()) > 200        # not blank


@pytest.mark.parametrize("flags,jax", [
    (["-mode", "2", "--preview", "4"], False), (["--preview", "3"], True)],
    ids=["wedge", "not-divisible"])
def test_torch_preview_skipped_as_jax(flags, jax):
    """The fast wedge tier without --quantized, and a frame that N does not
    divide, render no preview (apps/icon_rt.py:415-419): the launch after a
    reset is the full-res sample 0 and the preview stays pending.  The JAX
    app is run on the second case (its wedge tier's compile alone takes
    ~20 s here)."""
    argv = [*ARGS, "--sample-limit", "4", *flags]
    pls = [app.build(["--device", "cpu", *argv])]
    if jax:
        pls.append(icon_rt.build(argv))
    for pl in pls:
        pl.reset_accumulation()
        pl.launch()
        assert pl.preview_pending and pl.samples_per_launch == 4
        assert tuple(pl._last_fb.shape) == (64 * 64,)


def test_torch_preview_leaves_frame_id_at_0():
    """Fault F2 of the JAX pipeline, not copied: after reset -> preview ->
    is_running(), the port's frame_id stays 0, so its next launch does
    frame 0's work (a new accumulator, the rays re-sorted for the camera)
    and equals, bit for bit, frame 0 of a run without the preview.  The JAX
    pipeline advances by max(1, samples_per_launch) to frame_id 1
    (icon_rt_tpu/pipeline/pipeline.py:236-244), which skips that work."""
    argv = ["--synthetic", "2:4", "--size", "32", "32", "--sample-limit",
            "8", "--samples", "2"]
    runs = []
    for preview in (["--preview", "4"], []):
        pl = app.build(["--device", "cpu", *argv, *preview])
        pl.launch()
        assert pl.is_running() and pl.frame_id == 2
        # a camera move: a new view, and the old accumulation is stale
        pl.camera.set_orientation(pl.camera.position * 1.1,
                                  pl.camera.get_poi(), pl.camera.up_vector,
                                  pl.camera.fovy)
        pl.reset_accumulation()
        old = pl.frame["accum"]
        if preview:
            pl.launch()
            assert pl.samples_per_launch == 0
            assert pl.is_running() and pl.frame_id == 0
        pl.launch()
        assert pl.frame["accum"] is not old           # frame 0's allocation
        runs.append(pl.frame["fb"].clone())
        assert pl.is_running() and pl.frame_id == 2
    assert torch.equal(runs[0], runs[1])
    pl_j = icon_rt.build([*argv, "--preview", "4"])
    pl_j.launch()
    pl_j.is_running()
    pl_j.reset_accumulation()
    pl_j.launch()
    pl_j.is_running()
    assert pl_j.frame_id == 1                          # F2


@pytest.mark.parametrize("budget,cap,probe_spp,amort", list(itertools.product(
    (autosize.DEFAULT_BUDGET_S, app.AUTO_BUDGET_S), (1, 16, 64), (1, 8),
    (autosize.AMORT, autosize.SYNTH_AMORT))))
def test_torch_auto_spp_matches_jax(budget, cap, probe_spp, amort):
    """utils/autosize.py auto_spp: the JAX package's arithmetic over probes
    from 10 us to 100 s, and JAX's own contract
    (tests/test_bench.py:158-160)."""
    for probe in np.geomspace(1e-5, 100.0, 29):
        assert autosize.auto_spp(probe, budget, cap, probe_spp, amort) == \
            jautosize.auto_spp(probe, budget, cap, probe_spp, amort)
    assert autosize.SPP_TIERS == jautosize.SPP_TIERS
    assert autosize.auto_spp(1.77, cap=64, amort=autosize.SYNTH_AMORT) == 64
    assert autosize.auto_spp(11.0, cap=32) <= 4
    assert autosize.auto_spp(60.0, cap=64) <= 1


class FakeTime:
    """A `time` module whose perf_counter advances by `step` at each call:
    the probe frame reads it twice, so the probe measures `step`."""

    def __init__(self, step):
        self.step, self.t = step, 0.0

    def perf_counter(self):
        self.t += self.step
        return self.t


#: (pick, the JAX app's probe seconds for it at its 40 s budget, the
#: port's at AUTO_BUDGET_S); --sample-limit 8 clamps the pick
AUTO_PICKS = [(2, 20.0, 0.016), (4, 10.0, 0.008), (64, 1e-3, 1e-4)]


@pytest.mark.parametrize("pick,probe_j,probe_t", AUTO_PICKS,
                         ids=[str(p[0]) for p in AUTO_PICKS])
def test_torch_samples_auto_matches_jax(tmp_path, monkeypatch, capfd, pick,
                                        probe_j, probe_t):
    """--samples auto, both apps' probe clocks pinned: frames 0 and 1 render
    one sample, frame 1's probe picks the launch size, later launches are
    clamped to --sample-limit; the spl sequences are equal and the PNGs
    agree within FB_MISMATCH_BOUND."""
    argv = [*ARGS, "--sample-limit", "8", "--samples", "auto"]
    monkeypatch.setattr(app, "time", FakeTime(probe_t))
    monkeypatch.setattr(icon_rt, "time", FakeTime(probe_j))
    seqs, imgs = [], []
    for build, extra in ((app.build, ["--device", "cpu"]),
                         (icon_rt.build, [])):
        out = str(tmp_path / ("t" if extra else "j"))
        pl = build([*extra, *argv, "-o", out])
        seq = []
        while True:
            pl.launch()
            seq.append(pl.samples_per_launch)
            if not pl.is_running():
                break
        pl.present()
        seqs.append(seq)
        imgs.append(read_png(out + ".png"))
    want, left = [1, 1], 6
    while left:
        want.append(min(pick, left))
        left -= want[-1]
    assert seqs[0] == seqs[1] == want, seqs
    assert capfd.readouterr().err.count(f"# auto samples/launch: {pick}") == 2
    differ = (imgs[0] != imgs[1]).any(axis=-1)
    assert differ.sum() <= FB_MISMATCH_BOUND, differ.sum()
