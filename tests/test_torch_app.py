"""PyTorch port, the application: icon_rt_tpu_torch.app against
apps/icon_rt.py on the same arguments, and the flags it does not port."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "apps"))

import icon_rt  # noqa: E402

from icon_rt_tpu.utils.png import read_png  # noqa: E402
from icon_rt_tpu_torch import app  # noqa: E402
from test_torch_fast import FB_MISMATCH_BOUND  # noqa: E402
from test_torch_fastq import APP_TF_MISMATCH_BOUND  # noqa: E402

torch.set_num_threads(1)

ARGS = ["--synthetic", "3:8", "--size", "64", "64", "--sample-limit", "4"]


def test_torch_app_matches_jax_app(tmp_path):
    """Both apps render 4 samples in one launch (default --samples 8,
    clamped to --sample-limit) and write their PNG; the images agree per
    pixel within the fast tracker's bound (test_torch_fast.py)."""
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    assert app.main(["--device", "cpu", *ARGS, "-o", out_t]) == 0
    assert icon_rt.main([*ARGS, "-o", out_j]) == 0
    img_t, img_j = read_png(out_t + ".png"), read_png(out_j + ".png")
    assert img_t.shape == img_j.shape == (64, 64, 4)
    differ = (img_t != img_j).any(axis=-1)
    assert differ.sum() <= FB_MISMATCH_BOUND, differ.sum()
    # not blank: rendered pixels differ from the --bgcolor canvas
    assert (img_t[..., :3] != img_t[0, 0, :3]).any(axis=-1).sum() > 50


def test_torch_app_build_runs_and_counts_frames(tmp_path):
    pl = app.build(["--device", "cpu", *ARGS[:5], "--sample-limit", "5",
                    "--samples", "2", "-o", str(tmp_path / "x")])
    launches = 0
    while True:
        pl.launch()
        launches += 1
        if not pl.is_running():
            break
    assert launches == 3            # 2 + 2 + 1 samples
    assert pl.frame_id == 5
    fb = pl.frame["fb"]
    assert fb.dtype == torch.int32 and fb.shape == (64 * 64,)
    pl.present()
    assert os.path.exists(str(tmp_path / "x.png"))


@pytest.mark.parametrize("flags", [
    ["--raygen", "accel"], ["--raygen", "ae"], ["--sampler", "brute"],
    ["--sampler", "wedge"], ["-mode", "2"], ["--march", "--raygen", "ae"],
    ["--preview", "4"], ["--samples", "auto"]])
def test_torch_app_out_of_slice_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        app.build(["--device", "cpu", *ARGS, *flags])


def _run_loop(pl):
    """The launch / is_running loop of apps/icon_rt.py; returns the number
    of launches."""
    launches = 0
    while True:
        pl.launch()
        launches += 1
        if not pl.is_running():
            return launches


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' fine-map caches in an empty directory of the test."""
    from icon_rt_tpu.data import bigscene as jbigscene
    from icon_rt_tpu_torch.data import bigscene
    monkeypatch.setattr(jbigscene, "_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(bigscene, "CACHE_DIR", str(tmp_path / "torch"))
    return tmp_path


def test_torch_app_quantized_matches_jax_app(caches):
    """--quantized (fine map on by default): the launch / is_running /
    present loop renders 4 samples in one launch, builds and caches the fine
    map, and the PNG agrees with the JAX app's per pixel within the quantized
    tracker's bound for the app's TF range (test_torch_fastq.py; measured
    here: 0 of 4096 pixels)."""
    out_t, out_j = str(caches / "tq"), str(caches / "jq")
    pl = app.build(["--device", "cpu", *ARGS, "--quantized", "-o", out_t])
    assert _run_loop(pl) == 1
    pl.present()
    q, loc, k_cap = pl.scene["get_q"]()
    assert q.value_q.dtype == torch.uint8 and loc.bins.shape[1] == k_cap
    assert pl.scene["fm"]() is not None and pl.scene["cells"] is None
    assert (caches / "torch" / "fmap_app_s3_l8_f2.npz").exists()
    assert icon_rt.main([*ARGS, "--quantized", "-o", out_j]) == 0
    img_t, img_j = read_png(out_t + ".png"), read_png(out_j + ".png")
    assert img_t.shape == img_j.shape == (64, 64, 4)
    differ = (img_t != img_j).any(axis=-1)
    assert differ.sum() <= APP_TF_MISMATCH_BOUND, differ.sum()
    assert (img_t[..., :3] != img_t[0, 0, :3]).any(axis=-1).sum() > 50


def test_torch_app_quantized_no_finemap_same_image(caches):
    """--no-finemap renders the same framebuffer, bit for bit, as the
    default two-stage locate (and builds no fine map); a TF edit re-bakes
    the alpha table against the edited transfer function."""
    from icon_rt_tpu_torch.models.qcells import _classify_alpha_table
    fbs = []
    for flag in ("--finemap", "--no-finemap"):
        pl = app.build(["--device", "cpu", *ARGS, "--quantized", flag,
                        "-o", str(caches / "x")])
        _run_loop(pl)
        assert (pl.scene["fm"]() is None) == (flag == "--no-finemap")
        fbs.append(pl.frame["fb"].clone())
    assert torch.equal(fbs[0], fbs[1])
    pl.set_ui_param("Opacity scale", 0.3)
    pl.is_running()
    q, _, _ = pl.scene["get_q"]()
    tab = _classify_alpha_table(pl.scene["tf"](), q.value_lo, q.value_hi)
    want = torch.floor(tab / torch.clamp(tab.max(), min=1e-8) * 255.0)
    assert np.array_equal(q.alpha_tab, want.to(torch.uint8).numpy())
    assert torch.equal(q.alpha_q, torch.from_numpy(q.alpha_tab)[
        q.value_q.long()])


def test_torch_app_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        app.build(["--device", "cuda", *ARGS])


def test_torch_app_help_and_missing_input(capsys):
    assert app.main(["--help"]) == 0
    assert "--device" in capsys.readouterr().out
    assert app.main(["--device", "cpu"]) == 1


def test_torch_app_tf_edit_rebakes(tmp_path):
    """An opacity-scale edit goes through the TFE dirty flags, resets the
    accumulation and re-bakes the rows (the scale-only K5c-f32 path, equal
    to a full K5a bake) and the band majorants (K5b) against the edited
    transfer function."""
    from icon_rt_tpu_torch.models.accel import compute_max_opacities_torch
    from icon_rt_tpu_torch.ops.fast import _profile_rows_torch
    pl = app.build(["--device", "cpu", *ARGS, "-o", str(tmp_path / "e")])
    pl.launch()
    pl.set_ui_param("Opacity scale", 0.3)
    assert not pl.is_running() or pl.frame_id == 0
    s = pl.scene
    tf = s["tf"]()
    assert float(tf.opacity_scale) == pytest.approx(0.3)
    c = s["cells"]
    prof, rgb = _profile_rows_torch(c.height, c.value, c.num_layers, tf)
    packed, bands = s["get_packed"](), s["get_bands"]()
    assert torch.equal(packed.prof, prof) and torch.equal(packed.rgb, rgb)
    assert torch.equal(bands.max_opacities, compute_max_opacities_torch(
        bands.value_ranges, tf.values, tf.value_range))


def test_torch_app_xf_file(tmp_path):
    """--xf loads a byte-compatible .xf transfer function (an opaque red
    LUT): the rendered globe is red."""
    from icon_rt_tpu_torch.pipeline.xf import save_xf
    xf = str(tmp_path / "t.xf")
    lut = np.tile(np.array([[1, 0, 0, 1.0]], np.float32), (8, 1))
    assert save_xf(xf, 1.0, (0.0, 1.0), (0.0, 1.0), lut)
    out = str(tmp_path / "red")
    assert app.main(["--device", "cpu", *ARGS, "--xf", xf, "-o", out]) == 0
    img = read_png(out + ".png")
    hit = (img[..., 0] > 200) & (img[..., 1] < 60) & (img[..., 2] < 60)
    assert hit.sum() > 50


#: per-pixel PNG mismatch bound of the --march app against the JAX app
#: (subdiv 3 x 8, 64x64, 2 passes), measured once: 0 of 4096 pixels on the
#: f32 tier and 0 on the quantized tier; the march's per-pixel accum bound
#: against JAX (tests/test_torch_march.py) moves an 8-bit channel only on
#: a rounding edge
MARCH_MISMATCH_BOUND = 4


@pytest.mark.parametrize("tier", [[], ["--quantized"]], ids=["f32", "q"])
def test_torch_app_march_matches_jax_app(caches, tier):
    """--march: each launch renders one converged pass (2 launches for
    --sample-limit 2), the quantized march without a fine map (none is
    built); the PNG agrees with the JAX app's per pixel within
    MARCH_MISMATCH_BOUND."""
    args = ["--synthetic", "3:8", "--size", "64", "64", "--sample-limit", "2",
            "--march", *tier]
    out_t, out_j = str(caches / "tm"), str(caches / "jm")
    pl = app.build(["--device", "cpu", *args, "-o", out_t])
    assert _run_loop(pl) == 2 and pl.frame_id == 2
    pl.present()
    if tier:
        assert pl.scene["fm"]() is None
    assert icon_rt.main([*args, "-o", out_j]) == 0
    img_t, img_j = read_png(out_t + ".png"), read_png(out_j + ".png")
    assert img_t.shape == img_j.shape == (64, 64, 4)
    differ = (img_t != img_j).any(axis=-1)
    assert differ.sum() <= MARCH_MISMATCH_BOUND, differ.sum()
    assert (img_t[..., :3] != img_t[0, 0, :3]).any(axis=-1).sum() > 50


def test_torch_app_scale_only_edit_skips_full_bake(tmp_path, monkeypatch):
    """After a curve edit (a full K5a bake), opacity-scale edits re-derive
    the baked alpha from parts baked once per LUT (K5c-f32) and run no full
    bake; the rows equal a full bake at every step."""
    from icon_rt_tpu_torch.ops import fast
    calls = {"bake": 0, "parts": 0}
    for name, key in (("classify_bake", "bake"),
                      ("pack_alpha_scale_parts", "parts")):
        orig = getattr(fast, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(fast, name, counted)
    pl = app.build(["--device", "cpu", *ARGS, "--march",
                    "-o", str(tmp_path / "s")])
    pl.launch()
    assert calls == {"bake": 1, "parts": 0}
    calls["bake"] = 0
    lut = pl.transfunc.get_lut()
    lut[:, 3] *= 0.5
    pl.transfunc.set_lut(lut)
    pl.transfunc_update_handler(pl.transfunc, pl.tf_index)
    assert calls == {"bake": 1, "parts": 0}
    s = pl.scene
    for v in (0.3, 2.0):
        pl.set_ui_param("Opacity scale", v)
        pl.is_running()
        tf = s["tf"]()
        prof, rgb = fast._profile_rows_torch(
            s["cells"].height, s["cells"].value, s["cells"].num_layers, tf)
        packed = s["get_packed"]()
        assert torch.equal(packed.prof, prof) and torch.equal(packed.rgb, rgb)
    assert calls == {"bake": 1, "parts": 1}
    pl.launch()
    assert torch.isfinite(pl.frame["accum"]).all()
