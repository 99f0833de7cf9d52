"""PyTorch port, the application: icon_rt_tpu_torch.app against
apps/icon_rt.py on the same arguments, its runtime mode toggles against
tests/test_toggles.py's contract, and its parse of every flag of the JAX
app."""
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


class _Clock:
    """A `time` module whose perf_counter advances 1e-4 s a call: both
    apps' --samples auto probes then pick 64 (the port's 33 ms budget and
    JAX's 40 s alike), clamped to --sample-limit."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-4
        return self.t


@pytest.mark.parametrize("flags", [["--preview", "4"], ["--samples", "auto"]])
def test_torch_app_out_of_slice_flags_raise(tmp_path, monkeypatch, flags):
    """The two flags that raised NotImplementedError until the preview tier
    and --samples auto were ported now render through the batch loop:
    --preview 4 (no reset in a batch run, so no preview frame: one launch
    of 4 samples) and --samples auto (launches of 1, 1 and 2 samples, the
    probe clocks pinned); the PNG agrees with the JAX app's within
    FB_MISMATCH_BOUND."""
    monkeypatch.setattr(app, "time", _Clock())
    monkeypatch.setattr(icon_rt, "time", _Clock())
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    pl = app.build(["--device", "cpu", *ARGS, *flags, "-o", out_t])
    assert _run_loop(pl) == (1 if flags[0] == "--preview" else 3)
    pl.present()
    assert icon_rt.main([*ARGS, *flags, "-o", out_j]) == 0
    img_t, img_j = read_png(out_t + ".png"), read_png(out_j + ".png")
    differ = (img_t != img_j).any(axis=-1)
    assert differ.sum() <= FB_MISMATCH_BOUND, differ.sum()
    assert (img_t[..., :3] != img_t[0, 0, :3]).any(axis=-1).sum() > 50


#: a value for every flag apps/icon_rt.py parses (its own and its
#: pipeline's), in the form it takes
FLAG_VALUES = {
    "--num-cells": ["40"], "--lat-range": ["-30:30"],
    "--lon-range": ["-90:90"], "-mode": ["2"], "--synthetic": ["2:4"],
    "--raygen": ["ae"], "--accel-mode": ["grid"], "--sampler": ["brute"],
    "-o": ["x.png"], "--quantized": [], "--finemap": [], "--march": [],
    "--preview": ["4"], "--no-finemap": [], "--samples": ["auto"],
}


def test_torch_app_parses_every_jax_flag():
    """Every flag string of apps/icon_rt.py's parse_app_args is parsed by
    the port's app without NotImplementedError, into the values JAX parses
    (`--samples 3` and `--preview -2` too); the port has no _NOT_PORTED."""
    import re
    with open(icon_rt.__file__) as f:
        src = f.read()
    body = src[src.index("def parse_app_args"):src.index("def main")]
    flags = set(re.findall(r'a == "(-[^"]+)"', body))
    assert flags == set(FLAG_VALUES), flags ^ set(FLAG_VALUES)
    assert not hasattr(app, "_NOT_PORTED")
    argvs = [[f, *v] for f, v in FLAG_VALUES.items()]
    argvs += [["--samples", "3"], ["--preview", "-2"], ["scene.ic"]]
    for argv in argvs:
        got, want = app.parse_app_args(argv), icon_rt.parse_app_args(argv)
        assert {k: got[k] for k in want} == want, argv


#: the AE raygen's wedge case: PARITY_ARGS's camera, frame and samples on
#: the subdivision-4 globe.  PARITY_ARGS's own subdivision 1 (triangles of
#: ~4000 km) puts the flat wedge faces up to ~300 km below its 30 km shell,
#: so the search window is the full 32 layers and the plain AE loop takes
#: ~400 s on the CPU; at subdivision 4 the window is 2 layers
WEDGE_AE_ARGS = ["--synthetic", "4:3", "--size", "16", "16",
                 "--sample-limit", "2", "--camera", "1.6e7", "0", "0", "0",
                 "0", "0", "0", "0", "1", "-fovy", "12"]
#: per-pixel PNG mismatch bound of the wedge paths against the JAX app;
#: measured 1 of 4096 pixels for -mode 2 and --sampler wedge (the fast
#: wedge tier, a libm ULP as in test_torch_fast.py) and 0 of 256 for the
#: AE case.  The Newton inversion at the globe's scale converges on f32
#: noise (coordinates of ~6e6 m have an ULP of 0.5 m, layers are ~4 km
#: thick, so t moves by ~1e-4 per ULP, the convergence threshold), and
#: JAX's FMA-contracted sums walk other noise: 2.4% of random shell points
#: at subdivision 3 x 8 change their hit, so the AE bound allows 3%
WEDGE_MISMATCH = {"fast": FB_MISMATCH_BOUND, "ae": 8}
#: the JAX app's wedge images by path, rendered once per module
_JAX_WEDGE_PNG = {}


@pytest.mark.parametrize("flags", [
    ["--sampler", "wedge"], ["-mode", "2"], ["--raygen", "ae", "-mode", "2"]],
    ids=["sampler-wedge", "mode-2", "ae-mode-2"])
def test_torch_app_wedge_flags_render(tmp_path, flags):
    """The wedge sampler renders where it used to raise: on the fast
    raygen the wedge tier (K9-w's plain version, --samples 8 clamped to
    --sample-limit 4: one launch), on --raygen ae the Newton wedge sampler
    (K9-p's plain version, one sample per launch); the PNG agrees with the
    JAX app's within WEDGE_MISMATCH pixels and is not blank."""
    ae = flags[0] == "--raygen"
    args = WEDGE_AE_ARGS if ae else ARGS
    out_t, out_j = str(tmp_path / "tw"), str(tmp_path / "jw")
    pl = app.build(["--device", "cpu", *args, *flags, "-o", out_t])
    assert _run_loop(pl) == (2 if ae else 1)
    pl.present()
    built = pl.scene["timings"]
    assert ("wedges_s" in built) == ae
    assert ("packed_w_s" in built and "bands_w_s" in built) == (not ae)
    # -mode 2 and --sampler wedge select the same JAX path: render it once
    key = "ae" if ae else "fast"
    if key not in _JAX_WEDGE_PNG:
        assert icon_rt.main([*args, *flags, "-o", out_j]) == 0
        _JAX_WEDGE_PNG[key] = read_png(out_j + ".png")
    img_t, img_j = read_png(out_t + ".png"), _JAX_WEDGE_PNG[key]
    assert img_t.shape == img_j.shape
    differ = (img_t != img_j).any(axis=-1)
    assert differ.sum() <= WEDGE_MISMATCH["ae" if ae else "fast"], \
        differ.sum()
    assert (img_t[..., :3] != img_t[0, 0, :3]).any(axis=-1).sum() > 50


def test_torch_app_wedge_precedence_and_tf_edit(tmp_path):
    """apps/icon_rt.py:480-518: --march with the wedge sampler renders the
    wedge tracker (K9-w), --quantized takes precedence over it; a TF edit
    refreshes the wedge tier's band majorants (K5b) and bakes its rows
    again in full (pack_cells_wedge)."""
    from icon_rt_tpu_torch.models.accel import compute_max_opacities_torch
    from icon_rt_tpu_torch.ops import fast
    small = ["--synthetic", "2:4", "--size", "24", "24", "--sample-limit",
             "2", "-o", str(tmp_path / "p")]
    pl = app.build(["--device", "cpu", *small, "-mode", "2", "--march"])
    _run_loop(pl)
    assert pl.samples_per_launch == 2 and pl.frame_id == 2   # the tracker
    packed = pl.scene["get_packed_wedge"]()
    assert packed.test.shape[1] == fast.TEST_W_WEDGE
    pl.set_ui_param("Opacity scale", 0.5)
    pl.is_running()
    tf = pl.scene["tf"]()
    packed2 = pl.scene["get_packed_wedge"]()
    assert packed2 is not packed
    want = fast.pack_cells_wedge(pl.scene["cells"], tf)
    assert torch.equal(packed2.prof, want.prof)
    bw = pl.scene["get_bands_wedge"]()
    assert torch.equal(bw.max_opacities, compute_max_opacities_torch(
        bw.value_ranges, tf.values, tf.value_range))
    pl = app.build(["--device", "cpu", *small, "-mode", "2", "--quantized",
                    "--no-finemap"])
    _run_loop(pl)
    assert pl.scene["cells"] is None and "packed_w_s" not in \
        pl.scene["timings"]


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


#: the parity app tests' scene: subdiv 1 x 3 seen along the x axis through
#: a 12-degree field, so every ray meets the globe within ~300 free paths
#: of the app's unit distance (1e3 m) and the CPU renders stay short
PARITY_ARGS = ["--synthetic", "1:3", "--size", "16", "16", "--sample-limit",
               "2", "--camera", "1.6e7", "0", "0", "0", "0", "0", "0", "0",
               "1", "-fovy", "12"]
#: per-pixel PNG mismatch bound of the parity app against the JAX app
#: after 2 samples; measured 0 of 256 pixels for every case below (the
#: parity raygens' libm-ULP argument of tests/test_torch_parity.py)
PARITY_MISMATCH_BOUND = 2


@pytest.mark.parametrize("flags", [
    ["--raygen", "ae"], ["--raygen", "accel", "--accel-mode", "grid"],
    ["--raygen", "accel"], ["--raygen", "ae", "--sampler", "brute"]],
    ids=["ae", "accel-grid", "accel-sphere", "ae-brute"])
def test_torch_app_parity_matches_jax_app(tmp_path, flags):
    """--raygen ae / accel (sphere and grid) and --sampler brute: one
    sample per launch in natural pixel order, so 2 launches for
    --sample-limit 2; the PNG agrees with the JAX app's within
    PARITY_MISMATCH_BOUND pixels."""
    out_t, out_j = str(tmp_path / "tp"), str(tmp_path / "jp")
    pl = app.build(["--device", "cpu", *PARITY_ARGS, *flags, "-o", out_t])
    assert _run_loop(pl) == 2 and pl.frame_id == 2
    pl.present()
    assert pl.frame["raygen"] == flags[1] and pl.frame["perm"] is None
    assert icon_rt.main([*PARITY_ARGS, *flags, "-o", out_j]) == 0
    img_t, img_j = read_png(out_t + ".png"), read_png(out_j + ".png")
    assert img_t.shape == img_j.shape == (16, 16, 4)
    differ = (img_t != img_j).any(axis=-1)
    assert differ.sum() <= PARITY_MISMATCH_BOUND, differ.sum()
    assert (img_t[..., :3] != img_t[0, 0, :3]).any(axis=-1).sum() > 20


@pytest.fixture()
def spy(monkeypatch):
    """The render function each frame dispatches to."""
    from icon_rt_tpu_torch.ops import fast, render

    class Calls(list):
        """Names of the calls, and in `samplers` each call's sampler."""
        samplers: list

    calls = Calls()
    calls.samplers = []
    for mod, name in ((fast, "render_frame_fast"),
                      (render, "render_frame_accel"),
                      (render, "render_frame_ae")):
        orig = getattr(mod, name)

        def wrapper(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            calls.samplers.append(k.get("sampler", "locator"))
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)
    return calls


def _toggle_app(tmp_path, *extra):
    """A semi-transparent blue-to-red ramp (alpha 0.3; tests/test_toggles.py
    uses 0.02 at its wider view), so the paths collide in different layers
    and their images differ, on the parity scene; at 0.3 nearly every ray
    stops inside the front shell, which keeps the CPU renders short."""
    from icon_rt_tpu_torch.pipeline.xf import save_xf
    xf = str(tmp_path / "ramp.xf")
    lut = np.stack([np.linspace(0, 1, 16, dtype=np.float32),
                    np.zeros(16, np.float32),
                    np.linspace(1, 0, 16, dtype=np.float32),
                    np.full(16, 0.3, np.float32)], axis=1)
    save_xf(xf, 1.0, (0.0, 1.0), (0.0, 1.0), lut)
    out = str(tmp_path / "t")
    pl = app.build(["--device", "cpu", *PARITY_ARGS, "--sample-limit", "99",
                    "--xf", xf, "-o", out, *extra])
    return pl, out


def _frame(pl, out):
    pl.launch()
    pl.present()
    return read_png(out + ".png").astype(np.int32)


def test_torch_app_raygen_toggle(tmp_path, spy):
    """"Raygen" swaps the path and resets accumulation; the fast raygen
    renders a batch of samples per launch, the parity raygens one, and the
    image's footprint survives the swap back to the permuted fast layout
    (tests/test_toggles.py::test_raygen_toggle_changes_image_and_resets)."""
    pl, out = _toggle_app(tmp_path)
    img_fast = _frame(pl, out)
    assert spy[-1] == "render_frame_fast"
    assert pl.is_running() and pl.frame_id == pl.samples_per_launch > 1
    pl.set_ui_param("Raygen", "ae")
    assert pl.frame_id == 0
    img_ae = _frame(pl, out)
    assert spy[-1] == "render_frame_ae" and pl.samples_per_launch == 1
    assert (img_ae[..., 3] > 0).any() and (img_fast != img_ae).any()
    pl.set_ui_param("Raygen", "accel")
    img_accel = _frame(pl, out)
    assert spy[-1] == "render_frame_accel" and (img_accel[..., 3] > 0).any()
    pl.set_ui_param("Raygen", "fast")
    img_fast2 = _frame(pl, out)
    assert spy[-1] == "render_frame_fast"
    assert ((img_fast[..., 3] > 0) == (img_fast2[..., 3] > 0)).mean() > 0.9


def test_torch_app_accel_mode_and_naive_toggles(tmp_path, spy):
    """"Accel mode" swaps sphere and grid (a different majorant
    segmentation, so other collisions) and resets accumulation; "Use naive
    accel" off renders the accel raygen as AE; "Sampler mode" 2 resets
    accumulation and renders through the wedge sampler (shown on the fast
    raygen's wedge tier: this scene's 32-layer search window makes the
    parity raygens' Newton loop take minutes on the CPU, see
    WEDGE_AE_ARGS), 0 goes back to the locator."""
    pl, out = _toggle_app(tmp_path, "--raygen", "accel", "--samples", "2")
    img_sphere = _frame(pl, out)
    assert spy[-1] == "render_frame_accel"
    assert pl.scene["get_accel"]("sphere") is not None
    pl.set_ui_param("Accel mode", "grid")
    assert pl.frame_id == 0
    img_grid = _frame(pl, out)
    assert spy[-1] == "render_frame_accel"
    assert (img_grid[..., 3] > 0).any() and (img_sphere != img_grid).any()
    pl.set_ui_param("Use naive accel", False)
    _frame(pl, out)
    assert spy[-1] == "render_frame_ae"
    assert spy.samplers[-1] == "locator"
    assert pl.is_running() and pl.frame_id == 1
    pl.set_ui_param("Sampler mode", 2)
    assert pl.frame_id == 0
    pl.set_ui_param("Raygen", "fast")
    img_wedge = _frame(pl, out)
    assert spy[-1] == "render_frame_fast" and spy.samplers[-1] == "wedge"
    assert pl.is_running() and pl.frame_id == pl.samples_per_launch > 1
    assert (img_wedge[..., 3] > 0).any()
    pl.set_ui_param("Sampler mode", 0)
    pl.set_ui_param("Raygen", "accel")
    _frame(pl, out)
    assert spy[-1] == "render_frame_ae" and spy.samplers[-1] == "locator"
    # a TF edit refreshes both built accels' majorants (K5b)
    pl.set_ui_param("Opacity scale", 0.5)
    pl.is_running()
    tf = pl.scene["tf"]()
    from icon_rt_tpu_torch.models.accel import compute_max_opacities_torch
    for mode in ("sphere", "grid"):
        a = pl.scene["get_accel"](mode)
        assert torch.equal(a.max_opacities, compute_max_opacities_torch(
            a.value_ranges, tf.values, tf.value_range))
