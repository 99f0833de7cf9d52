"""The render pipeline: frame loop, CLI flags, UI-parameter registry,
timing, transfer-function plumbing and batch PNG output.

Functional port of the reference Pipeline contract
(ref: common/pipeline.h:53-147, pipeline.cu):
  * two-tier CLI: common flags --bgcolor / --sample-limit / --xf /
    -win|--win|--size / -fovy / --camera here, app flags in the app
    (ref: pipeline.cu:224-253);
  * accumulation-reset rules: any camera/TF/uiParam change restarts
    progressive accumulation (ref: pipeline.cu:1007-1034);
  * uiParam registry (bool/float/vec3/select) whose mutations reset
    accumulation (ref: pipeline.cu:953-989 + 642-717);
  * EWMA frame timing avg = 0.8*avg + 0.2*dt (ref: pipeline.cu:581-606);
  * batch mode renders `sampleLimit` frames then writes '<name>.png' and
    prints FPS (ref: pipeline.cu:733-740);
  * .xf load on --xf, save via save_transfunc (Shift+T parity,
    ref: pipeline.cu:563-568); camera pose exportable as CLI args
    (Shift+C parity — Camera.to_cli_string).

Instead of the reference's OWL name->pointer launch-params registry
(ref: pipeline.cu:357-411), the app supplies a render callback that builds
the current LaunchParams itself.

The preview tier (`preview_scale`, `preview_pending`) is the JAX
pipeline's.  `is_running` advances `frame_id` by the samples the last
launch rendered, once, and not over a reset since that launch: a preview
launch (samples_per_launch 0) leaves `frame_id` at 0, so the next launch
does frame 0's work (a new accumulator, the rays re-sorted).  The JAX
pipeline advances by max(1, samples_per_launch) on every call
(icon_rt_tpu/pipeline/pipeline.py:236-244), which skips that work after a
preview and, in its viewer's loop, after any reset.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models.transfunc import DEFAULT_LUT_SIZE, Transfunc, make_transfunc, resample_lut
from ..ops.camera import Camera
from ..utils.png import write_png
from . import xf as xfio
from .tfe import TFE

F = np.float32


class TransfuncState:
    """Host-side mutable transfer function (ref: common/transfunc.h)."""

    def __init__(self, lut=None, value_range=(0.0, 1.0), opacity=1.0,
                 rel_range=(0.0, 1.0)):
        self.opacity = float(opacity)
        self.value_range = np.asarray(value_range, F)
        self.rel_range = np.asarray(rel_range, F)
        self.lut = (np.asarray(lut, F).reshape(-1, 4) if lut is not None
                    else np.zeros((0, 4), F))

    def set_lut(self, lut):
        self.lut = np.asarray(lut, F).reshape(-1, 4)

    def get_lut(self):
        return self.lut.copy()

    @property
    def size(self):
        return self.lut.shape[0]

    def to_device(self, size: int = DEFAULT_LUT_SIZE,
                  device="cpu") -> Transfunc:
        """Device transfer function; LUTs below `size` are resampled so the
        device shape stays static across edits (batch-mode parity,
        ref: pipeline.cu:469-473)."""
        lut = self.lut
        if lut.shape[0] < size:
            lut = resample_lut(lut, size)
        return make_transfunc(lut, tuple(self.value_range), self.opacity,
                              tuple(self.rel_range), size=lut.shape[0],
                              device=device)


class UIParam:
    BOOL, FLOAT, VEC3F, SELECT = range(4)

    def __init__(self, name, kind, get, set_, meta):
        self.name, self.kind, self.get, self.set, self.meta = \
            name, kind, get, set_, meta


class Pipeline:
    """Headless frame-loop runtime; interactive front-ends drive the same
    object through `handle_*` methods and `tfe`."""

    def __init__(self, argv=(), name: str = "icon_rt"):
        self.name = name
        self.width = 512
        self.height = 512
        self.bgcolor = np.array([0.1, 0.1, 0.1], F)
        self.sample_limit = 1
        self.frame_id = 0
        #: progressive samples one render_fn call accumulates (the fast
        #: raygen renders several per launch, ops/fast.py `samples=`); the
        #: render fn sets it per call
        self.samples_per_launch = 1
        #: preview tier: when > 1, the first launch after an accumulation
        #: reset (camera, TF, uiParam) may render at (width // scale,
        #: height // scale) and present that frame upscaled; the render fn
        #: checks `preview_pending`, clears it and sets samples_per_launch
        #: to 0, so the full-res sample 0 renders on the next launch
        self.preview_scale = 0
        self.preview_pending = False
        #: samples the last launch accumulated that is_running has yet to
        #: count (0 after a reset)
        self._rendered = 0
        self.running = False
        self._started = False
        self.avg_t = 0.0
        self._t_last = None
        self.camera: Optional[Camera] = None
        self.transfuncs: list[Optional[TransfuncState]] = []
        self.tfes: list[Optional[TFE]] = []
        self.tf_index = 0  # active editor tab (ref: pipeline.cu:645-668)
        self.transfunc_update_handler: Optional[Callable] = None
        self.render_fn: Optional[Callable] = None
        self.present_fn: Optional[Callable] = None
        self.ui_params: list[UIParam] = []
        self._cmdline_cam = None
        self._cmdline_size = None
        self.xf_file = None
        self.interactive = False
        self._parse_command_line(list(argv))
        if self.xf_file:
            loaded = xfio.load_xf(self.xf_file)
            if loaded:
                op, vr, rr, lut = loaded
                self.transfuncs = [TransfuncState(lut, vr, op, rr)]
                self.tfes = [None]
                tfe = TFE()
                tf0 = self.transfuncs[0]
                tfe.init_from(tf0.opacity, tf0.value_range, tf0.rel_range,
                              tf0.lut)
                self.tfes[0] = tfe

    # -- CLI (ref: pipeline.cu:224-253) -------------------------------------
    def _parse_command_line(self, argv):
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "--bgcolor":
                self.bgcolor = np.array([float(argv[i + 1]), float(argv[i + 2]),
                                         float(argv[i + 3])], F)
                i += 3
            elif a == "--sample-limit":
                self.sample_limit = int(argv[i + 1]); i += 1
            elif a == "--xf":
                self.xf_file = argv[i + 1]; i += 1
            elif a in ("-win", "--win", "--size"):
                self._cmdline_size = (int(argv[i + 1]), int(argv[i + 2])); i += 2
            elif a == "-fovy":
                self._cmdline_cam = self._cmdline_cam or {}
                self._cmdline_cam["fovy"] = float(argv[i + 1]); i += 1
            elif a == "--camera":
                vals = [float(argv[i + 1 + k]) for k in range(9)]
                self._cmdline_cam = self._cmdline_cam or {}
                self._cmdline_cam["vp"] = vals[0:3]
                self._cmdline_cam["vi"] = vals[3:6]
                self._cmdline_cam["vu"] = vals[6:9]
                i += 9
            i += 1

    # -- wiring --------------------------------------------------------------
    def set_frame(self, width: int, height: int):
        if self._cmdline_size:
            width, height = self._cmdline_size
        self.width, self.height = width, height

    def set_camera(self, cam: Camera):
        self.camera = cam
        if self._cmdline_cam and "vu" in self._cmdline_cam:
            fovy = self._cmdline_cam.get("fovy", 0.0)
            if fovy < 1e-3:
                fovy = 90.0
            cam.set_orientation(self._cmdline_cam["vp"], self._cmdline_cam["vi"],
                                self._cmdline_cam["vu"], np.deg2rad(fovy))
        elif self._cmdline_cam and "fovy" in self._cmdline_cam:
            cam.fovy = F(np.deg2rad(self._cmdline_cam["fovy"]))

    @property
    def transfunc(self) -> Optional[TransfuncState]:
        return self.transfuncs[self.tf_index] if self.transfuncs else None

    @property
    def tfe(self) -> Optional[TFE]:
        return self.tfes[self.tf_index] if self.tfes else None

    def transfunc_valid(self, index: int = 0) -> bool:
        return (index < len(self.transfuncs)
                and self.transfuncs[index] is not None
                and self.transfuncs[index].size > 0)

    def set_transfunc(self, tf: TransfuncState, index: int = 0):
        """Install a transfer function at a slot; multiple slots surface as
        editor tabs in the reference UI (ref: pipeline.cu:456-478,645-668)."""
        while len(self.transfuncs) <= index:
            self.transfuncs.append(None)
            self.tfes.append(None)
        self.transfuncs[index] = tf
        if tf.size < 300 and not self.interactive:
            tf.set_lut(resample_lut(tf.lut, 300))
        tfe = TFE()
        tfe.init_from(tf.opacity, tf.value_range, tf.rel_range, tf.lut)
        self.tfes[index] = tfe
        if self.transfunc_update_handler:
            self.transfunc_update_handler(tf, index)

    def set_transfunc_update_handler(self, fn: Callable):
        self.transfunc_update_handler = fn

    def set_render_fn(self, fn: Callable):
        """fn(frame_id) must render progressive samples and return the
        packed (H*W,) framebuffer (an int32 tensor holding the u32 bits,
        on the render device, or a host array)."""
        self.render_fn = fn

    # -- uiParam registry (ref: pipeline.h:122-125) --------------------------
    def ui_param(self, name, get, set_, kind=UIParam.FLOAT, **meta):
        self.ui_params.append(UIParam(name, kind, get, set_, meta))

    def set_ui_param(self, name, value):
        """Programmatic widget mutation; resets accumulation like the ImGui
        sliders do (ref: pipeline.cu:953-989)."""
        for p in self.ui_params:
            if p.name == name:
                p.set(value)
                self.reset_accumulation()
                return True
        raise KeyError(name)

    # -- frame loop ----------------------------------------------------------
    def reset_accumulation(self):
        self.frame_id = 0
        self.preview_pending = self.preview_scale > 1
        self._rendered = 0

    def is_running(self) -> bool:
        if not self._started:
            return False
        if self._harvest_tfe():
            self.reset_accumulation()
        self.frame_id += self._rendered
        self._rendered = 0
        # batch mode renders exactly sample_limit progressive frames with
        # accum ids 0..sample_limit-1 (the reference's double-increment on
        # the first launch makes it render sampleLimit-2 frames and skip
        # accumID 1, ref: pipeline.cu:991-1036 + 1038-1049 — we keep the
        # sane semantics rather than the off-by-two quirk)
        if not self.interactive:
            self.running = self.frame_id < self.sample_limit
        return self.running

    def _harvest_tfe(self) -> bool:
        """TFE dirty-flag harvest of the ACTIVE tab
        (ref: pipeline.cu:1013-1028)."""
        tfe, tf = self.tfe, self.transfunc
        if tfe is None or tf is None:
            return False
        reset = False
        if tfe.lut_updated():
            tf.set_lut(tfe.get_lut())
            reset = True
        if tfe.range_updated():
            tf.value_range = tfe.get_range()
            reset = True
        if tfe.scale_updated():
            tf.opacity = tfe.get_opacity_scale()
            reset = True
        if reset and self.transfunc_update_handler:
            self.transfunc_update_handler(tf, self.tf_index)
        return reset

    def launch(self):
        if self.render_fn is None or self.camera is None:
            raise RuntimeError("Pipeline invalid (no render fn / camera)")
        if not self._started:
            self._started = True
            self.running = True
            if self.transfunc_update_handler:
                # fire once per slot so majorants exist before frame 0
                # (ref: pipeline.cu:262-265)
                for i, tf in enumerate(self.transfuncs):
                    if tf is not None:
                        self.transfunc_update_handler(tf, i)
        t0 = time.perf_counter()
        if self.frame_id < self.sample_limit:
            self._last_fb = self.render_fn(self.frame_id)
            self._rendered = max(0, int(self.samples_per_launch))
        dt = time.perf_counter() - t0
        self.avg_t = 0.8 * self.avg_t + 0.2 * dt if self.avg_t > 0 else dt

    def present(self):
        fb = self._last_fb
        fb = fb.cpu().numpy() if isinstance(fb, torch.Tensor) else \
            np.asarray(fb)
        if self.present_fn is not None:
            self.present_fn(fb, self.width, self.height)
            return
        self.write_frame(fb)

    def write_frame(self, fb: np.ndarray):
        """Batch-mode output: PNG + FPS (ref: pipeline.cu:733-740).
        Never-hit pixels show --bgcolor, like the reference's cleared
        presentation canvas (ref: pipeline.cu:721,760)."""
        from ..ops.render import fb_to_image
        img = fb_to_image(fb, self.width, self.height, bgcolor=self.bgcolor)
        out = f"{self.name}.png"
        write_png(out, img)
        print(f"Output: {out}")
        print(f"FPS: {1.0 / max(self.avg_t, 1e-8):.2f}")

    # -- key events (ref: pipeline.cu:535-579) -------------------------------
    def set_key_down_handler(self, fn: Callable):
        """App key hook, called for keys the pipeline doesn't consume
        (ref: pipeline.h setKeyDownHandler)."""
        self.key_down_handler = fn

    def handle_key(self, key: str, shift: bool = False):
        """Built-in keys: Shift+C prints the camera as reproducible CLI
        args (ref: pipeline.cu:543-562); Shift+T saves the transfer
        function (ref: :563-568).  Everything else goes to the app hook."""
        if shift and key.lower() == "c" and self.camera is not None:
            print(self.camera_cli_string())
            return True
        if shift and key.lower() == "t" and self.transfunc is not None:
            self.save_transfunc(f"{self.name}.xf")
            print(f"Output: {self.name}.xf")
            return True
        handler = getattr(self, "key_down_handler", None)
        if handler is not None:
            return bool(handler(key, shift))
        return False

    # -- state artifacts -----------------------------------------------------
    def save_transfunc(self, path: str) -> bool:
        """Shift+T parity (ref: pipeline.cu:563-568)."""
        tf = self.transfunc
        return xfio.save_xf(path, tf.opacity, tf.value_range, tf.rel_range,
                            tf.lut)

    def camera_cli_string(self) -> str:
        """Shift+C parity (ref: pipeline.cu:543-562)."""
        return self.camera.to_cli_string()
