"""Transfer-function editor: host-side LUT editing state machine with the
reference's interaction semantics, decoupled from any GUI toolkit.

Port of AlphaEditor/TFE (ref: common/alpha_editor.h/.cpp, tfe.h/.cpp):
  * a canvas-resolution RGBA LUT resampled from the user LUT
    (resampleOriginalLUT, alpha_editor.cpp:203-208);
  * freehand alpha drawing with linear gap interpolation between mouse
    events that skipped columns (alpha_editor.cpp:263-320);
  * log-normalized histogram overlay (alpha_editor.cpp:209-234);
  * dirty flags lutUpdated/rangeUpdated/scaleUpdated harvested by the
    pipeline each frame (ref: common/pipeline.cu:1013-1028);
  * TFE adds drag-editable absolute value range / relative range / opacity
    scale (ref: common/tfe.cpp:29-50).

The pipeline feeds abstract mouse events; `rasterize()` renders the widget
(LUT strip + alpha curve + histogram) to an RGBA image for offscreen/
headless parity.
"""
from __future__ import annotations

import numpy as np

from ..models.transfunc import resample_lut

F = np.float32


class MouseEvent:
    NONE, LEFT, MIDDLE, RIGHT = 0, 1, 2, 3
    PASSIVE_MOTION, MOTION, PRESS, RELEASE = 0, 1, 2, 3

    def __init__(self, x, y, button=NONE, etype=PASSIVE_MOTION):
        self.x, self.y, self.button, self.type = x, y, button, etype


class AlphaEditor:
    """Freehand alpha-curve editor over a canvas-resolution LUT."""

    def __init__(self, canvas=(300, 150)):
        self.canvas_w, self.canvas_h = canvas
        self.user_lut = np.zeros((0, 4), F)
        self.lut = np.zeros((self.canvas_w, 4), F)
        self.zoom_min, self.zoom_max = 0.0, 1.0
        self.histogram = None
        self.normalized_histogram = None
        self.drawing = False
        self.last_event = MouseEvent(0, 0)
        self.lut_changed = False

    # -- state ------------------------------------------------------------
    def set_lut(self, lut: np.ndarray):
        """Install a user LUT; the editing copy is resampled to canvas width
        (ref: alpha_editor.cpp:203-208)."""
        self.user_lut = np.asarray(lut, F).reshape(-1, 4)
        self.lut = resample_lut(self.user_lut, self.canvas_w)
        self.lut_changed = True

    def get_lut(self) -> np.ndarray:
        return self.lut.copy()

    def set_histogram(self, counts):
        """Log-normalize bin counts to canvas height (ref: :209-234)."""
        counts = np.asarray(counts)
        self.histogram = counts
        m = counts.max() if counts.size else 0
        if m == 0:
            self.normalized_histogram = np.zeros_like(counts)
        else:
            with np.errstate(divide="ignore"):
                cf = np.log(counts.astype(np.float64)) / np.log(float(m))
            cf = np.where(np.isfinite(cf), cf, 0.0)
            self.normalized_histogram = (cf * self.canvas_h).astype(np.int64)

    def lut_updated(self) -> bool:
        """Dirty-flag harvest; clears the flag (ref: alpha_editor.h)."""
        ch, self.lut_changed = self.lut_changed, False
        return ch

    # -- interaction --------------------------------------------------------
    def _zoom(self, x: int) -> int:
        """Canvas x -> LUT index under the current zoom window
        (ref: alpha_editor.cpp:283-289)."""
        dims = self.lut.shape[0]
        f = x / float(self.canvas_w - 1)
        f = f * (self.zoom_max - self.zoom_min) + self.zoom_min
        return int(f * (dims - 1))

    def handle_mouse_event(self, event: MouseEvent, hovered: bool = True):
        """ref: alpha_editor.cpp:263-320 — draws when pressed/dragging,
        interpolating alphas across skipped columns."""
        if event.type in (MouseEvent.PASSIVE_MOTION, MouseEvent.RELEASE):
            self.drawing = False

        if self.drawing or (event.type == MouseEvent.PRESS and hovered
                            and event.button == MouseEvent.LEFT):
            this_x = int(np.clip(event.x, 0, self.canvas_w - 1))
            this_y = int(np.clip(event.y, 0, self.canvas_h - 1))
            last_x = int(np.clip(self.last_event.x, 0, self.canvas_w - 1))

            zi = self._zoom(this_x)
            self.lut[zi, 3] = this_y / float(self.canvas_h - 1)

            if self.last_event.button == MouseEvent.LEFT and abs(last_x - this_x) > 1:
                zl = self._zoom(last_x)
                if last_x < this_x:
                    a1, a2 = self.lut[zl, 3], self.lut[zi, 3]
                else:
                    a1, a2 = self.lut[zi, 3], self.lut[zl, 3]
                inc = 1 if self.last_event.x < event.x else -1
                x = zl + inc
                while x != zi:
                    frac = (zi - x) / float(abs(zi - zl))
                    # reference lerp(a,b,x) = x*a + (1-x)*b
                    self.lut[x, 3] = frac * a1 + (1.0 - frac) * a2
                    x += inc
            self.lut_changed = True
            self.drawing = True

        self.last_event = event

    def draw_stroke(self, points):
        """Convenience: feed a PRESS + MOTION* + RELEASE stroke of
        (x, y) canvas points (y up, 0 = alpha 0)."""
        for i, (x, y) in enumerate(points):
            etype = MouseEvent.PRESS if i == 0 else MouseEvent.MOTION
            self.handle_mouse_event(MouseEvent(x, y, MouseEvent.LEFT, etype))
        lx, ly = points[-1]
        self.handle_mouse_event(MouseEvent(lx, ly, MouseEvent.NONE,
                                           MouseEvent.RELEASE))

    # -- offscreen widget --------------------------------------------------
    def rasterize(self) -> np.ndarray:
        """Render the widget to (H, W, 4) uint8 (row 0 = top): LUT strip
        colors below the alpha curve, histogram behind
        (ref: alpha_editor.cpp:119-201 paints the same elements)."""
        w, h = self.canvas_w, self.canvas_h
        img = np.zeros((h, w, 4), np.uint8)
        img[..., 3] = 255
        lut_w = self.lut.shape[0]
        xs = np.minimum((np.arange(w) / max(w - 1, 1) * (self.zoom_max - self.zoom_min)
                         + self.zoom_min) * (lut_w - 1), lut_w - 1).astype(np.int64)
        rgba = self.lut[xs]
        alpha_y = (rgba[:, 3] * (h - 1)).astype(np.int64)
        if self.normalized_histogram is not None and len(self.normalized_histogram):
            hx = np.minimum((np.arange(w) * len(self.normalized_histogram)) // w,
                            len(self.normalized_histogram) - 1)
            hh = np.clip(self.normalized_histogram[hx], 0, h)
            for x in range(w):
                img[h - hh[x]:, x, :3] = 64
        for x in range(w):
            y = alpha_y[x]
            col = np.clip(rgba[x, :3] * 255.0, 0, 255).astype(np.uint8)
            img[h - 1 - y:, x, :3] = col  # fill under the curve
            img[h - 1 - y, x, :3] = 255   # curve line
        return img


class TFE(AlphaEditor):
    """AlphaEditor + drag-editable ranges (ref: common/tfe.h:24-68)."""

    def __init__(self, canvas=(300, 150)):
        super().__init__(canvas)
        self.value_range = np.array([0.0, 1.0], F)
        self.rel_range = np.array([0.0, 1.0], F)
        self.opacity_scale = 1.0
        self.range_changed = False
        self.scale_changed = False

    def init_from(self, opacity, value_range, rel_range, lut):
        self.opacity_scale = float(opacity)
        self.value_range = np.asarray(value_range, F).copy()
        self.rel_range = np.asarray(rel_range, F).copy()
        self.set_lut(lut)
        self.lut_changed = False

    def set_range(self, lo, hi):
        self.value_range = np.array([lo, hi], F)
        self.range_changed = True

    def set_opacity_scale(self, s):
        self.opacity_scale = float(s)
        self.scale_changed = True

    def get_range(self):
        return self.value_range.copy()

    def get_opacity_scale(self):
        return self.opacity_scale

    def range_updated(self) -> bool:
        ch, self.range_changed = self.range_changed, False
        return ch

    def scale_updated(self) -> bool:
        ch, self.scale_changed = self.scale_changed, False
        return ch
