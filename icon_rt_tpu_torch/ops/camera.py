"""Pinhole camera + interactive manipulator (host-side, numpy float32).

Port of the reference camera model (ref: common/camera.h:28-114): the pose
is position/up/distance/fovy plus an orthonormal frame with NEGATIVE-z view
direction; `get_screen` emits the screen basis (lower_left, horizontal,
vertical) from which per-pixel ray directions are
    dir = lower_left + (x+jit)/W * horizontal + (y+jit)/H * vertical.

CameraManip ports the arcball rotate / pan / dolly interactions
(ref: common/camera.h:120-236) so interactive parity doesn't depend on any
GUI toolkit — the pipeline feeds it abstract mouse events.
"""
from __future__ import annotations

import numpy as np

F = np.float32


def _norm(v):
    return v / np.sqrt(np.sum(v * v, dtype=F))


class Camera:
    def __init__(self):
        self.position = np.zeros(3, F)
        self.up_vector = np.array([0, 1, 0], F)
        self.distance = F(1.0)
        self.fovy = F(90.0 * np.pi / 180.0)
        self.aspect = F(1.0)
        self.vx = np.array([1, 0, 0], F)
        self.vy = np.array([0, 1, 0], F)
        self.vz = np.array([0, 0, 1], F)

    def set_aspect(self, a: float):
        self.aspect = F(a)

    def set_orientation(self, origin, poi, up, fovy):
        origin = np.asarray(origin, F)
        poi = np.asarray(poi, F)
        up = np.asarray(up, F)
        self.position = origin
        self.up_vector = up
        self.fovy = F(fovy)
        if np.all(poi == origin):
            self.vz = np.array([0, 0, 1], F)
        else:
            self.vz = -_norm(poi - origin)  # negative z axis
        vx = np.cross(up, self.vz).astype(F)
        if np.dot(vx, vx) < 1e-8:
            self.vx = np.array([0, 1, 0], F)
        else:
            self.vx = _norm(vx)
        self.vy = _norm(np.cross(self.vz, self.vx).astype(F))
        self.distance = F(np.sqrt(np.sum((poi - origin) ** 2, dtype=F)))
        self.force_up_frame()

    def force_up_frame(self):
        if abs(np.dot(self.vz, self.up_vector)) < 1e-6:
            return
        self.vx = _norm(np.cross(self.up_vector, self.vz).astype(F))
        self.vy = _norm(np.cross(self.vz, self.vx).astype(F))

    def get_poi(self):
        return self.position - self.vz * self.distance

    def get_fovy_degrees(self):
        return float(self.fovy) / np.pi * 180.0

    def get_screen(self):
        screen_height = F(2.0 * np.tan(0.5 * self.fovy))
        vertical = screen_height * self.vy
        horizontal = screen_height * self.aspect * self.vx
        lower_left = -self.vz - F(0.5) * vertical - F(0.5) * horizontal
        return lower_left.astype(F), horizontal.astype(F), vertical.astype(F)

    def view_all(self, box_lo, box_hi):
        box_lo = np.asarray(box_lo, F)
        box_hi = np.asarray(box_hi, F)
        up = np.array([0, 1, 0], F)
        diagonal = np.sqrt(np.sum((box_hi - box_lo) ** 2, dtype=F))
        r = diagonal * F(0.5)
        center = (box_lo + box_hi) * F(0.5)
        eye = center + np.array([0, 0, r + r / np.arctan(self.fovy)], F)
        self.set_orientation(eye, center, up, self.fovy)

    def basis(self, width: int, height: int):
        """Launch-parameter camera basis: (org, dir_00, dir_du, dir_dv)
        exactly as uploaded by the reference app (ref: hostCode.cu:942-945)."""
        lower_left, horizontal, vertical = self.get_screen()
        return (self.position.copy(), lower_left,
                (horizontal / F(width)).astype(F),
                (vertical / F(height)).astype(F))

    def to_cli_string(self) -> str:
        """Reproducible pose as CLI args (Shift+C in the reference,
        ref: common/pipeline.cu:543-562)."""
        poi = self.get_poi()
        return ("--camera "
                + " ".join(f"{v:f}" for v in self.position)
                + " " + " ".join(f"{v:f}" for v in poi)
                + " " + " ".join(f"{v:f}" for v in self.up_vector)
                + f" -fovy {self.get_fovy_degrees():f}")


# ---------------------------------------------------------------------------
# Quaternion helpers (ref: common/vecmath.h:900-969)
# ---------------------------------------------------------------------------

def quat_identity():
    return np.array([1, 0, 0, 0], F)  # (w, x, y, z)


def quat_rotation(v_from, v_to):
    nf, nt = _norm(np.asarray(v_from, F)), _norm(np.asarray(v_to, F))
    return np.concatenate([[np.dot(nf, nt)], np.cross(nf, nt)]).astype(F)


def quat_mul(p, q):
    pw, px, py, pz = p
    qw, qx, qy, qz = q
    return np.array([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
    ], F)


def quat_conjugate(q):
    return np.array([q[0], -q[1], -q[2], -q[3]], F)


def quat_rotation_matrix(q):
    """3x3 rotation matrix, column-major convention matching the reference
    mat4f rotationMatrix (ref: common/vecmath.h:936-969); returns rows so
    that M @ v == reference (mat * vec)."""
    w, x, y, z = q
    xx, xy, xz, xw = x * x, x * y, x * z, x * w
    yy, yz, yw = y * y, y * z, y * w
    zz, zw = z * z, z * w
    ww = w * w
    return np.array([
        [2 * (ww + xx) - 1, 2 * (xy - zw), 2 * (xz + yw)],
        [2 * (xy + zw), 2 * (ww + yy) - 1, 2 * (yz - xw)],
        [2 * (xz - yw), 2 * (yz + xw), 2 * (ww + zz) - 1],
    ], F)


class CameraManip:
    """Arcball rotate (LMB) / pan (LMB+Alt) / dolly (RMB)
    (ref: common/camera.h:120-236)."""
    LEFT, MIDDLE, RIGHT, NONE = 0, 1, 2, 3
    NOMOD, SHIFT, CTRL, ALT = 0x0, 0x1, 0x2, 0x4

    def __init__(self, camera: Camera | None = None, width: int = 0, height: int = 0):
        self.camera = camera
        self.vp_width = width
        self.vp_height = height
        self.dragging = False
        self.mouse_button = self.NONE
        self.last_pos = (0, 0)
        self.down_pos = np.zeros(3, F)
        self.curr_rotation = quat_identity()
        self.down_rotation = quat_identity()

    def ball_project(self, x, y):
        v = np.zeros(3, F)
        v[0] = (x - 0.5 * self.vp_width) / (0.5 * self.vp_width)
        v[1] = -(y - 0.5 * self.vp_height) / (0.5 * self.vp_height)
        d = v[0] * v[0] + v[1] * v[1]
        if d > 1.0:
            ln = np.sqrt(d)
            v[0] /= ln
            v[1] /= ln
        else:
            v[2] = np.sqrt(1.0 - d)
        return v

    def handle_mouse_down(self, x, y, button, mod=NOMOD):
        if self.camera is None:
            return False
        self.dragging = True
        self.last_pos = (x, y)
        if button == self.LEFT:
            self.down_pos = self.ball_project(x, y)
            self.down_rotation = self.curr_rotation.copy()
        self.mouse_button = button
        return True

    def handle_mouse_up(self, x, y, button, mod=NOMOD):
        if self.camera is None:
            return False
        self.dragging = False
        self.mouse_button = self.NONE
        return True

    def handle_mouse_move(self, x, y, mod=NOMOD):
        cam = self.camera
        if cam is None or not self.dragging:
            return False
        rotate = self.mouse_button == self.LEFT and mod != self.ALT
        pan = self.mouse_button == self.LEFT and mod == self.ALT
        zoom = self.mouse_button == self.RIGHT

        if rotate:
            curr_pos = self.ball_project(x, y)
            self.curr_rotation = quat_mul(quat_rotation(self.down_pos, curr_pos),
                                          self.down_rotation)
            rotmat = quat_rotation_matrix(quat_conjugate(self.curr_rotation))
            poi = cam.get_poi()
            eye = rotmat @ np.array([0, 0, cam.distance], F) + poi
            up = rotmat[:, 1]  # column 1 == reference rotmat(1)
            cam.set_orientation(eye, poi, up, cam.fovy)

        if pan:
            dx = (self.last_pos[0] - x) / self.vp_width
            dy = -(self.last_pos[1] - y) / self.vp_height
            s = 2.0 * cam.distance
            direction = _norm(cam.position - cam.get_poi())
            right = np.cross(cam.up_vector, direction).astype(F)
            d = F(dx * s) * right + F(dy * s) * cam.up_vector
            cam.set_orientation(cam.position + d, cam.get_poi() + d,
                                cam.up_vector, cam.fovy)

        if zoom:
            dy = -(self.last_pos[1] - y) / self.vp_height
            s = 2.0 * cam.distance * dy
            direction = _norm(cam.position - cam.get_poi())
            eye = cam.position - direction * F(s)
            cam.set_orientation(eye, cam.get_poi(), cam.up_vector, cam.fovy)

        self.last_pos = (x, y)
        return True
