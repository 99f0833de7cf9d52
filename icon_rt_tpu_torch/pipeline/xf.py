"""Binary .xf transfer-function files, byte-compatible with the reference
(ref: common/pipeline.cu:127-169): float opacity, box1f valueRange,
box1f relRange, int N, N * vec4f RGBA."""
from __future__ import annotations

import struct

import numpy as np


def load_xf(path: str):
    """Returns (opacity, value_range (2,), rel_range (2,), lut (N, 4)) or
    None if unreadable/empty (like the reference's bool return)."""
    try:
        with open(path, "rb") as f:
            head = f.read(24)
            if len(head) < 24:
                return None
            opacity, vlo, vhi, rlo, rhi, n = struct.unpack("<5fi", head)
            if n <= 0:
                return None
            data = np.frombuffer(f.read(16 * n), np.float32)
            if data.size != 4 * n:
                return None
            return (np.float32(opacity), np.array([vlo, vhi], np.float32),
                    np.array([rlo, rhi], np.float32),
                    data.reshape(n, 4).copy())
    except OSError:
        return None


def save_xf(path: str, opacity, value_range, rel_range, lut) -> bool:
    lut = np.asarray(lut, np.float32)
    try:
        with open(path, "wb") as f:
            f.write(struct.pack("<5fi", float(opacity),
                                float(value_range[0]), float(value_range[1]),
                                float(rel_range[0]), float(rel_range[1]),
                                int(lut.shape[0])))
            f.write(lut.tobytes())
        return True
    except OSError:
        return False
