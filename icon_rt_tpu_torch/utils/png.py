"""Minimal dependency-free PNG writer for batch-mode frame dumps.

Plays the role of the vendored stb_image_write in the reference
(ref: common/pipeline.cu:733-740): batch mode writes '<name>.png'.
Like the reference (stbi_flip_vertically_on_write), the framebuffer's
row 0 is the bottom of the image, so we flip on write.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(rgba: np.ndarray, flip_vertically: bool = True,
               level: int = 6) -> bytes:
    """Encode an (H, W, 4) uint8 RGBA array as PNG bytes (in memory — the
    interactive viewer streams these over HTTP)."""
    rgba = np.asarray(rgba)
    if rgba.ndim != 3 or rgba.shape[2] != 4 or rgba.dtype != np.uint8:
        raise ValueError(f"expected (H, W, 4) uint8, got {rgba.shape} {rgba.dtype}")
    if flip_vertically:
        rgba = rgba[::-1]
    h, w = rgba.shape[:2]
    # filter byte 0 (None) per scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgba: np.ndarray, flip_vertically: bool = True) -> None:
    """Write an (H, W, 4) uint8 RGBA array as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(rgba, flip_vertically))


def read_png(path: str) -> np.ndarray:
    """Read a PNG written by write_png back into (H, W, 4) uint8 (top-down)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, w, h, idat = 8, 0, 0, b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or ctype != 6:
                raise ValueError("only 8-bit RGBA supported")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * 4 + 1)
    if not np.all(raw[:, 0] == 0):
        raise ValueError("only filter type 0 supported")
    return raw[:, 1:].reshape(h, w, 4).copy()
