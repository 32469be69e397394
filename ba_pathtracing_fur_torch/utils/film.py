"""Film image output: a dependency-light PNG writer (numpy + zlib).

Counterpart of `ba_pathtracing_fur_tpu/utils/film.py` (the writer half).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_srgb_u8(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    img = np.asarray(img, np.float32)
    img = np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
    return (img * 255.0 + 0.5).astype(np.uint8)


def encode_png(img: np.ndarray, gamma: float = 2.2) -> bytes:
    """Encode an [H,W,3] float (linear) or uint8 image as PNG bytes."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = to_srgb_u8(a, gamma)
    h, w = a.shape[:2]
    if a.ndim == 2:
        a = a[..., None].repeat(3, axis=-1)
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, gamma: float = 2.2) -> None:
    """Write an [H,W,3] float (linear) or uint8 image as PNG to a path or a
    binary file-like object."""
    png = encode_png(img, gamma)
    if hasattr(path, "write"):
        path.write(png)
    else:
        with open(path, "wb") as f:
            f.write(png)
