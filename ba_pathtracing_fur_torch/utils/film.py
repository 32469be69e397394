"""Film image I/O: a dependency-light PNG writer and reader (numpy + zlib),
PPM, and the image metrics.

Counterpart of `ba_pathtracing_fur_tpu/utils/film.py`, in the same numpy
arithmetic, so both packages read and write the same bytes and values.
Texture and environment maps come in through `read_image`.
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


def write_ppm(path: str, img: np.ndarray, gamma: float = 2.2) -> None:
    a = to_srgb_u8(img, gamma)
    h, w = a.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(a.tobytes())


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def read_png(path: str, gamma: float = 2.2) -> np.ndarray:
    """Read an 8-bit RGB(A) non-interlaced PNG (any filter types) to linear
    float [H,W,3] (Texture::fromFile for the renderer's own outputs and
    simple assets). Other PNGs raise AssertionError."""
    with open(path, "rb") as f:
        data = f.read()
    _require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = color_type = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", payload)
            _require(bit_depth == 8 and interlace == 0, "only 8-bit non-interlaced")
            _require(color_type in (2, 6), "only RGB/RGBA")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    ch = 3 if color_type == 2 else 4
    raw = zlib.decompress(idat)
    stride = w * ch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        row = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if ftype == 1:  # Sub
            for i in range(ch, stride):
                row[i] = (row[i] + row[i - ch]) & 0xFF
        elif ftype == 2:  # Up
            row = (row + prev) & 0xFF
        elif ftype == 3:  # Average
            for i in range(stride):
                left = row[i - ch] if i >= ch else 0
                row[i] = (row[i] + ((int(left) + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a_ = int(row[i - ch]) if i >= ch else 0
                b_ = int(prev[i])
                c_ = int(prev[i - ch]) if i >= ch else 0
                p = a_ + b_ - c_
                pa, pb, pc = abs(p - a_), abs(p - b_), abs(p - c_)
                pred = a_ if (pa <= pb and pa <= pc) else (b_ if pb <= pc else c_)
                row[i] = (row[i] + pred) & 0xFF
        out[y] = row
        prev = row
    img = out.reshape(h, w, ch)[..., :3].astype(np.float32) / 255.0
    return img ** gamma


def read_ppm(path: str, gamma: float = 2.2) -> np.ndarray:
    with open(path, "rb") as f:
        _require(f.readline().strip() == b"P6", f"{path}: not a binary PPM")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = (int(x) for x in line.split())
        maxv = int(f.readline())
        a = np.frombuffer(f.read(w * h * 3), np.uint8).reshape(h, w, 3)
    return (a.astype(np.float32) / maxv) ** gamma


def read_image(path: str, gamma: float = 2.2):
    """An image file by its extension -> linear float [H,W,3], or None.
    `gamma` decodes display-encoded images to linear light (1.0 for data
    maps). Formats other than PNG, PPM and .npy go through PIL where it is
    installed (the reference reads everything through stb_image)."""
    low = path.lower()
    if low.endswith(".png"):
        return read_png(path, gamma)
    if low.endswith(".ppm"):
        return read_ppm(path, gamma)
    if low.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        with Image.open(path) as im:
            a = np.asarray(im.convert("RGB"), np.uint8)
    except OSError:
        return None
    return (a.astype(np.float32) / 255.0) ** gamma


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def relative_l1(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sum(np.abs(a - b)) / np.maximum(np.sum(np.abs(b)), 1e-12))
