"""Image loading to arrays (util/ImageLoader.java, 196 LoC).

The reference wraps javax.imageio into ``asRowVector``/``asMatrix`` plus
nearest-neighbor resizing. Here: PIL when present; otherwise built-in
decoders for PNG (8-bit gray/RGB/RGBA, non-interlaced — stdlib zlib) and
binary PPM/PGM, which covers the framework's own outputs and common test
fixtures without native deps.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np


def load_image(path: str) -> np.ndarray:
    """File → uint8 array [H, W] (gray) or [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data)
    if data[:2] in (b"P5", b"P6"):
        return _decode_pnm(data)
    try:  # other formats (JPEG…): delegate to PIL when present
        from PIL import Image, UnidentifiedImageError
    except ImportError:
        raise ValueError(f"unsupported image format: {path}")
    try:
        return np.asarray(Image.open(path))
    except UnidentifiedImageError:
        raise ValueError(f"unsupported image format: {path}")


def as_matrix(path: str) -> np.ndarray:
    """ImageLoader.asMatrix: float32 in [0, 1]."""
    return np.asarray(load_image(path), np.float32) / 255.0


def as_row_vector(path: str) -> np.ndarray:
    """ImageLoader.asRowVector: flattened float32."""
    return as_matrix(path).ravel()


def resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-neighbor resize (the reference's scaling strategy)."""
    img = np.asarray(img)
    rows = (np.arange(height) * img.shape[0] // height).clip(
        0, img.shape[0] - 1)
    cols = (np.arange(width) * img.shape[1] // width).clip(
        0, img.shape[1] - 1)
    return img[rows][:, cols]


def decode_png(data: bytes) -> np.ndarray:
    """Minimal PNG decoder: 8-bit grayscale/RGB/RGBA, non-interlaced."""
    pos = 8
    width = height = None
    color_type = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = \
                struct.unpack(">IIBBBBB", chunk)
            if bit_depth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNG supported")
        elif kind == b"IDAT":
            idat += chunk
        elif kind == b"IEND":
            break
    if width is None:
        raise ValueError("no IHDR chunk")
    channels = {0: 1, 2: 3, 6: 4}.get(color_type)
    if channels is None:
        raise ValueError(f"unsupported PNG color type {color_type}")
    raw = zlib.decompress(idat)
    stride = width * channels
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for r in range(height):
        filt = raw[pos]
        row = np.frombuffer(raw[pos + 1:pos + 1 + stride],
                            np.uint8).astype(np.int32)
        pos += 1 + stride
        if filt == 0:
            cur = row
        elif filt == 2:  # Up
            cur = (row + prev) % 256
        elif filt in (1, 3, 4):  # Sub / Average / Paeth need a scalar loop
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = prev[i]
                cpx = prev[i - channels] if i >= channels else 0
                if filt == 1:
                    pred = a
                elif filt == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - cpx
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cpx)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else cpx)
                cur[i] = (row[i] + pred) % 256
        else:
            raise ValueError(f"unknown PNG filter {filt}")
        out[r] = cur.astype(np.uint8)
        prev = cur
    img = out.reshape(height, width, channels)
    return img[:, :, 0] if channels == 1 else img


def _decode_pnm(data: bytes) -> np.ndarray:
    """Binary PGM (P5) / PPM (P6)."""
    parts = []
    pos = 2
    while len(parts) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # comment line
            while data[pos:pos + 1] not in (b"\n", b""):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        parts.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    width, height, maxval = parts
    if not 0 < maxval <= 255:
        raise ValueError(f"only 8-bit PNM supported (maxval {maxval})")
    channels = 3 if data[:2] == b"P6" else 1
    pixels = np.frombuffer(data, np.uint8, count=width * height * channels,
                           offset=pos)
    img = pixels.reshape(height, width, channels)
    if maxval != 255:  # rescale so as_matrix's /255 is correct
        img = (img.astype(np.uint16) * 255 // maxval).astype(np.uint8)
    return img[:, :, 0] if channels == 1 else img


def save_pgm(path: str, img: np.ndarray) -> None:
    """Write grayscale uint8 as binary PGM (for tests/visualization)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError("PGM is grayscale-only")
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())
