"""Weight-filter rendering (plot/PlotFilters.java, 141 LoC).

The reference tiles a layer's weight filters into one normalized image for
the UI's renders endpoint. Same here: take a weight array — dense [n_in,
n_out] or conv [kh, kw, c_in, n_out] — normalize each filter to [0, 255],
and tile into a grid; ``render_to_png`` returns PNG bytes via the UI's
encoder so the result can be POSTed to the dashboard or written to disk.

A copy of ``deeplearning4j_tpu/plot/filters.py``: the port keeps its own,
so that it imports nothing of the JAX package. The PNG encoder is a private
copy of the reference's ``ui.listeners.encode_png_gray`` (the UI is not
ported).
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional

import numpy as np


def _encode_png_gray(img: np.ndarray) -> bytes:
    """Minimal 8-bit grayscale PNG encoder (stdlib zlib only — the reference
    leaned on javax.imageio for the same job)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def filters_grid(weights: np.ndarray, max_filters: int = 64,
                 pad: int = 1) -> np.ndarray:
    """Tile per-output-unit filters into a uint8 grid image."""
    w = np.asarray(weights, np.float64)
    if w.ndim == 2:  # dense: each column is a filter; square-ish reshape
        n_in, n_out = w.shape
        side = int(math.ceil(math.sqrt(n_in)))
        padded = np.zeros((side * side, n_out))
        padded[:n_in] = w
        filters = padded.T.reshape(n_out, side, side)
    elif w.ndim == 4:  # conv [kh, kw, c_in, n_out]: mean over input channels
        filters = w.mean(axis=2).transpose(2, 0, 1)
    else:
        raise ValueError(f"expected rank-2 or rank-4 weights, got {w.shape}")
    filters = filters[:max_filters]
    n, h, wdt = filters.shape
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    grid = np.zeros((rows * (h + pad) - pad, cols * (wdt + pad) - pad),
                    np.uint8)
    for i, f in enumerate(filters):
        lo, hi = f.min(), f.max()
        img = ((f - lo) / (hi - lo) * 255 if hi > lo
               else np.zeros_like(f)).astype(np.uint8)
        r, c = divmod(i, cols)
        grid[r * (h + pad): r * (h + pad) + h,
             c * (wdt + pad): c * (wdt + pad) + wdt] = img
    return grid


def render_to_png(weights: np.ndarray, max_filters: int = 64) -> bytes:
    return _encode_png_gray(filters_grid(weights, max_filters))


def render_layer(model, layer_index: int,
                 param: Optional[str] = None) -> bytes:
    """Render a network layer's weight filters (the RendersResource role)."""
    table = model.get_param_table()
    key = f"{layer_index}_{param or 'W'}"
    if key not in table:
        raise KeyError(f"no param {key!r}; available: {sorted(table)}")
    return render_to_png(np.asarray(table[key]))
