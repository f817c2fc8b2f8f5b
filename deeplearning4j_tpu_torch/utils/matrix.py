"""MovingWindowMatrix: sliding-window tiling of a 2-D array.

Re-design of the reference's ``util/MovingWindowMatrix.java`` (window
extraction + optional rot90 augmentation feeding
MovingWindowDataSetFetcher). Windows tile the matrix with stride equal to
the window size; ragged edges are dropped, matching the reference's
whole-window semantics.
"""

from __future__ import annotations

from typing import List

import numpy as np


class MovingWindowMatrix:
    def __init__(self, to_slice: np.ndarray, window_rows: int = 28,
                 window_cols: int = 28, add_rotate: bool = False):
        self.to_slice = np.asarray(to_slice)
        if self.to_slice.ndim != 2:
            raise ValueError(
                f"MovingWindowMatrix expects a 2-D matrix, got shape "
                f"{self.to_slice.shape}")
        self.window_rows = int(window_rows)
        self.window_cols = int(window_cols)
        self.add_rotate = bool(add_rotate)

    def windows(self, flattened: bool = False) -> List[np.ndarray]:
        """All whole window tiles in row-major order; with ``add_rotate``
        each tile is followed by its three rot90 orientations."""
        h, w = self.to_slice.shape
        wr, wc = self.window_rows, self.window_cols
        out: List[np.ndarray] = []
        for r in range(0, h - wr + 1, wr):
            for c in range(0, w - wc + 1, wc):
                tile = self.to_slice[r:r + wr, c:c + wc]
                variants = [tile]
                if self.add_rotate and wr == wc:
                    # rot90 keeps shape only for square windows
                    cur = tile
                    for _ in range(3):
                        cur = np.rot90(cur)
                        variants.append(cur)
                for v in variants:
                    out.append(v.ravel().copy() if flattened else v.copy())
        return out
