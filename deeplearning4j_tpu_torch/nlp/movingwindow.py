"""Moving-window contexts over token sequences.

Re-design of ``deeplearning4j-nlp/.../text/movingwindow/`` (Window.java,
Windows.java, WordConverter.java) and ``util/MovingWindowMatrix.java``: the
reference slides a fixed window over each sentence, pads the edges with
``<s>``/``</s>``, and converts windows to one-hot training matrices. Here
window extraction stays on host but emits dense index arrays so the whole
batch lowers to one device gather instead of per-window objects.

A copy of ``deeplearning4j_tpu/nlp/movingwindow.py``: the port keeps its own,
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

BEGIN = "<s>"
END = "</s>"


@dataclass
class Window:
    """One context window (Window.java): words, focus position."""

    words: List[str]
    focus_index: int

    @property
    def focus_word(self) -> str:
        return self.words[self.focus_index]

    def as_tokens(self) -> List[str]:
        return list(self.words)


def windows(tokens: Sequence[str], window_size: int = 5) -> List[Window]:
    """All centered windows over a sentence, edge-padded (Windows.java)."""
    if window_size % 2 == 0:
        raise ValueError("window_size must be odd")
    half = window_size // 2
    padded = [BEGIN] * half + list(tokens) + [END] * half
    return [Window(words=padded[i:i + window_size], focus_index=half)
            for i in range(len(tokens))]


def window_indices(tokens: Sequence[str], word_index: Dict[str, int],
                   window_size: int = 5, unk_index: int = 0
                   ) -> np.ndarray:
    """[num_windows, window_size] int32 vocab rows (WordConverter's
    one-hot matrices become a single embedding gather on device)."""
    ws = windows(tokens, window_size)
    return np.asarray(
        [[word_index.get(w, unk_index) for w in win.words] for win in ws],
        np.int32).reshape(-1, window_size)  # keep 2-d for empty sentences


def moving_window_matrix(flat: np.ndarray, window_rows: int,
                         add_rotations: bool = False) -> np.ndarray:
    """Stack sliding windows of rows from a 2-d array
    (util/MovingWindowMatrix.java): [n, d] → [n - w + 1, w, d]; with
    ``add_rotations`` also append the row-rotated variants as the reference
    does for augmentation."""
    x = np.asarray(flat)
    if x.ndim != 2:
        raise ValueError("expected a 2-d array")
    n = x.shape[0]
    if window_rows > n:
        raise ValueError("window larger than input")
    base = np.stack([x[i:i + window_rows] for i in range(n - window_rows + 1)])
    if not add_rotations:
        return base
    rots = [np.roll(base, r, axis=1) for r in range(1, window_rows)]
    return np.concatenate([base] + rots, axis=0)
