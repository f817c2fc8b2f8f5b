"""Default-device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for (explicitly
    or by default) and no card is present: the port never carries on
    silently on the CPU; pass ``device="cpu"`` to run the plain paths."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch paths on the CPU")
    return dev
