"""Load the reference package's parameters into the port.

``TransformerLM.params`` from the JAX package, turned into numpy leaf by
leaf (``np.asarray``), becomes the port's nested dict of tensors with the
same leaf names. This module imports neither jax nor the JAX package: it
takes plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":        # ml_dtypes.bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device="cpu"):
    """Nested dict/list of numpy arrays → nested dict/list of tensors on
    ``device`` (same leaf names, dtypes and ``[in, out]`` layouts)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _leaf(tree, device)
