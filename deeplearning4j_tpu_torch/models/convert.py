"""Load the reference package's parameters and training state into the port.

``TransformerLM.params`` from the JAX package, turned into numpy leaf by
leaf (``np.asarray``), becomes the port's nested dict of tensors with the
same leaf names; a JAX ``MultiLayerNetwork``'s or ``ComputationGraph``'s
params, updater state, net state (keyed ``"0"``, ``"1"``, … or by layer
name, as in JAX; BatchNorm's running ``mean``/``var`` are net state) and
iteration count load into a port network of the same class, which then
carries on the JAX run step for step. This
module imports neither jax nor the JAX package: it takes plain numpy.
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


def load_network_from_jax(net, params, updater_state=None, net_state=None,
                          iteration_count=None):
    """Put a JAX ``MultiLayerNetwork``'s or ``ComputationGraph``'s state,
    as numpy trees, into the port network ``net`` of the same class
    (initialised first, so what is not given keeps its fresh value) on
    ``net.device``. Returns ``net``."""
    net.init()
    net.params = params_from_jax(params, net.device)
    if updater_state is not None:
        net.updater_state = params_from_jax(updater_state, net.device)
    if net_state is not None:
        net.net_state = params_from_jax(net_state, net.device)
    if iteration_count is not None:
        net.iteration_count = int(iteration_count)
    return net
