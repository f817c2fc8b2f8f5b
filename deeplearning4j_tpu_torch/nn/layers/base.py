"""Layer implementation protocol + registry, on tensors.

Port of ``deeplearning4j_tpu/nn/layers/base.py``. Each implementation
holds its conf and the network's dtype policy:

- ``param_shapes()`` — the named param table's shapes ("W"/"b" keys, the
  reference's DefaultParamInitializer), so ``num_params`` counts without
  drawing weights;
- ``init_params(gen)`` — the table, drawn from an explicit CPU
  ``torch.Generator`` (the network moves it to its device);
- ``init_state()`` — non-trainable state (BatchNorm's running statistics);
- ``forward(params, x, state, *, train, rng, mask) -> (y, new_state)`` —
  a function of its arguments; autograd derives the backward.

Dropout on the layer *input* (the reference's per-layer ``dropOut``) is
inverted dropout drawn from the generator the network passes as ``rng``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Type

import torch

from deeplearning4j_tpu_torch.dtypes import FLOAT32, DtypePolicy
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConf
from deeplearning4j_tpu_torch.ops.activations import get_activation

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]

# exact leaf names treated as biases (unregularized; bias_learning_rate)
_BIAS_PARAM_NAMES = frozenset({"b", "vb", "hb", "be", "bd", "beta", "bias"})

def is_bias_param(name: str) -> bool:
    return name in _BIAS_PARAM_NAMES


_IMPL_REGISTRY: Dict[Type[LayerConf], Type["LayerImpl"]] = {}


def register_layer_impl(conf_cls: Type[LayerConf]):
    def deco(impl_cls):
        _IMPL_REGISTRY[conf_cls] = impl_cls
        return impl_cls

    return deco


def get_layer_impl(conf: LayerConf,
                   policy: DtypePolicy = FLOAT32) -> "LayerImpl":
    impl_cls = None
    for cls in type(conf).__mro__:  # closest registered base class
        if cls in _IMPL_REGISTRY:
            impl_cls = _IMPL_REGISTRY[cls]
            break
    if impl_cls is None:
        raise ValueError(
            f"no implementation registered for {type(conf).__name__}")
    return impl_cls(conf, policy)


class LayerImpl:
    def __init__(self, conf: LayerConf, policy: DtypePolicy = FLOAT32):
        self.conf = conf
        self.policy = policy

    # ---- params ----
    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def init_params(self, gen: torch.Generator) -> Params:
        return {}

    def init_state(self) -> State:
        return {}

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    # ---- forward ----
    def forward(self, params: Params, x: torch.Tensor, state: State, *,
                train: bool = False, rng: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError

    # ---- helpers ----
    def activation_fn(self):
        return get_activation(self.conf.activation)

    def maybe_dropout(self, x: torch.Tensor, *, train: bool,
                      rng: Optional[torch.Generator]) -> torch.Tensor:
        p = float(self.conf.dropout or 0.0)
        if not train or p <= 0.0:
            return x
        if rng is None:
            raise ValueError(
                f"layer {self.conf.name or type(self.conf).__name__} has "
                "dropout but no generator was passed to forward(train=True)")
        keep = 1.0 - p
        kept = torch.rand(x.shape, generator=rng, device=x.device) < keep
        # inverted dropout (scale at train time), matching nd4j Dropout
        return torch.where(kept, x / keep, 0.0).to(x.dtype)

    def l1_l2_penalty(self, params: Params) -> Optional[torch.Tensor]:
        """L1/L2 on weight params (not biases), as BaseLayer.calcL1/calcL2;
        recurses into nested param trees. ``None`` when both are 0."""
        l1 = float(self.conf.l1 or 0.0)
        l2 = float(self.conf.l2 or 0.0)
        if l1 == 0.0 and l2 == 0.0:
            return None

        def walk(tree, total):
            for name, p in tree.items():
                if isinstance(p, dict):
                    total = walk(p, total)
                    continue
                if is_bias_param(name):  # biases unregularized
                    continue
                terms = []
                if l1:
                    terms.append(l1 * torch.sum(torch.abs(p)))
                if l2:
                    terms.append(0.5 * l2 * torch.sum(p * p))
                for t in terms:
                    total = t if total is None else total + t
            return total

        return walk(params, None)
