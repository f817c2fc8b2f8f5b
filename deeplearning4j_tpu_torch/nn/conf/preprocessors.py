"""Input preprocessors: rank adapters between layer families, on tensors.

Port of ``deeplearning4j_tpu/nn/conf/preprocessors.py`` (the reference's
``nn/conf/preprocessor/``). Each is a reshape or normalisation inside the
forward, so autograd derives the backward.

Layout: images are NHWC ([batch, height, width, channels]), as in the
JAX package, so ``CnnToFeedForwardPreProcessor`` flattens in NHWC order
and the dense layer after it takes the reference's weights unpermuted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Type

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

_PREPROC_REGISTRY: Dict[str, Type["InputPreProcessor"]] = {}


def register_preprocessor(cls):
    _PREPROC_REGISTRY[cls.__name__] = cls
    return cls


def _std(x):
    """``jnp.std``: the population standard deviation (ddof 0)."""
    return torch.std(x, dim=tuple(range(1, x.ndim)), keepdim=True,
                     correction=0)


@dataclasses.dataclass
class InputPreProcessor:
    def pre_process(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"type": type(self).__name__}
        d.update({f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                  if getattr(self, f.name) is not None})
        return d

    @staticmethod
    def from_dict(d: dict) -> "InputPreProcessor":
        d = dict(d)
        cls = _PREPROC_REGISTRY[d.pop("type")]
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in d.items() if k in names})


@register_preprocessor
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, h, w, c] → [b, h*w*c], NHWC order (a view of a contiguous input)."""

    height: Optional[int] = None
    width: Optional[int] = None
    channels: Optional[int] = None

    def pre_process(self, x):
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type):
        return InputType.feed_forward(input_type.flat_size())


@register_preprocessor
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[b, h*w*c] → [b, h, w, c]."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def pre_process(self, x):
        if x.ndim == 4:
            return x
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, t, f] → [b*t, f] (time folded into batch)."""

    def pre_process(self, x):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, input_type):
        return InputType.feed_forward(input_type.size)


@register_preprocessor
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[b*t, f] → [b, t, f]; needs the minibatch size at apply time."""

    def pre_process(self, x, batch: Optional[int] = None):
        if x.ndim == 3:
            return x
        if batch is None:
            raise ValueError("FeedForwardToRnn needs the batch size")
        return x.reshape(batch, -1, x.shape[-1])

    def output_type(self, input_type):
        return InputType.recurrent(input_type.flat_size())


@register_preprocessor
@dataclasses.dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """[b*t, h, w, c] → [b, t, h*w*c]."""

    height: Optional[int] = None
    width: Optional[int] = None
    channels: Optional[int] = None

    def pre_process(self, x, batch: Optional[int] = None):
        if batch is None:
            raise ValueError("CnnToRnn needs the batch size")
        return x.reshape(batch, -1, x.shape[1] * x.shape[2] * x.shape[3])

    def output_type(self, input_type):
        return InputType.recurrent(input_type.flat_size())


@register_preprocessor
@dataclasses.dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[b, t, h*w*c] → [b*t, h, w, c]."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def pre_process(self, x):
        return x.reshape(-1, self.height, self.width, self.channels)

    def output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclasses.dataclass
class ReshapePreProcessor(InputPreProcessor):
    """Arbitrary reshape keeping the batch dim."""

    shape: tuple = ()

    def pre_process(self, x):
        return x.reshape((x.shape[0],) + tuple(self.shape))

    def output_type(self, input_type):
        size = 1
        for s in self.shape:
            size *= s
        return InputType.feed_forward(size)


@register_preprocessor
@dataclasses.dataclass
class ZeroMeanAndUnitVariancePreProcessor(InputPreProcessor):
    """Per-example standardisation."""

    def pre_process(self, x):
        mean = torch.mean(x, dim=tuple(range(1, x.ndim)), keepdim=True)
        return (x - mean) / (_std(x) + 1e-8)

    def output_type(self, input_type):
        return input_type


@register_preprocessor
@dataclasses.dataclass
class UnitVariancePreProcessor(InputPreProcessor):
    def pre_process(self, x):
        return x / (_std(x) + 1e-8)

    def output_type(self, input_type):
        return input_type


@register_preprocessor
@dataclasses.dataclass
class ZeroMeanPrePreProcessor(InputPreProcessor):
    def pre_process(self, x):
        return x - torch.mean(x, dim=tuple(range(1, x.ndim)), keepdim=True)

    def output_type(self, input_type):
        return input_type


@register_preprocessor
@dataclasses.dataclass
class BinomialSamplingPreProcessor(InputPreProcessor):
    """Bernoulli-sample activations with p = x, straight-through: the
    forward gives the sample, the backward is the identity (the
    reference's backprop)."""

    needs_rng = True

    def pre_process(self, x, rng: Optional[torch.Generator] = None):
        sample = torch.bernoulli(x.detach(), generator=rng)
        return x + (sample - x).detach()

    def output_type(self, input_type):
        return input_type


@register_preprocessor
@dataclasses.dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    """Apply child preprocessors in order; children serialize nested."""

    preprocessors: tuple = ()

    def __post_init__(self):
        self.preprocessors = tuple(
            InputPreProcessor.from_dict(p) if isinstance(p, dict) else p
            for p in self.preprocessors)

    @property
    def needs_rng(self):
        return any(getattr(p, "needs_rng", False) for p in self.preprocessors)

    @property
    def needs_batch(self):
        return any(isinstance(p, (FeedForwardToRnnPreProcessor,
                                  CnnToRnnPreProcessor))
                   for p in self.preprocessors)

    def pre_process(self, x, batch=None, rng=None):
        for p in self.preprocessors:
            x, _ = apply_preprocessor(p, x, batch=batch, rng=rng)
        return x

    def output_type(self, input_type):
        for p in self.preprocessors:
            input_type = p.output_type(input_type)
        return input_type

    def to_dict(self) -> dict:
        return {"type": type(self).__name__,
                "preprocessors": [p.to_dict() for p in self.preprocessors]}


def apply_preprocessor(pre: InputPreProcessor, x, *, batch=None, rng=None):
    """Apply ``pre`` with whatever context it needs (the minibatch size for
    FF→RNN folds, a generator for sampling). Returns ``(out, rng)``: a
    ``torch.Generator`` advances in place, so ``rng`` comes back as is."""
    kwargs = {}
    if (isinstance(pre, (FeedForwardToRnnPreProcessor, CnnToRnnPreProcessor))
            or getattr(pre, "needs_batch", False)):
        kwargs["batch"] = batch
    if getattr(pre, "needs_rng", False):
        kwargs["rng"] = rng
    return pre.pre_process(x, **kwargs), rng
