"""Input types for shape inference.

Mirror of ``nn/conf/inputs/InputType.java:101`` (FF/RNN/CNN): used by the
list/graph builders to infer each layer's n_in and to auto-insert input
preprocessors, replacing the reference's ``ConvolutionLayerSetup`` pass
(nn/conf/layers/setup/ConvolutionLayerSetup.java).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str  # "FF" | "RNN" | "CNN"
    size: Optional[int] = None  # FF/RNN feature size
    timeseries_length: Optional[int] = None  # RNN (optional, may be None)
    height: Optional[int] = None  # CNN
    width: Optional[int] = None
    channels: Optional[int] = None

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("FF", size=int(size))

    @staticmethod
    def recurrent(size: int, timeseries_length: Optional[int] = None) -> "InputType":
        return InputType("RNN", size=int(size), timeseries_length=timeseries_length)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("CNN", height=int(height), width=int(width), channels=int(channels))

    def flat_size(self) -> int:
        if self.kind in ("FF", "RNN"):
            assert self.size is not None
            return self.size
        assert None not in (self.height, self.width, self.channels)
        return self.height * self.width * self.channels

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        return InputType(**d)
