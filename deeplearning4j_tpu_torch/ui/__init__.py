"""Training-visualization web UI (reference: deeplearning4j-ui module).

``UiServer`` serves JSON endpoints + a single-page dashboard; the listeners
in ``ui.listeners`` POST weight/activation/architecture snapshots from the
training loop, mirroring the reference's Dropwizard UI + IterationListener
clients (`deeplearning4j-ui/.../UiServer.java:242`). Port of
``deeplearning4j_tpu/ui/__init__.py``."""

from deeplearning4j_tpu_torch.ui.server import UiServer
from deeplearning4j_tpu_torch.ui.storage import HistoryStorage, SessionStorage
from deeplearning4j_tpu_torch.ui.listeners import (
    ConvolutionalIterationListener,
    FlowIterationListener,
    HistogramIterationListener,
    RemoteUiConnection,
    encode_png_gray,
)

__all__ = [
    "UiServer",
    "SessionStorage",
    "HistoryStorage",
    "HistogramIterationListener",
    "FlowIterationListener",
    "ConvolutionalIterationListener",
    "RemoteUiConnection",
    "encode_png_gray",
]
