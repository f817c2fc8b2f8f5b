"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package mirrors its
layout (``models/transformer.py``, ``ops/attention.py``, ``serving/`` ...)
and holds every module to the reference's numerics in
``tests/test_torch_*.py``. It imports ``torch`` and numpy only: never
``jax`` and never ``deeplearning4j_tpu`` (a jax-free module the port needs
is copied here).

Entry points (``TransformerLM``, ``DecodeEngine``, ``DecodeServer``) run on
the CUDA card unless the caller passes ``device="cpu"``; with no card and no
explicit CPU request they raise instead of falling back. Hand-written CUDA
kernels live in ``kernels/`` (sources under ``kernels/csrc/``), built with
``nvcc`` at first use.
"""

from deeplearning4j_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
