"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Sources live in ``csrc/``; ``_build`` compiles them with ``nvcc`` at first
use. Each wrapper counts its launches in a plain integer attribute.
"""

#: kernel sources this package builds (``csrc/<name>.cu``)
KERNEL_SOURCES = ("flash_fwd",)
