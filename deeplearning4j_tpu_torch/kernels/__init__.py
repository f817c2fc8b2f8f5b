"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Sources live in ``csrc/``; ``_build`` compiles them with ``nvcc`` at first
use. Each wrapper counts its launches in a plain integer attribute.
"""

#: kernel sources this package builds (``csrc/<name>.cu``)
KERNEL_SOURCES = ("flash_fwd", "flash_bwd")

#: widths the padded bf16 tensor-core flash kernels are compiled for: one
#: instantiation of each kernel a width, dispatched by the C entry points
MMA_TIERS = (16, 32, 48, 64, 80, 96, 112, 128, 160, 192, 224, 256)

#: the widest f32 row the float32 flash kernels (3xTF32) keep whole in
#: shared memory; wider rows take their streamed ("wide") kernels
#: (``csrc/flash_bwd.cu``'s note derives it)
F32_TIER_MAX = 128

#: ``nvcc`` flags of each source beyond ``_build.NVCC_FLAGS``: the flash
#: sources take ``F32_TIER_MAX`` and the tier list as
#: ``DL4J_MMA_TIERS``, an X-macro of ``DL4J_TIER(width)`` entries
SOURCE_FLAGS = {
    name: ("-DDL4J_F32_TIER_MAX=%d" % F32_TIER_MAX,
           "-DDL4J_MMA_TIERS=" + "".join(f"DL4J_TIER({t})"
                                         for t in MMA_TIERS))
    for name in ("flash_fwd", "flash_bwd")}
