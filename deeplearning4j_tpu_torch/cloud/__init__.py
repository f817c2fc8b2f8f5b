"""Cloud provisioning (port of ``deeplearning4j_tpu/cloud``; reference:
deeplearning4j-aws — EC2/S3 → a Compute Engine VM with one H100, and GCS)."""

from deeplearning4j_tpu_torch.cloud.provision import (  # noqa: F401
    GcsTransfer,
    GpuProvisioner,
    GpuVmSpec,
)
