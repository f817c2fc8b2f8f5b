"""Host-side utilities (port of ``deeplearning4j_tpu/utils``; reference:
deeplearning4j-core util/ — ModelSerializer, ImageLoader, ArchiveUtils,
DiskBasedQueue, StringGrid, MathUtils), plus the step-keyed checkpoints
and the YAML subset of the configuration documents."""

from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer  # noqa: F401
from deeplearning4j_tpu_torch.utils.archive import unzip_file_to  # noqa: F401
from deeplearning4j_tpu_torch.utils.diskqueue import DiskBasedQueue  # noqa: F401
from deeplearning4j_tpu_torch.utils.stringgrid import StringGrid  # noqa: F401
from deeplearning4j_tpu_torch.utils.image import (  # noqa: F401
    as_matrix,
    as_row_vector,
    decode_png,
    load_image,
    resize,
    save_pgm,
)
