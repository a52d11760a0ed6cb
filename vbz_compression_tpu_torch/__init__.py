"""vbz_compression_tpu_torch — the VBZ codec on PyTorch and CUDA (Hopper).

The port of ``vbz_compression_tpu`` from JAX on a TPU to PyTorch on an
NVIDIA H100. It keeps its own copies of the host modules (options, errors,
the NumPy oracle, the zstd stage with the from-scratch encoder, and the
sized framing) and replaces the Pallas kernels with CUDA kernels built from
``csrc/``; it imports nothing of the JAX package. Entry points are in :mod:`.api`. ``oracle`` is the NumPy
StreamVByte codec (:mod:`.ops.scalar`): a backend the api accepts as
``backend=`` and the reference the port is checked against.
"""

from .errors import (  # noqa: F401
    VBZ_DESTINATION_SIZE_ERROR,
    VBZ_FIRST_ERROR,
    VBZ_INPUT_SIZE_ERROR,
    VBZ_INTEGER_SIZE_ERROR,
    VBZ_OUT_OF_MEMORY_ERROR,
    VBZ_STREAMVBYTE_STREAM_ERROR,
    VBZ_VERSION_ERROR,
    VBZ_ZSTD_ERROR,
    VbzError,
    vbz_error_string,
    vbz_is_error,
)
from .ops import scalar as oracle  # noqa: F401
from .options import (  # noqa: F401
    VBZ_DEFAULT_VERSION,
    CompressionOptions,
    compression_options,
)
