"""The VBZ sized pipeline on the PyTorch backend.

Thin: option validation, the zstd stage and the 4-byte sized framing are the
JAX package's host code (``vbz_compression_tpu.api``, which imports no JAX);
each function here calls it with ``backend=`` set to a
:class:`~.models.codec.TorchSvbBackend`.

``default_backend()`` is the CUDA backend when a card is visible. Setting
``VBZ_BACKEND=torch`` chooses the plain PyTorch version on the CPU instead.
Without either it raises: nothing moves silently to another codec.
"""

from __future__ import annotations

import os

import torch

from vbz_compression_tpu import api as _pipeline

from .models.codec import TorchSvbBackend


def default_backend() -> TorchSvbBackend:
    forced = os.environ.get("VBZ_BACKEND", "").lower()
    if forced == "torch":
        return TorchSvbBackend("cpu")
    if forced:
        raise ValueError(f"unknown VBZ_BACKEND {forced!r} for the PyTorch "
                         "port (want torch, or leave it unset)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible; set VBZ_BACKEND=torch to "
                           "run the plain PyTorch version on the CPU")
    return TorchSvbBackend("cuda")


def _resolved(backend):
    return default_backend() if backend is None else backend


def vbz_compress_sized(data, options, backend=None) -> bytes:
    return _pipeline.vbz_compress_sized(data, options,
                                        backend=_resolved(backend))


def vbz_decompress_sized(stream, options, backend=None) -> bytes:
    return _pipeline.vbz_decompress_sized(stream, options,
                                          backend=_resolved(backend))


def vbz_compress_sized_batch(chunks, options, backend=None) -> list:
    return _pipeline.vbz_compress_sized_batch(chunks, options,
                                              backend=_resolved(backend))


def vbz_decompress_sized_batch(streams, options, backend=None) -> list:
    return _pipeline.vbz_decompress_sized_batch(streams, options,
                                                backend=_resolved(backend))


def compress(data, options=None, backend=None):
    """pyvbz-style: numpy array -> sized stream as a uint8 array."""
    return _pipeline.compress(data, options, backend=_resolved(backend))


def decompress(data, dtype, options=None, backend=None):
    """pyvbz-style: sized stream -> numpy array of ``dtype``."""
    return _pipeline.decompress(data, dtype, options,
                                backend=_resolved(backend))
