"""The benchmark's own ctypes binding to libzstd (``libzstd.so.1``), for
the plain reference: one frame a call, with the parameters a configuration
states, and the first frame of a buffer decoded to its header's content
size. It shares nothing with the program's binding."""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import threading
import weakref

import numpy as np

# ZSTD_cParameter and ZSTD_strategy values, zstd.h's stable section.
PARAMETERS = {"compressionLevel": 100, "windowLog": 101, "hashLog": 102,
              "chainLog": 103, "searchLog": 104, "minMatch": 105,
              "targetLength": 106, "strategy": 107, "contentSizeFlag": 200,
              "checksumFlag": 201}
CONTENTSIZE_UNKNOWN = 2**64 - 1
CONTENTSIZE_ERROR = 2**64 - 2

_sz, _vp = ctypes.c_size_t, ctypes.c_void_p
_SIGNATURES = {
    "ZSTD_isError": (ctypes.c_uint, [_sz]),
    "ZSTD_getErrorName": (ctypes.c_char_p, [_sz]),
    "ZSTD_compressBound": (_sz, [_sz]),
    "ZSTD_createCCtx": (_vp, []),
    "ZSTD_freeCCtx": (_sz, [_vp]),
    "ZSTD_CCtx_setParameter": (_sz, [_vp, ctypes.c_int, ctypes.c_int]),
    "ZSTD_compress2": (_sz, [_vp, _vp, _sz, ctypes.c_char_p, _sz]),
    "ZSTD_getFrameContentSize": (ctypes.c_ulonglong, [ctypes.c_char_p, _sz]),
    "ZSTD_findFrameCompressedSize": (_sz, [ctypes.c_char_p, _sz]),
    "ZSTD_decompress": (_sz, [_vp, _sz, ctypes.c_char_p, _sz]),
}


class ZstdError(Exception):
    """A libzstd error code, with the library's name for it."""


@functools.cache
def lib() -> ctypes.CDLL:
    for name in ("libzstd.so.1", ctypes.util.find_library("zstd")):
        if name is None:
            continue
        try:
            so = ctypes.CDLL(name)
        except OSError:
            continue
        for fn, (restype, argtypes) in _SIGNATURES.items():
            getattr(so, fn).restype = restype
            getattr(so, fn).argtypes = argtypes
        return so
    raise OSError("libzstd.so.1 not found")


def _checked(result: int) -> int:
    so = lib()
    if so.ZSTD_isError(result):
        raise ZstdError(so.ZSTD_getErrorName(result).decode())
    return result


class _Context:
    def __init__(self, params: tuple):
        so = lib()
        self.ptr = so.ZSTD_createCCtx()
        if not self.ptr:
            raise MemoryError("ZSTD_createCCtx returned NULL")
        weakref.finalize(self, so.ZSTD_freeCCtx, self.ptr)
        for key, value in params:
            _checked(so.ZSTD_CCtx_setParameter(self.ptr, PARAMETERS[key],
                                               value))


_LOCAL = threading.local()


def compress(data: bytes, params: dict) -> bytes:
    """One frame of ``data``, the parameters set in the order given (a
    thread keeps one context per parameter set)."""
    key = tuple(params.items())
    contexts = _LOCAL.__dict__.setdefault("contexts", {})
    if key not in contexts:
        contexts[key] = _Context(key)
    so = lib()
    bound = so.ZSTD_compressBound(len(data))
    out = np.empty(max(bound, 1), np.uint8)
    n = _checked(so.ZSTD_compress2(contexts[key].ptr,
                                   out.ctypes.data_as(_vp), bound, data,
                                   len(data)))
    return out[:n].tobytes()


def decompress(frame: bytes) -> bytes:
    """The first frame of ``frame``, decoded to its header's content size;
    ``ZstdError`` for anything else."""
    so = lib()
    size = so.ZSTD_getFrameContentSize(frame, len(frame))
    if size in (CONTENTSIZE_UNKNOWN, CONTENTSIZE_ERROR):
        raise ZstdError("no content size in the frame header")
    n_in = _checked(so.ZSTD_findFrameCompressedSize(frame, len(frame)))
    out = np.empty(max(size, 1), np.uint8)
    n = _checked(so.ZSTD_decompress(out.ctypes.data_as(_vp), size, frame,
                                    n_in))
    if n != size:
        raise ZstdError(f"decoded {n} bytes, header says {size}")
    return out[:n].tobytes()
