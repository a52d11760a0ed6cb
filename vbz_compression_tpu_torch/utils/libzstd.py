"""ctypes binding to libzstd's runtime library, ``libzstd.so.1``: the api's
zstd stage where the ``zstandard`` package is not installed.

A machine without that package and without libzstd's development files
(no ``zstd.h``) still has the runtime library. This module calls it
directly, in the manner of :mod:`..native_backend`: it declares only
functions of zstd.h's stable section, all present since libzstd v1.4.0,
with every ``restype`` and ``argtypes`` set, and loads the library at the
first call (``libzstd.so.1`` by name, then
``ctypes.util.find_library("zstd")``), never at import. It imports neither
``zstandard`` nor the JAX package.

- :func:`compress` writes the frames that ``api.zstd_compress`` writes
  through ``zstandard``: the tuned double-fast profile at level 1, the
  library's level elsewhere, the content size in the header and no
  checksum. Each thread keeps one compression context per level: the batch
  API's pool calls from many threads, and ctypes releases the interpreter
  lock for every call, so a shared context would race.
- :func:`frame_content_size` and :func:`decompress` read what
  ``zstandard.get_frame_parameters`` and
  ``zstandard.ZstdDecompressor().decompress(data, max_output_size=...)``
  read: the first frame only, with trailing bytes ignored, decoded to its
  header's content size (or, where the header has none, to at most the
  caller's size). Every failure is ``VbzError(VBZ_ZSTD_ERROR)``, with the
  library's error name.

Every call into the library is counted in ``CALLS[name]``, so tests and
``chip_smoke.py`` can tell which library ran.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import threading
import weakref

import numpy as np

from ..errors import VBZ_ZSTD_ERROR, VbzError

_NAMES = ("libzstd.so.1",)  # then find_library("zstd")

_sz, _vp, _int = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int
_src = ctypes.c_char_p  # a bytes object passes without a copy
# entry point -> (restype, argtypes); size_t results stay c_size_t and the
# content size c_ulonglong, or error codes are cut to int.
_SIGNATURES = {
    "ZSTD_versionNumber": (ctypes.c_uint, []),
    "ZSTD_isError": (ctypes.c_uint, [_sz]),
    "ZSTD_getErrorName": (ctypes.c_char_p, [_sz]),
    "ZSTD_compressBound": (_sz, [_sz]),
    "ZSTD_maxCLevel": (_int, []),
    "ZSTD_minCLevel": (_int, []),
    "ZSTD_createCCtx": (_vp, []),
    "ZSTD_freeCCtx": (_sz, [_vp]),
    "ZSTD_CCtx_setParameter": (_sz, [_vp, _int, _int]),
    "ZSTD_compress2": (_sz, [_vp, _vp, _sz, _src, _sz]),
    "ZSTD_getFrameContentSize": (ctypes.c_ulonglong, [_src, _sz]),
    "ZSTD_findFrameCompressedSize": (_sz, [_src, _sz]),
    "ZSTD_decompress": (_sz, [_vp, _sz, _src, _sz]),
}

CALLS = dict.fromkeys(_SIGNATURES, 0)
_LOCK = threading.Lock()  # the batch API calls from a thread pool

CONTENTSIZE_UNKNOWN = 2**64 - 1
CONTENTSIZE_ERROR = 2**64 - 2
MIN_LEVEL = -131072  # the JAX api's lower clamp

# ZSTD_cParameter values (zstd.h, stable since v1.4.0).
C_COMPRESSION_LEVEL = 100
C_WINDOW_LOG, C_HASH_LOG, C_CHAIN_LOG = 101, 102, 103
C_SEARCH_LOG, C_MIN_MATCH, C_TARGET_LENGTH, C_STRATEGY = 104, 105, 106, 107
C_CONTENT_SIZE_FLAG, C_CHECKSUM_FLAG = 200, 201
DFAST = 2  # ZSTD_dfast
# The level-1 profile of api.zstd_compress (the zstandard route's
# ZstdCompressionParameters): double fast, a 512 KiB window.
LEVEL1_PARAMS = (
    (C_WINDOW_LOG, 19), (C_CHAIN_LOG, 14), (C_HASH_LOG, 16),
    (C_SEARCH_LOG, 1), (C_MIN_MATCH, 5), (C_TARGET_LENGTH, 0),
    (C_STRATEGY, DFAST), (C_CONTENT_SIZE_FLAG, 1), (C_CHECKSUM_FLAG, 0),
)

# A skippable frame's magic numbers are 0x184D2A50-0x184D2A5F, its size the
# next 4 bytes (RFC 8878, 3.1.2); zstandard reports that size as the
# frame's content size.
_SKIPPABLE_MAGIC, _SKIPPABLE_MASK = 0x184D2A50, 0xFFFFFFF0


def _call(so: ctypes.CDLL, name: str, *args):
    with _LOCK:
        CALLS[name] += 1
    return getattr(so, name)(*args)


def _error(so: ctypes.CDLL, code: int) -> str:
    return _call(so, "ZSTD_getErrorName", code).decode()


def _checked(so: ctypes.CDLL, result: int) -> int:
    """``result``, or ``VbzError(VBZ_ZSTD_ERROR)`` where it is an error
    code."""
    if _call(so, "ZSTD_isError", result):
        raise VbzError(VBZ_ZSTD_ERROR, _error(so, result))
    return result


class _CCtx:
    """One ``ZSTD_CCtx`` with its parameters set once, freed with the
    object (the thread's locals die with the thread)."""

    def __init__(self, so: ctypes.CDLL, level: int):
        self.ptr = _call(so, "ZSTD_createCCtx")
        if not self.ptr:
            raise MemoryError("ZSTD_createCCtx returned NULL")
        weakref.finalize(self, _call, so, "ZSTD_freeCCtx", self.ptr)
        params = (LEVEL1_PARAMS if level == 1 else
                  ((C_COMPRESSION_LEVEL, level), (C_CONTENT_SIZE_FLAG, 1),
                   (C_CHECKSUM_FLAG, 0)))
        for key, value in params:
            _checked(so, _call(so, "ZSTD_CCtx_setParameter", self.ptr, key,
                               value))


class Binding:
    """The loaded library, its maximum level and each thread's compression
    contexts."""

    def __init__(self, so: ctypes.CDLL):
        self.so = so
        self.name = so._name
        self.max_level = _call(so, "ZSTD_maxCLevel")
        self._local = threading.local()

    def cctx(self, level: int):
        contexts = self._local.__dict__.setdefault("by_level", {})
        if level not in contexts:
            contexts[level] = _CCtx(self.so, level)
        return contexts[level].ptr


@functools.cache
def lib() -> Binding:
    """The library, loaded at the first call; ``OSError`` when neither
    ``libzstd.so.1`` nor ``find_library("zstd")`` loads."""
    tried = []
    for name in (*_NAMES, ctypes.util.find_library("zstd")):
        if name is None or name in tried:
            continue
        tried.append(name)
        try:
            so = ctypes.CDLL(name)
        except OSError:
            continue
        for fn, (restype, argtypes) in _SIGNATURES.items():
            getattr(so, fn).restype = restype
            getattr(so, fn).argtypes = argtypes
        return Binding(so)
    raise OSError(f"libzstd not found (tried {tried or list(_NAMES)})")


def call(name: str, *args):
    """``name(*args)`` in the loaded library, counted in ``CALLS``."""
    return _call(lib().so, name, *args)


def version() -> int:
    """``ZSTD_versionNumber()``: 10504 for v1.5.4."""
    return call("ZSTD_versionNumber")


def version_string(number: int | None = None) -> str:
    number = version() if number is None else number
    return f"{number // 10000}.{number // 100 % 100}.{number % 100}"


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    return arr.ctypes.data_as(ctypes.c_void_p)


def compress(data, level: int) -> bytes:
    """One zstd frame of ``data`` at ``level``, clamped to
    [-131072, ZSTD_maxCLevel()] as the JAX api clamps it; level 1 is the
    tuned profile (:data:`LEVEL1_PARAMS`)."""
    b = lib()
    level = max(min(int(level), b.max_level), MIN_LEVEL)
    src = bytes(data)
    cctx = b.cctx(level)
    bound = _call(b.so, "ZSTD_compressBound", len(src))
    out = np.empty(max(bound, 1), np.uint8)
    n = _checked(b.so, _call(b.so, "ZSTD_compress2", cctx, _ptr(out), bound,
                             src, len(src)))
    return out[:n].tobytes()


def _content_size(so: ctypes.CDLL, src: bytes) -> int:
    """The content size zstandard reads from the header: a skippable
    frame's size for a skippable frame, else ``ZSTD_getFrameContentSize``
    (which gives 0 for one)."""
    if len(src) >= 8 and (int.from_bytes(src[:4], "little")
                          & _SKIPPABLE_MASK) == _SKIPPABLE_MAGIC:
        return int.from_bytes(src[4:8], "little")
    return _call(so, "ZSTD_getFrameContentSize", src, len(src))


def frame_content_size(data) -> int:
    """The first frame's content size; ``VbzError(VBZ_ZSTD_ERROR)`` when
    the header is invalid or holds no content size (``vbz/vbz.cpp:236-240``,
    ``api.zstd_frame_content_size``)."""
    src = bytes(data)
    size = _content_size(lib().so, src)
    if size in (CONTENTSIZE_UNKNOWN, CONTENTSIZE_ERROR):
        raise VbzError(VBZ_ZSTD_ERROR, "unknown frame content size")
    return size


def decompress(data, expected_size: int) -> bytes:
    """The first frame of ``data`` decoded, as
    ``zstandard.ZstdDecompressor().decompress(data,
    max_output_size=max(expected_size, 1))`` decodes it: bytes after the
    frame are ignored, a header without a content size decodes into at most
    ``max(expected_size, 1)`` bytes, a content size of 0 gives ``b""``."""
    so = lib().so
    src = bytes(data)
    size = _content_size(so, src)
    if size == CONTENTSIZE_ERROR:
        raise VbzError(VBZ_ZSTD_ERROR,
                       "error determining content size from frame header")
    if size == 0:
        return b""
    capacity = max(expected_size, 1) if size == CONTENTSIZE_UNKNOWN else size
    # ZSTD_decompress would read every frame in src and reject trailing
    # bytes: bound it to the first frame.
    n_in = _checked(so, _call(so, "ZSTD_findFrameCompressedSize", src,
                              len(src)))
    out = np.empty(capacity, np.uint8)
    n = _checked(so, _call(so, "ZSTD_decompress", _ptr(out), capacity, src,
                           n_in))
    if size != CONTENTSIZE_UNKNOWN and n != size:
        raise VbzError(VBZ_ZSTD_ERROR,
                       f"decompressed {n} bytes; expected {size}")
    return out[:n].tobytes()
