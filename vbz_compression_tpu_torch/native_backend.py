"""ctypes binding to the native C++ runtime codec (``libvbz_native.so``).

The port's copy of ``vbz_compression_tpu.native_backend``: a
zero-dependency ctypes bridge (in place of the reference's cffi layer,
``python/pyvbz/vbz/build.py:29-69``) to the repo's own native library,
which :mod:`.utils._native_build` compiles from ``native/`` into
``build/native/`` at the first call. Exposes both:

- the raw C ABI (``vbz_compress_sized`` etc.) for strict pyvbz parity; it
  runs libzstd in C (stock ``ZSTD_compress`` at the options' level, not
  the api's tuned level-1 profile), a reader of level-1 frames beside the
  api's own zstd stage, which reaches libzstd through ``zstandard`` or,
  where that package is not installed, ``libzstd.so.1``
  (:mod:`.utils.libzstd`);
- the backend interface (``svb_compress``/``svb_decompress``) so the
  pipeline API can run the native codec on the CPU when a caller names it
  (``VBZ_BACKEND=native`` or ``backend=native_backend``).

Every call into the library goes through :func:`call`, which adds one to
``CALLS[name]``, so tests and ``chip_smoke.py`` can tell a native run from
a NumPy one.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np

from .errors import VbzError, vbz_is_error
from .ops.scalar import _SIGNED_FOR_SIZE
from .options import CompressionOptions
from .utils import _native_build


class _CFseTable(ctypes.Structure):
    """vbz_fse_ctable (vbz_native.cpp): one FSE channel's encode tables."""

    _fields_ = [
        ("state_table", ctypes.c_void_p),
        ("delta_nb_bits", ctypes.c_void_p),
        ("delta_find_state", ctypes.c_void_p),
        ("accuracy_log", ctypes.c_int32),
    ]


class _COptions(ctypes.Structure):
    _fields_ = [
        ("perform_delta_zig_zag", ctypes.c_bool),
        ("integer_size", ctypes.c_uint),
        ("zstd_compression_level", ctypes.c_uint),
        ("vbz_version", ctypes.c_uint),
    ]


_u32 = ctypes.c_uint32
_vp, _sz, _i64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int64
_OPTS = ctypes.POINTER(_COptions)
_CTP = ctypes.POINTER(_CFseTable)
# entry point -> (restype, argtypes)
_SIGNATURES = {
    "vbz_max_compressed_size": (_u32, [_sz, _OPTS]),
    "vbz_compress": (_u32, [_vp, _sz, _vp, _sz, _OPTS]),
    "vbz_decompress": (_u32, [_vp, _sz, _vp, _sz, _OPTS]),
    "vbz_compress_sized": (_u32, [_vp, _sz, _vp, _sz, _OPTS]),
    "vbz_decompress_sized": (_u32, [_vp, _sz, _vp, _sz, _OPTS]),
    "vbz_decompressed_size": (_u32, [_vp, _sz, _OPTS]),
}
# The from-scratch zstd encoder's native parts (the LZ77 matcher, the
# bitstream packers and the whole-frame encoder, byte-identical to
# ops/zstd_seq.py and ops/zstd_huff.py); bound when the library has them,
# callers probe with hasattr.
_OPTIONAL = {
    "vbz_lz_match_index": (_i64, [_vp, _i64, _vp]),
    "vbz_lz_sequences": (_i64, [_vp, _i64, _i64, _i64, _vp, _vp]),
    "vbz_bits_pack_backward": (_i64, [_vp, _vp, _i64, _vp, _i64]),
    "vbz_zstd_seq_bitstream": (
        _i64, [_i64, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _CTP, _CTP,
               _CTP, _vp, _i64]),
    "vbz_own_zstd_frame": (_i64, [_vp, _i64, _vp, _i64]),
    "vbz_huff_build_codes": (ctypes.c_int32, [_vp, ctypes.c_int32, _vp, _vp]),
}

CALLS = dict.fromkeys([*_SIGNATURES, *_OPTIONAL], 0)
_LOCK = threading.Lock()  # the batch API calls from a thread pool


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises ``RuntimeError`` with
    the compiler's output when it cannot be built."""
    so = ctypes.CDLL(str(_native_build.library("vbz_native")))
    for table, required in ((_SIGNATURES, True), (_OPTIONAL, False)):
        for name, (restype, argtypes) in table.items():
            fn = getattr(so, name) if required else getattr(so, name, None)
            if fn is not None:
                fn.restype = restype
                fn.argtypes = argtypes
    return so


def call(name: str, *args):
    """``lib().name(*args)``, counted in ``CALLS``."""
    with _LOCK:
        CALLS[name] += 1
    return getattr(lib(), name)(*args)


def _copts(options: CompressionOptions) -> _COptions:
    return _COptions(
        bool(options.perform_delta_zig_zag), options.integer_size,
        options.zstd_compression_level, options.vbz_version)


def _buf(data) -> tuple[np.ndarray, int]:
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data).view(np.uint8).ravel()
    else:
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return arr, arr.size


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    return arr.ctypes.data_as(ctypes.c_void_p)


def vbz_compress_sized(data, options: CompressionOptions) -> bytes:
    src, n = _buf(data)
    o = _copts(options)
    bound = call("vbz_max_compressed_size", n, ctypes.byref(o))
    if vbz_is_error(bound):
        raise VbzError(bound)
    out = np.empty(bound, dtype=np.uint8)
    r = call("vbz_compress_sized", _ptr(src), n, _ptr(out), bound,
             ctypes.byref(o))
    if vbz_is_error(r):
        raise VbzError(r)
    return out[:r].tobytes()


def vbz_decompress_sized(data, options: CompressionOptions) -> bytes:
    src, n = _buf(data)
    o = _copts(options)
    size = call("vbz_decompressed_size", _ptr(src), n, ctypes.byref(o))
    if vbz_is_error(size):
        raise VbzError(size)
    out = np.empty(max(size, 1), dtype=np.uint8)
    r = call("vbz_decompress_sized", _ptr(src), n, _ptr(out), size,
             ctypes.byref(o))
    if vbz_is_error(r):
        raise VbzError(r)
    return out[:r].tobytes()


class NativeSvbBackend:
    """StreamVByte-stage backend over the native lib (zstd level forced 0)."""

    # The ctypes calls drop the GIL for the C codec's duration, so the
    # whole-pipeline threaded batch path in api.py actually parallelizes.
    gil_free_svb = True

    def svb_compress(self, data, integer_size: int, use_zigzag: bool,
                     version: int) -> bytes:
        src, n = _buf(data)
        o = _COptions(bool(use_zigzag), integer_size, 0, version)
        bound = call("vbz_max_compressed_size", n, ctypes.byref(o))
        if vbz_is_error(bound):
            raise VbzError(bound)
        out = np.empty(bound, dtype=np.uint8)
        r = call("vbz_compress", _ptr(src), n, _ptr(out), bound,
                 ctypes.byref(o))
        if vbz_is_error(r):
            raise VbzError(r)
        return out[:r].tobytes()

    def svb_decompress(self, stream, count: int, integer_size: int,
                       use_zigzag: bool, version: int) -> np.ndarray:
        src, n = _buf(stream)
        o = _COptions(bool(use_zigzag), integer_size, 0, version)
        out = np.empty(max(count * integer_size, 1), dtype=np.uint8)
        r = call("vbz_decompress", _ptr(src), n, _ptr(out),
                 count * integer_size, ctypes.byref(o))
        if vbz_is_error(r):
            raise VbzError(r)
        return out[: count * integer_size].view(_SIGNED_FOR_SIZE[integer_size])


native_backend = NativeSvbBackend()
