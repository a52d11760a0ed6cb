"""ctypes wrapper over the native fast5 chunk iterator (libfast5_reader.so).

The port's copy of ``vbz_compression_tpu.utils.native_fast5``. The native
reader (``native/fast5_reader.cpp``, built by :mod:`._native_build` into
``build/native/`` at first use) dlopens libhdf5 at runtime and reads *raw,
still-compressed* HDF5 chunks plus the filter metadata, so bulk corpus jobs
can feed the codec without h5py (and its per-chunk Python filter round
trips) in the loop. Mirrors the role of the reference's
``vbz_plugin/hdf5_dynamic.h`` late-binding shim.

libhdf5 is h5py's bundled copy where h5py is installed (it matches the
files h5py writes), else the system's (``ctypes.util.find_library``), else
the names the reader tries itself.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
from dataclasses import dataclass

from . import _native_build

_lib = None


def _find_hdf5() -> str | None:
    """h5py's bundled libhdf5 first (matches the files it writes), then the
    system's."""
    try:
        import h5py

        base = os.path.dirname(h5py.__file__)
        for pat in (os.path.join(base, ".libs", "libhdf5-*.so*"),
                    os.path.join(base, ".libs", "libhdf5.so*"),
                    os.path.join(os.path.dirname(base), "h5py.libs",
                                 "libhdf5-*.so*"),
                    os.path.join(os.path.dirname(base), "h5py.libs",
                                 "libhdf5*.so*")):
            hits = sorted(glob.glob(pat))
            if hits:
                return hits[0]
    except ImportError:
        pass
    return ctypes.util.find_library("hdf5")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_native_build.library("fast5_reader")))
    lib.f5r_init.argtypes = [ctypes.c_char_p]
    lib.f5r_init.restype = ctypes.c_int
    lib.f5r_open.argtypes = [ctypes.c_char_p]
    lib.f5r_open.restype = ctypes.c_int64
    lib.f5r_close.argtypes = [ctypes.c_int64]
    lib.f5r_signal_names.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                     ctypes.c_size_t]
    lib.f5r_signal_names.restype = ctypes.c_int
    lib.f5r_dataset_info.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint),
        ctypes.POINTER(ctypes.c_int)]
    lib.f5r_dataset_info.restype = ctypes.c_int
    lib.f5r_chunk_count.argtypes = [ctypes.c_int64, ctypes.c_char_p]
    lib.f5r_chunk_count.restype = ctypes.c_int64
    lib.f5r_chunk_info.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint)]
    lib.f5r_chunk_info.restype = ctypes.c_int
    lib.f5r_read_chunk.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint)]
    lib.f5r_read_chunk.restype = ctypes.c_int64
    hdf5 = _find_hdf5()
    rc = lib.f5r_init(hdf5.encode() if hdf5 else None)
    if rc != 0:
        raise OSError(f"f5r_init failed ({rc}); no usable libhdf5 found")
    _lib = lib
    return lib


@dataclass
class DatasetInfo:
    nelems: int
    filter_id: int
    cd_values: tuple


class Fast5File:
    """Read-only raw-chunk access to a fast5 file via the native reader."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._f = lib.f5r_open(path.encode())
        if self._f < 0:
            raise OSError(f"cannot open {path}")

    def close(self):
        if self._f >= 0:
            self._lib.f5r_close(self._f)
            self._f = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def signal_names(self) -> list[str]:
        buf = ctypes.create_string_buffer(1 << 20)
        n = self._lib.f5r_signal_names(self._f, buf, len(buf))
        if n < 0:
            raise OSError(f"f5r_signal_names failed ({n})")
        return buf.value.decode().split("\n") if n else []

    def dataset_info(self, name: str) -> DatasetInfo:
        nelems = ctypes.c_int64()
        fid = ctypes.c_int()
        cd = (ctypes.c_uint * 16)()
        ncd = ctypes.c_int()
        rc = self._lib.f5r_dataset_info(self._f, name.encode(),
                                        ctypes.byref(nelems),
                                        ctypes.byref(fid), cd,
                                        ctypes.byref(ncd))
        if rc != 0:
            raise OSError(f"f5r_dataset_info({name}) failed")
        return DatasetInfo(nelems.value, fid.value,
                           tuple(cd[i] for i in range(ncd.value)))

    def chunk_count(self, name: str) -> int:
        n = self._lib.f5r_chunk_count(self._f, name.encode())
        if n < 0:
            raise OSError(f"f5r_chunk_count({name}) failed")
        return n

    def read_chunk(self, name: str, idx: int) -> tuple[bytes, int, int]:
        """Returns (raw_bytes, logical_offset, filter_mask)."""
        stored = ctypes.c_int64()
        loff = ctypes.c_int64()
        mask = ctypes.c_uint()
        rc = self._lib.f5r_chunk_info(self._f, name.encode(), idx,
                                      ctypes.byref(stored),
                                      ctypes.byref(loff), ctypes.byref(mask))
        if rc != 0:
            raise OSError(f"f5r_chunk_info({name}, {idx}) failed")
        buf = ctypes.create_string_buffer(stored.value)
        got = self._lib.f5r_read_chunk(self._f, name.encode(), idx, buf,
                                       stored.value, ctypes.byref(mask))
        if got < 0:
            raise OSError(f"f5r_read_chunk({name}, {idx}) failed ({got})")
        return buf.raw[:got], loff.value, mask.value


def options_from_cd(cd_values):
    """cd_values → CompressionOptions: indices [version, integer_size,
    zig_zag, level] with level defaulting to 1 when only 3 are stored
    (reference ``vbz_plugin/vbz_plugin.cpp:114-124``); extras ignored."""
    from ..options import CompressionOptions

    cd = list(cd_values) + [1]
    return CompressionOptions(
        vbz_version=int(cd[0]), integer_size=int(cd[1]),
        perform_delta_zig_zag=bool(cd[2]), zstd_compression_level=int(cd[3]))


def iter_signal_chunks(path: str):
    """Yield (dataset_name, DatasetInfo, raw_chunk_bytes) for every signal
    chunk in a fast5 file — the native counterpart of
    ``utils.hdf5_chunks.iter_vbz_signal_chunks``."""
    with Fast5File(path) as f:
        for name in f.signal_names():
            info = f.dataset_info(name)
            for i in range(f.chunk_count(name)):
                raw, _, mask = f.read_chunk(name, i)
                if mask != 0:
                    continue  # filters skipped for this chunk: not codec data
                yield name, info, raw
