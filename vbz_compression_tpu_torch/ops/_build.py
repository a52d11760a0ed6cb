"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` into one shared library with a plain C
interface and loaded with :mod:`ctypes`, so no PyTorch headers are compiled.
The library lands in ``build/torch_kernels/<hash>/libvbz_w2.so`` at
the root of the checkout, keyed by the sources and flags, and is built at the
first call that needs it (never at import: machines without ``nvcc`` import
this module too).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
LIB_NAME = "libvbz_w2.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every entry point returns a cudaError_t as int.
_SIGNATURES = {
    "vbz_w2_tile": [],
    # x, lens, keys, data, data_len, scratch, B, N, elem_bytes, stream
    "vbz_w2_encode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # keys, data, counts, out, scratch, B, N, D, elem_bytes, stream
    "vbz_w2_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[Path, float]:
    """Compile the library unless this content hash is built already.
    Returns its path and the seconds the compile took (0 when cached)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders never see a partial file
    return path, seconds


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    so = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so
