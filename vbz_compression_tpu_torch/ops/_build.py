"""Build and load the port's CUDA kernels.

Each source of ``SOURCES`` (the three codecs, ``copy.cu``, ``probe.cu``
and the match scan ``match_scan.cu``) is compiled by ``nvcc`` into a shared
library of its own with a plain C interface, ``libvbz_<name>.so``, and
loaded with :mod:`ctypes`, so no PyTorch headers are compiled. The headers
(``csrc/*.cuh``) are part of every library's content hash, so editing one
rebuilds all of them. Libraries land in
``build/torch_kernels/<hash>/libvbz_<name>.so`` at the root of the checkout,
keyed by the source, the headers and the flags, and are built at the first
call that needs them (never at import: machines without ``nvcc`` import this
module too). :func:`build_all` starts one ``nvcc`` per source, all at once.
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

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# library -> its source in csrc/.
SOURCES = {"w2": "w2_codec.cu", "w4": "w4_codec.cu", "v1": "v1_codec.cu",
           "copy": "copy.cu", "probe": "probe.cu", "match": "match_scan.cu"}
# library -> entry point -> argtypes; every entry point returns a
# cudaError_t as int.
_SIGNATURES = {
    "w2": {
        "vbz_w2_tile": [],
        # x, lens, keys, data, data_len, scratch, B, N, elem_bytes, stream
        "vbz_w2_encode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        # keys, data, counts, out, scratch, B, N, D, elem_bytes, stream
        "vbz_w2_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # streams, counts, stream_lens, out, ok, scratch (any state, zeroed
        # by the entry point), scratch_words, B, N, M, elem_bytes, stream
        "vbz_w2_decode_streams": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                  _P],
    },
    "w4": {
        "vbz_w4_encode_tile": [],
        "vbz_w4_decode_tile": [],
        # x, lens, keys, data, data_len, scratch (zeroed look-back state),
        # B, N, elem_bytes, zigzag, stream
        "vbz_w4_encode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # keys, data, counts, out, scratch (zeroed look-back state), B, N,
        # D, elem_bytes, zigzag, stream
        "vbz_w4_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "v1": {
        "vbz_v1_encode_tile": [],
        "vbz_v1_decode_tile": [],
        # x, lens, keys, data, data_len, scratch (zeroed look-back state),
        # B, N, zigzag, stream
        "vbz_v1_encode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        # keys, data, counts, out, scratch (zeroed look-back state), B, N,
        # D, zigzag, stream
        "vbz_v1_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "copy": {
        # x, out, tiles, rows, stream
        "vbz_copy_blocked": [_P, _P, _L, _I, _P],
    },
    "probe": {
        # x, out, R, L, a_rows, a_lanes, stream
        "vbz_probe_roll": [_P, _P, _I, _I, _I, _I, _P],
        # x, out, n, a, stream
        "vbz_probe_flat_shift_right": [_P, _P, _L, _L, _P],
        "vbz_probe_prefix_sum_cluster_values": [],
        "vbz_probe_prefix_sum_tile": [],
        # x, out, n, scratch (zeroed look-back state), stream
        "vbz_probe_prefix_sum": [_P, _P, _L, _P, _P],
        # x, buf, off, n, stream
        "vbz_probe_store_bytes": [_P, _P, _L, _L, _P],
        # buf, out, off, n, stream
        "vbz_probe_load_bytes": [_P, _P, _L, _L, _P],
        # codes, keys, nkeys, stream
        "vbz_probe_pack_keys": [_P, _P, _L, _P],
        # keys, codes, nkeys, stream
        "vbz_probe_unpack_keys": [_P, _P, _L, _P],
        # data, out, n, stream
        "vbz_probe_fetch_i32": [_P, _P, _L, _P],
        "vbz_probe_fetch_i8": [_P, _P, _L, _P],
        # stages, n
        "vbz_probe_butterfly_tile": [_I, _L],
        # x, out, n, stages, elem_bytes, stream
        "vbz_probe_butterfly": [_P, _P, _L, _I, _I, _P],
    },
    "match": {
        "vbz_match_tile": [],
        "vbz_match_halo": [],
        # buf, off, n, offsets (a host int32 array), n_offsets, stream
        "vbz_match_candidates": [_P, _P, _L, _P, _I, _P],
        # buf, index, n, offsets (a host int32 array), n_offsets, stream
        "vbz_match_index": [_P, _P, _L, _P, _I, _P],
    },
}
NAMES = tuple(_SIGNATURES)


def _source(name: str) -> Path:
    return CSRC / SOURCES[name]


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [_source(name), *_headers()]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"libvbz_{name}.so"


def build_all(names=NAMES) -> dict:
    """Compile each named library unless its content hash is built already,
    one ``nvcc`` per source, all started together. Returns
    {name: (path, seconds the compile took, 0 when cached)}."""
    jobs, out = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = (path, 0.0)
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(_source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (path, tmp, cmd, proc, time.perf_counter())
    failed = []
    for name, (path, tmp, cmd, proc, t0) in jobs.items():
        _, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{stderr}")
            continue
        os.replace(tmp, path)  # atomic: no other process sees a partial file
        out[name] = (path, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (one of ``NAMES``), built on first
    use."""
    if name not in _SIGNATURES:
        raise ValueError(f"no kernel library {name!r} (want one of {NAMES})")
    path, _ = build_all([name])[name]
    so = ctypes.CDLL(str(path))
    for entry, argtypes in _SIGNATURES[name].items():
        fn = getattr(so, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so
