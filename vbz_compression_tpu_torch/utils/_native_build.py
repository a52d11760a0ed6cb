"""Build the native C++ runtime from the repo's ``native/`` sources.

The port's counterpart of ``native/Makefile``'s three libraries, with its
flags (``g++ -O3 -march=native -std=c++17 -fPIC -Wall -Wextra -shared``):

- ``libvbz_native.so``: the codec, its sized C ABI and the own zstd
  encoder's native parts (``vbz_native.cpp``, ``vbz_own_zstd.cpp``, libzstd);
- ``libvbz_hdf_plugin.so``: the HDF5 filter 32020 (``vbz_hdf_plugin.cpp``,
  ``vbz_native.cpp``, libzstd);
- ``libfast5_reader.so``: the raw chunk reader that dlopens libhdf5
  (``fast5_reader.cpp``, libdl).

Each lands in ``build/native/<hash>/`` at the root of the checkout, built at
the first call that needs it (never at import), one ``g++`` per library,
started together. The hash covers the library's sources, ``native/*.h``,
the flags and the compiler (``g++ --version`` and what ``-march=native``
turns on). Nothing is written into ``native/`` and the libraries that its
Makefile builds there are never loaded.

libzstd: the system's ``<zstd.h>`` and ``-lzstd`` where the header is
installed; else the port's declarations of the part of libzstd's ABI that
the sources call (``native_include/zstd.h``), linked against
``libzstd.so.1``, the runtime library that a machine without the
development package still has.
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
NATIVE = _PKG.parent / "native"
BUILD_ROOT = _PKG.parent / "build" / "native"
ZSTD_ABI = _PKG / "native_include"
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
            "-shared")
# library -> (its sources in native/, the library it links)
LIBRARIES = {
    "vbz_native": (("vbz_native.cpp", "vbz_own_zstd.cpp"), "zstd"),
    "vbz_hdf_plugin": (("vbz_hdf_plugin.cpp", "vbz_native.cpp"), "zstd"),
    "fast5_reader": (("fast5_reader.cpp",), "dl"),
}
# How the libzstd libraries find libzstd: (include flags, link flags).
ZSTD_ROUTES = {
    "system": ((), ("-lzstd",)),
    "declared": (("-I", str(ZSTD_ABI)), ("-l:libzstd.so.1",)),
}


@functools.cache
def zstd_header_error() -> str | None:
    """None when ``#include <zstd.h>`` preprocesses, else the compiler's
    first error line."""
    proc = subprocess.run([CXX, "-E", "-x", "c++", "-", "-o", os.devnull],
                          input="#include <zstd.h>\n", capture_output=True,
                          text=True)
    if proc.returncode == 0:
        return None
    lines = [ln for ln in proc.stderr.splitlines() if "error" in ln]
    return (lines or proc.stderr.splitlines() or ["(no output)"])[0]


def zstd_route() -> str:
    """The key of ``ZSTD_ROUTES`` this machine builds with."""
    return "system" if zstd_header_error() is None else "declared"


@functools.cache
def _compiler_id() -> bytes:
    """``g++ --version`` and the macros ``-march=native`` defines."""
    version = subprocess.run([CXX, "--version"], capture_output=True,
                             check=True).stdout
    macros = subprocess.run([CXX, "-march=native", "-dM", "-E", "-x", "c++",
                             os.devnull], capture_output=True,
                            check=True).stdout
    return version + macros


def command(name: str, out: Path | str, route: str | None = None) -> list:
    """The ``g++`` command that builds library ``name`` into ``out``, with
    libzstd found by ``route`` (this machine's :func:`zstd_route` when
    None)."""
    sources, link = LIBRARIES[name]
    include, libs = (), ("-ldl",)
    if link == "zstd":
        include, libs = ZSTD_ROUTES[route or zstd_route()]
    return [CXX, *CXXFLAGS, *include, "-o", str(out),
            *(str(NATIVE / s) for s in sources), *libs]


def library_path(name: str) -> Path:
    h = hashlib.sha256(_compiler_id())
    h.update(" ".join(command(name, "")).encode())
    for src in [*(NATIVE / s for s in LIBRARIES[name][0]),
                *sorted(NATIVE.glob("*.h")), ZSTD_ABI / "zstd.h"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(names=tuple(LIBRARIES)) -> dict:
    """Compile each named library unless its hash is built already, one
    ``g++`` per library, all started together. Returns {name: (path,
    seconds the compile took, 0 when cached)}; raises ``RuntimeError`` with
    the compiler's stderr when one fails."""
    jobs, out = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = (path, 0.0)
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        # Not *.so: HDF5 loads every library in a plugin directory.
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=path.parent)
        os.close(fd)
        cmd = command(name, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (path, tmp, cmd, proc, time.perf_counter())
    failed = []
    for name, (path, tmp, cmd, proc, t0) in jobs.items():
        _, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"g++ failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{stderr}")
            continue
        os.replace(tmp, path)  # atomic: no other process sees a partial file
        out[name] = (path, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def library(name: str) -> Path:
    """The path of library ``name`` (a key of ``LIBRARIES``), built on
    first use."""
    if name not in LIBRARIES:
        raise ValueError(f"no native library {name!r} (want one of "
                         f"{tuple(LIBRARIES)})")
    return build([name])[name][0]
