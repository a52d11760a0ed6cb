"""h5py-facing user utilities — counterpart of the reference's header-only
helpers (``vbz_plugin/vbz_plugin_user_utils.h:16-62``: ``vbz_filter_enable``
and ``vbz_register``).

The port's copy of ``vbz_compression_tpu.utils.h5py_helpers``. The filter
that :func:`register_plugin` puts on HDF5's plugin path is the native C++
plugin (``native/vbz_hdf_plugin.cpp``), which :mod:`._native_build` builds
into a directory of its own under ``build/native/`` at the first call.
These make "write a vbz dataset from Python" a one-liner:

    from vbz_compression_tpu_torch.utils import h5py_helpers as vbz5
    vbz5.register_plugin()
    f.create_dataset("signal", data=sig, **vbz5.dataset_opts())
"""

from __future__ import annotations

import os

import numpy as np

from ..options import CompressionOptions
from . import _native_build

VBZ_FILTER_ID = 32020
# The plugin helper's default written version is 1 (reference:
# vbz_plugin_user_utils.h:6 FILTER_VBZ_VERSION), while the core library
# default is 0 (vbz.h:11) — we keep the library default here and let callers
# opt into v1 explicitly.
DEFAULT_WRITE_VERSION = 0


def plugin_dir() -> str:
    """Directory holding the native filter plugin, built on first use (it
    holds no other library, so HDF5 loads nothing else from it)."""
    return str(_native_build.library("vbz_hdf_plugin").parent)


def register_plugin(path: str | None = None) -> bool:
    """Add the native plugin directory to HDF5's plugin search path
    (the runtime equivalent of ``vbz_register``). Returns False when
    ``path`` holds no plugin library."""
    import h5py

    d = path or plugin_dir()
    if not os.path.exists(os.path.join(d, "libvbz_hdf_plugin.so")):
        return False
    existing = [h5py.h5pl.get(i).decode() for i in range(h5py.h5pl.size())]
    if d not in existing:
        h5py.h5pl.prepend(d.encode())
    return True


def dataset_opts(dtype=np.int16, zigzag: bool | None = None,
                 zstd_level: int = 1,
                 version: int = DEFAULT_WRITE_VERSION) -> dict:
    """``create_dataset`` kwargs enabling the vbz filter — the pythonic
    ``vbz_filter_enable_versioned``."""
    opts = CompressionOptions.for_dtype(
        np.dtype(dtype), zstd_compression_level=zstd_level,
        vbz_version=version)
    if zigzag is not None:
        opts = CompressionOptions(bool(zigzag), opts.integer_size,
                                  zstd_level, version)
    return {"compression": VBZ_FILTER_ID, "compression_opts": opts.cd_values}


def options_of(dset) -> CompressionOptions | None:
    """Read back the vbz options stored on a dataset (None if not vbz)."""
    from .hdf5_chunks import dataset_vbz_options

    return dataset_vbz_options(dset)
