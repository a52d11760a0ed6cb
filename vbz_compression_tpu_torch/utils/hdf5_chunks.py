"""Raw HDF5 chunk access for fast5 files.

The port's copy of ``vbz_compression_tpu.utils.hdf5_chunks``, over the
port's own ``options``; ``tests/test_torch_fast5vbz.py`` holds it to the
original. It reads the compressed chunk bytes of filter-32020 datasets
directly (h5py low-level ``read_direct_chunk``), so vbz-compressed fast5
files can be decoded without any HDF5 filter plugin installed. fast5 layout:
one chunk per read's ``Raw/Signal`` dataset (reference:
``python/fast5compress/fast5vbz.py:43-55``). h5py is imported by the
functions that open files, so importing this module needs none.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..options import CompressionOptions

VBZ_FILTER_ID = 32020  # reference: vbz_plugin/vbz_plugin.h:5


def iter_signal_datasets(h5file) -> Iterator[tuple[str, "object"]]:
    """Yield ``(read_name, dataset)`` for every ``read_*/Raw/Signal``."""
    for name in sorted(h5file.keys()):
        if name.startswith("read_") or name.startswith("Raw"):
            grp = h5file[name]
            if "Raw/Signal" in grp:
                yield name, grp["Raw/Signal"]


def dataset_vbz_options(dset) -> CompressionOptions | None:
    """Parse the stored cd_values of the vbz filter from a dataset's creation
    property list; None when the dataset is not vbz-compressed."""
    plist = dset.id.get_create_plist()
    for i in range(plist.get_nfilters()):
        code, _flags, cd_values, _name = plist.get_filter(i)
        if code == VBZ_FILTER_ID:
            return CompressionOptions.from_cd_values(list(cd_values))
    return None


def read_raw_chunks(dset) -> list[tuple[tuple, bytes]]:
    """Return ``[(chunk_offset, raw_filtered_bytes), ...]`` for a chunked
    dataset, bypassing the filter pipeline."""
    out = []
    dsid = dset.id
    num = dsid.get_num_chunks()
    for i in range(num):
        info = dsid.get_chunk_info(i)
        _filter_mask, data = dsid.read_direct_chunk(info.chunk_offset)
        out.append((info.chunk_offset, data))
    return out


def iter_vbz_signal_chunks(path) -> Iterator[tuple[str, CompressionOptions, bytes, int]]:
    """Yield ``(read_name, options, raw_chunk_bytes, n_elements)`` for each
    vbz-compressed signal in a fast5 file."""
    import h5py

    # No h5py handle may be held across a yield: a generator holding an open
    # File raises from h5py teardown when a partially-consumed iterator is
    # GC'd at interpreter shutdown (the with-exit runs after h5py's globals
    # clear). Materializing the WHOLE file before yielding (the round-2 fix)
    # made memory grow with file size; instead list the dataset names first,
    # then materialize one dataset's chunks at a time with a short-lived
    # reopen — memory is bounded by one dataset and the File is always
    # closed before control leaves this frame.
    with h5py.File(path, "r") as f:
        names = [name for name, _ in iter_signal_datasets(f)]
    for name in names:
        items = []
        with h5py.File(path, "r") as f:
            dset = f[name]["Raw/Signal"]
            opts = dataset_vbz_options(dset)
            if opts is not None:
                for _off, data in read_raw_chunks(dset):
                    items.append((name, opts, data, dset.shape[0]))
        yield from items


def read_gzip_signals(path) -> dict[str, np.ndarray]:
    """Read all signals from a (plugin-free) gzip fast5 — the comparison oracle."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for name, dset in iter_signal_datasets(f):
            out[name] = dset[...]
    return out
