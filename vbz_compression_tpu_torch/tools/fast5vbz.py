"""fast5 re-compression CLI on the PyTorch port: the counterpart of
``vbz_compression_tpu.tools.fast5vbz`` (reference:
``python/fast5compress/fast5vbz.py:17-74``).

Copies a fast5 file and rewrites every ``read_*/Raw/Signal`` dataset with the
vbz filter (one chunk per read, written directly, so no filter plugin is
needed), or back to gzip with ``-d``. vbz inputs are decoded from their raw
chunks by the port's codec, so reading them needs no plugin either.

    python -m vbz_compression_tpu_torch.tools.fast5vbz IN.fast5 OUT.fast5 \\
        [-d] [--vbz-version 0|1] [--zstd-level L] \\
        [--backend auto|torch|oracle|native]

``--backend auto`` runs the card's kernels (E to encode, D to decode),
``torch`` their plain versions on the CPU, ``oracle`` the NumPy codec,
``native`` the native C++ codec (``native_backend``, built at first use).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import api
from ..options import CompressionOptions
from ..utils import hdf5_chunks


def _read_signal(dset, backend):
    """Read a signal dataset, decoding vbz chunks through ``backend`` when
    the dataset carries the vbz filter."""
    opts = hdf5_chunks.dataset_vbz_options(dset)
    if opts is None:
        return dset[...]
    chunks = [data for _off, data in hdf5_chunks.read_raw_chunks(dset)]
    parts = [np.frombuffer(b, dset.dtype) for b in
             api.vbz_decompress_sized_batch(chunks, opts, backend=backend)]
    return np.concatenate(parts) if len(parts) != 1 else parts[0]


def _copy_tree_except_signals(src, dst, signal_paths):
    """Recursively copy ``src`` into ``dst``, skipping the signal datasets
    (copied file space is never reclaimed by HDF5 after a delete, so the
    output is built fresh instead — unlike the reference tool, which
    copy-then-deletes and bloats, ``python/fast5compress/fast5vbz.py:20``)."""
    import h5py

    for k, v in src.attrs.items():
        dst.attrs[k] = v
    for name, item in src.items():
        path = item.name.lstrip("/")
        if path in signal_paths:
            continue
        if isinstance(item, h5py.Group):
            sub = dst.create_group(name)
            _copy_tree_except_signals(item, sub, signal_paths)
        else:
            src.copy(name, dst, name=name)


def compress_fast5(input_path: str, output_path: str, *, decompress: bool,
                   vbz_version: int, zstd_level: int, backend) -> None:
    import h5py

    with h5py.File(input_path, "r") as fin, \
            h5py.File(output_path, "w") as f:
        signals = [(name, _read_signal(dset, backend), dict(dset.attrs))
                   for name, dset in hdf5_chunks.iter_signal_datasets(fin)]
        skip = {f"{name}/Raw/Signal" for name, _sig, _a in signals}
        _copy_tree_except_signals(fin, f, skip)
        opts = CompressionOptions(True, 2, zstd_level, vbz_version)
        if not decompress:
            # One batch for every read's encode (one launch on the card).
            payloads = dict(zip(
                (name for name, _s, _a in signals),
                api.vbz_compress_sized_batch(
                    [sig for _n, sig, _a in signals], opts,
                    backend=backend)))
        for name, signal, attrs in signals:
            grp = f[name]["Raw"]
            if decompress:
                new = grp.create_dataset(
                    "Signal", data=signal, chunks=(max(signal.size, 1),),
                    compression="gzip", compression_opts=1)
            else:
                payload = np.frombuffer(payloads[name], dtype=np.uint8)
                # Write the pre-compressed chunk directly — no plugin needed.
                space = h5py.h5s.create_simple((max(signal.size, 1),))
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_chunk((max(signal.size, 1),))
                dcpl.set_filter(hdf5_chunks.VBZ_FILTER_ID,
                                h5py.h5z.FLAG_OPTIONAL, opts.cd_values)
                did = h5py.h5d.create(
                    grp.id, b"Signal", h5py.h5t.NATIVE_INT16, space, dcpl)
                did.write_direct_chunk((0,), payload.tobytes())
                new = h5py.Dataset(did)
            for k, v in attrs.items():
                new.attrs[k] = v


def backend_of(choice: str):
    """The StreamVByte backend of a ``--backend`` choice."""
    if choice == "auto":
        return api.default_backend()
    if choice == "torch":
        from ..models.codec import TorchSvbBackend

        return TorchSvbBackend("cpu")
    if choice == "native":
        from ..native_backend import native_backend

        return native_backend
    from ..ops import scalar

    return scalar


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Compress fast5 signal data with the vbz codec on "
                    "PyTorch and CUDA")
    parser.add_argument("input", help="input fast5 file")
    parser.add_argument("output", help="output fast5 file")
    parser.add_argument("-d", "--decompress", action="store_true",
                        help="re-encode signals as gzip instead of vbz")
    parser.add_argument("--vbz-version", type=int, default=0, choices=(0, 1))
    parser.add_argument("--zstd-level", type=int, default=1)
    parser.add_argument("--backend",
                        choices=("auto", "torch", "oracle", "native"),
                        default="auto",
                        help="auto = the card's kernels (VBZ_BACKEND=torch: "
                             "the CPU), torch = their plain versions on the "
                             "CPU, oracle = the NumPy codec, native = the "
                             "native C++ codec")
    args = parser.parse_args(argv)
    compress_fast5(args.input, args.output, decompress=args.decompress,
                   vbz_version=args.vbz_version, zstd_level=args.zstd_level,
                   backend=backend_of(args.backend))
    return 0


if __name__ == "__main__":
    sys.exit(main())
