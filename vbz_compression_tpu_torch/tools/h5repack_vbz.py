"""h5repack-compatible dataset rewriter for user-defined filters.

The port's copy of ``vbz_compression_tpu.tools.h5repack_vbz``. The
reference QA tier shells out to the HDF5 tools' ``h5repack -f
UD=32020,<flag>,<ncd>,<cd...>`` to prove the filter plugin works through
stock tooling (reference: python/test/test_repack.py:15-44). This CLI
implements the same contract — parse the ``UD=`` filter spec, copy every
dataset into a new file re-encoded through the dynamically loaded plugin
(h5py routes the filter through the identical libhdf5 ``H5PL`` plugin-load
path h5repack uses) — so environments without the HDF5 tools still
exercise it end to end. For filter 32020 it puts the port's native plugin
on the plugin path first (:func:`..utils.h5py_helpers.register_plugin`,
built at first use); a plugin on ``HDF5_PLUGIN_PATH`` is still found.

Usage::

    python -m vbz_compression_tpu_torch.tools.h5repack_vbz \\
        -f UD=32020,0,4,0,2,1,1 in.h5 out.h5
"""

from __future__ import annotations

import argparse
import sys

from ..utils import h5py_helpers


def parse_ud(spec: str) -> tuple[int, tuple[int, ...]]:
    """Parse ``UD=<filter_id>,<flag>,<ncd>,<cd...>`` (h5repack syntax).

    Returns ``(filter_id, cd_values)``; the flag (0 mandatory / 1 optional)
    is accepted and ignored, as h5repack's rewrite path does for UD."""
    if not spec.startswith("UD="):
        raise ValueError(f"only UD= filter specs are supported, got {spec!r}")
    parts = [int(p) for p in spec[3:].split(",")]
    if len(parts) < 3:
        raise ValueError("UD spec needs <id>,<flag>,<ncd>[,<cd...>]")
    fid, _flag, ncd = parts[:3]
    cds = tuple(parts[3:])
    if len(cds) != ncd:
        raise ValueError(f"UD spec declares {ncd} cd_values, got {len(cds)}")
    return fid, cds


def repack(src: str, dst: str, filter_id: int, cd_values: tuple[int, ...],
           chunk: int | None = None) -> None:
    import h5py

    if filter_id == h5py_helpers.VBZ_FILTER_ID:
        h5py_helpers.register_plugin()

    def copy(name, obj, fout):
        if isinstance(obj, h5py.Group):
            g = fout.require_group(name) if name else fout["/"]
            for k, v in obj.attrs.items():
                g.attrs[k] = v
            return
        kwargs = {}
        if obj.ndim == 1 and obj.shape[0] > 0 and (obj.chunks or chunk):
            kwargs = dict(chunks=obj.chunks or (min(chunk, obj.shape[0]),),
                          compression=filter_id, compression_opts=cd_values)
        elif obj.chunks:
            # Scalar / N-d / empty datasets pass through unfiltered (stock
            # h5repack likewise skips datasets a UD filter can't apply to)
            # but keep their chunking.
            kwargs = dict(chunks=obj.chunks)
        d = fout.create_dataset(name, data=obj[...], dtype=obj.dtype,
                                **kwargs)
        for k, v in obj.attrs.items():
            d.attrs[k] = v

    with h5py.File(src, "r") as fin, h5py.File(dst, "w") as fout:
        for k, v in fin.attrs.items():
            fout.attrs[k] = v
        fin.visititems(lambda n, o: copy(n, o, fout))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="h5repack-compatible rewrite through a UD filter")
    ap.add_argument("-f", "--filter", required=True,
                    help="UD=<id>,<flag>,<ncd>,<cd...> (h5repack syntax)")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--chunk", type=int, default=65536,
                    help="chunk rows for datasets stored contiguous")
    args = ap.parse_args(argv)
    try:
        fid, cds = parse_ud(args.filter)
        repack(args.src, args.dst, fid, cds, chunk=args.chunk)
    except Exception as exc:
        print(f"h5repack_vbz: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
