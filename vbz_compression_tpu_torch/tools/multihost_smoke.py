"""One process of a multi-process corpus run, on the PyTorch port: the
counterpart of the JAX package's ``tools/multihost_smoke.py``.

    python -m vbz_compression_tpu_torch.tools.multihost_smoke \\
        INIT WORLD RANK OUT_DIR PATH... [--backend gloo|nccl] \\
        [--zstd-level L]

joins the process group at ``INIT`` (``file://...`` or ``tcp://host:port``)
as rank ``RANK`` of ``WORLD``, compresses its round-robin share of the gzip
fast5 files ``PATH...`` into ``OUT_DIR/<name>.vbz`` and prints one JSON line
of the global corpus stats, the same on every rank, with this process's
kernel launches, its zstd stage's route (``api.zstd_route``) and its
calls of ``ZSTD_compress2`` through ``libzstd.so.1`` (0 where the
``zstandard`` package runs the stage). Each rank runs on its card,
``cuda:<rank % device_count>``
(``VBZ_BACKEND=torch``: the CPU). With
``--pseudo-reads N --files F`` in place of paths it compresses the
pseudo-read corpus (:func:`..signals.pseudo_reads`) split into ``F``
in-memory files (:func:`pseudo_files`), which needs no h5py.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def pseudo_files(n_reads: int, files: int) -> dict:
    """``{file name: {read name: signal}}``: file ``k`` holds the pseudo
    reads ``k, k + files, ...`` of ``signals.pseudo_reads(n_reads)``."""
    from ..signals import pseudo_reads

    reads = pseudo_reads(n_reads)
    return {f"pseudo_{k}.fast5": {f"read_{i:04d}": reads[i]
                                  for i in range(k, n_reads, files)}
            for k in range(files)}


def main(argv=None) -> int:
    import torch.distributed as dist

    from .. import api
    from ..ops import svb_v1, svb_w2, svb_w4
    from ..options import CompressionOptions
    from ..parallel import multihost
    from ..utils import libzstd

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("init_method")
    parser.add_argument("world", type=int)
    parser.add_argument("rank", type=int)
    parser.add_argument("out_dir")
    parser.add_argument("paths", nargs="*")
    parser.add_argument("--backend", default=None,
                        help="process-group backend (default: nccl with a "
                             "card, else gloo)")
    parser.add_argument("--zstd-level", type=int, default=1)
    parser.add_argument("--pseudo-reads", type=int, default=0)
    parser.add_argument("--files", type=int, default=2)
    args = parser.parse_args(argv)

    read = None
    paths = args.paths
    if args.pseudo_reads:
        shares = pseudo_files(args.pseudo_reads, args.files)
        paths, read = sorted(shares), shares.__getitem__
    group = multihost.initialize(args.init_method, args.world, args.rank,
                                 args.backend)
    try:
        t0 = time.perf_counter()
        stats = multihost.compress_corpus(
            paths, out_dir=args.out_dir,
            options=CompressionOptions(True, 2, args.zstd_level, 0),
            group=group, read=read)
        seconds = time.perf_counter() - t0
    finally:
        if group is not None:
            dist.destroy_process_group()
    print(json.dumps({
        "rank": args.rank, "world": args.world, "files": stats.files,
        "reads": stats.reads, "raw_bytes": stats.raw_bytes,
        "compressed_bytes": stats.compressed_bytes,
        "ratio": stats.ratio, "seconds": seconds,
        "zstd_level": args.zstd_level,
        "zstd_route": api.zstd_route() if args.zstd_level else None,
        "libzstd_compress_calls": libzstd.CALLS["ZSTD_compress2"],
        "launches": {f"{name}_{d}": n for name, m in (
            ("w2", svb_w2), ("w4", svb_w4), ("v1", svb_v1))
            for d, n in (("encode", m.ENCODE_LAUNCHES),
                         ("decode", m.DECODE_LAUNCHES)) if n}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
