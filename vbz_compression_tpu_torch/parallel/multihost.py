"""The corpus driver: many processes, each compressing its share of a corpus.

The counterpart of ``vbz_compression_tpu.parallel.multihost``. Each process
compresses its round-robin share of fast5 files on its own card, one kernel
launch per bucket of reads (:func:`compress_signals`), and the global corpus
statistics are an ``all_reduce`` SUM over ``torch.distributed``. The
reference has no distributed runtime at all (its parallelism is ``xargs -P``
over files, reference README.md:36-40).

Usage in each process of a run (``torchrun`` sets the env:// variables):

    from vbz_compression_tpu_torch.parallel import multihost
    group = multihost.initialize()
    stats = multihost.compress_corpus(list_of_fast5_paths, out_dir,
                                      group=group)

Differences from the JAX driver, on purpose: signals must be 16-bit and
``integer_size`` 2 (the JAX driver casts every signal to int16 and writes
frames whose header counts the uncast bytes); there is no data-plane choice
or kernel geometry (``plane``, ``block``, ``slack``), because kernel E
encodes every content in one launch; and no ``bucket`` argument, which the
JAX driver reads nowhere.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from .. import api
from ..models import codec
from ..options import CompressionOptions
from ..utils import hdf5_chunks
from . import sharded

MIN_BUCKET = 4096  # the smallest bucket, as in JAX


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None):
    """Join the process group (env:// unless ``init_method`` is given) and
    return it, or do nothing and return None for a single process. The
    backend is NCCL where a card is visible and gloo otherwise, unless
    ``backend`` names one."""
    world = world_size if world_size is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and init_method is None:
        return None
    dist.init_process_group(
        backend or ("nccl" if torch.cuda.is_available() else "gloo"),
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return dist.group.WORLD


def local_init_method() -> str:
    """A ``tcp://localhost:<port>`` rendezvous on a port that is free now,
    for a group whose processes all run on this machine."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


@dataclasses.dataclass
class CorpusStats:
    files: int
    reads: int
    raw_bytes: int
    compressed_bytes: int

    @property
    def ratio(self) -> float:
        return self.compressed_bytes / max(self.raw_bytes, 1)


def _local_share(paths: list[str], group=None) -> list[str]:
    """Round-robin file assignment by rank."""
    rank, world = sharded.rank_world(group)
    return [p for i, p in enumerate(sorted(paths)) if i % world == rank]


def bucket_of(n: int) -> int:
    """The bucket of a read of ``n`` values: the next power of two, at least
    ``MIN_BUCKET``. The reads of a bucket go to the card in one batch."""
    return max(MIN_BUCKET, 1 << (max(int(n) - 1, 1).bit_length()))


def compress_signals(signals: list[np.ndarray],
                     options: CompressionOptions | None = None, *,
                     device=None) -> list[bytes]:
    """Compress a list of 16-bit signals on one device and return sized vbz
    frames in input order.

    Signals are bucketed by padded length (:func:`bucket_of`) and each bucket
    is one batch of the backend (:meth:`..models.codec.TorchSvbBackend.
    svb_compress_batch`): one encode launch (kernel E on zig-zag, E4
    without), its rows' wire streams copied to the host once, then the zstd
    stage threaded across them. ``device`` is the card unless the caller
    names another (:func:`.sharded.rank_device`).
    """
    options = options or CompressionOptions(True, 2, 1, 0)
    options.validate().validate_version()
    if options.integer_size != 2:
        raise ValueError(f"integer_size={options.integer_size}: the corpus "
                         "driver takes 16-bit signals only")
    typed = []
    for s in signals:
        s = np.ascontiguousarray(s).reshape(-1)
        if s.dtype.itemsize != 2:
            raise ValueError(f"a {s.dtype} signal: the corpus driver takes "
                             "16-bit signals only")
        typed.append(s.view(np.int16))
    backend = codec.TorchSvbBackend(sharded.rank_device(None, device))

    out: list[bytes | None] = [None] * len(typed)
    by_bucket: dict[int, list[int]] = {}
    for i, s in enumerate(typed):
        by_bucket.setdefault(bucket_of(s.size), []).append(i)
    for idxs in by_bucket.values():
        frames = api.vbz_compress_sized_batch([typed[i] for i in idxs],
                                              options, backend=backend)
        for i, frame in zip(idxs, frames):
            out[i] = frame
    return out


def compress_corpus(paths: list[str], out_dir: str | None = None,
                    options: CompressionOptions | None = None, *,
                    group=None, device=None, read=None) -> CorpusStats:
    """Compress every signal in this rank's share of ``paths``, writing
    ``<name>.vbz`` (for each read: a u32 length, then its sized frame) into
    ``out_dir`` when one is given.

    ``read`` maps a path to ``{read name: signal}``; by default it reads a
    gzip fast5 (:func:`..utils.hdf5_chunks.read_gzip_signals`). Returns the
    *global* stats, summed over ``group``: every rank returns the same.
    """
    options = options or CompressionOptions(True, 2, 1, 0)
    read = read or hdf5_chunks.read_gzip_signals
    device = sharded.rank_device(group, device)
    files = reads = raw = comp = 0
    for path in _local_share(paths, group):
        signals = list(read(path).values())
        if not signals:
            continue
        streams = compress_signals(signals, options, device=device)
        files += 1
        reads += len(signals)
        raw += sum(s.nbytes for s in signals)
        comp += sum(len(c) for c in streams)
        if out_dir:
            base = os.path.basename(path) + ".vbz"
            with open(os.path.join(out_dir, base), "wb") as f:
                for c in streams:
                    f.write(np.uint32(len(c)).tobytes())
                    f.write(c)
    local = torch.tensor([files, reads, raw, comp], dtype=torch.int64)
    total = sharded.all_reduce_sum(local, group).tolist()
    return CorpusStats(*total)
