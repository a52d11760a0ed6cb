"""A dry run of the data-parallel plane and the corpus driver on every rank:
the counterpart of ``__graft_entry__.dryrun_multichip``.

Each rank runs three checks and raises on the first that fails:

1. the wire-format plane: ``B = 2 * world`` rows of 256 uniform int16 in
   +-3000 (seed 0) through :func:`.sharded.batch_encode_sharded` and
   :func:`.sharded.batch_decode_sharded`: every ``ok`` true, the total the
   sum of the gathered lengths, the rank's streams those of the NumPy oracle
   and its rows round-tripped;
2. the rows plane: ``B`` rows of a 2048-sample sigma-12 walk through
   :func:`.sharded.batch_encode_sharded_rows` and back: the total
   ``sum(data_len) + B*N/4``, the rank's rows round-tripped;
3. the corpus driver: :func:`.multihost.compress_signals` on the rank's walk
   rows, every frame equal to :func:`..api.vbz_compress_sized` through the
   oracle.

:func:`run` runs them in the process group that is already initialised, or
spawns ``world`` processes joined by a ``file://`` rendezvous:

    python -m vbz_compression_tpu_torch.parallel.dryrun --world 2 \\
        [--device cpu] [--zstd-level L]

The JAX package's ``__graft_entry__.entry()`` is a jit compile check and has
no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch.distributed as dist

from .. import api
from ..ops import scalar
from ..options import CompressionOptions
from . import multihost, sharded


def _require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun: {what}")


def check(group=None, device=None, zstd_level: int = 1) -> dict:
    """The three checks on this rank of ``group``; returns a summary."""
    rank, world = sharded.rank_world(group)
    B, N = 2 * world, 256
    rng = np.random.default_rng(0)
    chunks = [rng.integers(-3000, 3000, N, dtype=np.int16) for _ in range(B)]
    batch, lens = sharded.pad_chunks(chunks, pad_to=N)
    mine = slice(rank * 2, rank * 2 + 2)

    lb = sharded.shard_batch(lens, group, device)
    streams, stream_lens, total = sharded.batch_encode_sharded(
        sharded.shard_batch(batch, group, device), lb, group=group)
    out, ok = sharded.batch_decode_sharded(
        streams, lb,
        sharded.shard_batch(stream_lens.cpu().numpy(), group, device),
        group=group, out_n=N)
    _require(bool(ok.all()), "decode validation failed")
    _require(int(total) == int(stream_lens.sum()), "total != sum of lengths")
    _require(np.array_equal(out.cpu().numpy(), batch[mine]),
             "plane round trip differs")
    host = streams.cpu().numpy()
    for row, c in zip(range(2), chunks[mine]):
        _require(host[row, :int(stream_lens[2 * rank + row])].tobytes()
                 == scalar.svb_compress(c, 2, True, 0),
                 "plane stream differs from the oracle")

    sig = np.clip(500 + np.cumsum(rng.normal(0, 12, (B, 2048)), axis=1),
                  -2000, 2000).astype(np.int16)
    keys, data, data_len, rows_total = sharded.batch_encode_sharded_rows(
        sharded.shard_batch(sig, group, device), group=group)
    back = sharded.batch_decode_sharded_rows(keys, data, group=group)
    _require(np.array_equal(back.cpu().numpy(), sig[mine]),
             "rows plane round trip differs")
    _require(int(rows_total) == int(data_len.sum()) + B * 2048 // 4,
             "rows plane total differs")

    opts = CompressionOptions(True, 2, zstd_level, 0)
    frames = multihost.compress_signals(
        list(sig[mine]), opts, device=sharded.rank_device(group, device))
    for s, frame in zip(sig[mine], frames):
        _require(frame == api.vbz_compress_sized(s, opts, backend=scalar),
                 "corpus driver frame differs from the api's")
    return {"rank": rank, "world": world, "plane_bytes": int(total),
            "plane_input_bytes": batch.nbytes, "rows_bytes": int(rows_total),
            "rows_input_bytes": sig.nbytes,
            "driver_bytes": sum(map(len, frames))}


def _rank_main(init_method, world, rank, device, zstd_level,
               results) -> None:
    """One spawned rank: join, check, report to ``results``, leave."""
    try:
        group = multihost.initialize(init_method, world, rank,
                                     _backend_for(device))
        try:
            results.put(check(group, device, zstd_level))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise


def _backend_for(device) -> str:
    return "gloo" if sharded.rank_device(None, device).type == "cpu" \
        else "nccl"


def run(world: int, device=None, zstd_level: int = 1,
        timeout: float = 120.0) -> list[dict]:
    """The checks on every rank: in the initialised default group, or in
    ``world`` spawned processes (each ended within ``timeout`` seconds)."""
    if dist.is_initialized():
        return [check(dist.group.WORLD, device, zstd_level)]
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(init, world, r, device, zstd_level,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = []
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                got.append(results.get(
                    timeout=max(deadline - time.monotonic(), 0.01)))
        except queue.Empty:
            pass
        finally:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
                if p.is_alive():
                    p.kill()
                    p.join()
    errors = [g["error"] for g in got if "error" in g]
    if errors:
        raise RuntimeError("dryrun rank failed:\n" + errors[0])
    if len(got) < world:
        raise RuntimeError(f"dryrun: {world - len(got)} of {world} ranks "
                           f"gave no result within {timeout} s")
    return sorted(got, key=lambda g: g["rank"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--device", default=None,
                        help="each rank's device (default: its card)")
    parser.add_argument("--zstd-level", type=int, default=1)
    args = parser.parse_args(argv)
    for line in run(args.world, args.device, args.zstd_level):
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
