"""Times of the corpus paths on the card: the counterpart of the JAX
package's ``tools/check_corpus_chip.py`` and ``tools/check_sharded_chip.py``.

    python -m vbz_compression_tpu_torch.tools.corpus_times [--out FILE]

On the pseudo-read corpus (:func:`..signals.pseudo_reads`: 256 int16 reads,
40,528,974 bytes, buckets of 32768, 65536 and 131072 values) it measures:

- :func:`..parallel.multihost.compress_signals` host to host (best of
  ``REPEATS`` wall times) at zstd level 0, with zig-zag (kernel E) and
  without (E4), and at level 1 with zig-zag (its default and the
  fast5 filter's, through the api's zstd stage: ``zstandard`` or
  ``libzstd.so.1``), and its launches per call;
- the driver's device portion: the encode of each bucket's padded batch,
  staged on the card as the backend pads it, CUDA events around one pass
  with the L2 flushed before it (back to back, the host's enqueue of a
  pass, three wrapper calls, outlasts its kernels);
- the rows plane's encode and decode on the largest bucket, padded to its
  width ([172, 131072]);
- a world-1 NCCL group in this process: the ``all_gather`` of the bucket's
  data lengths alone, and the rows-plane encode with the group beside the
  one without (back to back and host to host), with the operators of the
  call with the group under ``torch.profiler``.

Prints the card's name and power limit first, then one JSON line per
measurement, each carrying the card; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


CALLS = 10
REPEATS = 3
TOP_OPS = 8
FLUSH_BYTES = 256 << 20


def buckets(reads) -> dict:
    """{bucket: [reads]} of the corpus, as compress_signals groups them."""
    from ..parallel import multihost

    by_bucket = {}
    for r in reads:
        by_bucket.setdefault(multihost.bucket_of(r.size), []).append(r)
    return dict(sorted(by_bucket.items()))


def measure() -> list[dict]:
    import torch
    import torch.distributed as dist

    from .. import api, oracle
    from ..models import codec
    from ..ops import svb_w2, svb_w4
    from ..options import CompressionOptions
    from ..parallel import multihost, sharded
    from ..signals import pseudo_reads
    from ..utils import profiling

    if not torch.cuda.is_available():
        raise SystemExit("corpus_times: no CUDA device is visible")
    card = profiling.card()
    print(card)
    dev = torch.device("cuda", 0)
    reads = pseudo_reads()
    raw = sum(r.nbytes for r in reads)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    lines = []

    def emit(line: dict) -> None:
        line["card"] = card
        lines.append(line)
        print(json.dumps(line))

    by_bucket = buckets(reads)
    # each bucket's batch padded as the backend pads it: to its longest read
    staged = [codec.padded_rows(rows, dev) for rows in by_bucket.values()]
    padded = sum(x.numel() * x.element_size() for x, _ in staged)
    for zigzag, level in ((True, 0), (False, 0), (True, 1)):
        opts = CompressionOptions(zigzag, 2, level, 0)
        frames = multihost.compress_signals(reads, opts, device=dev)
        for r, f in zip(reads[:3], frames):
            if f != api.vbz_compress_sized(r, opts, backend=oracle):
                raise SystemExit(f"{opts.cd_values}: a frame differs from "
                                 "the oracle's")
        mod = svb_w2 if zigzag else svb_w4
        mod.ENCODE_LAUNCHES = 0
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            multihost.compress_signals(reads, opts, device=dev)
            best = min(best, time.perf_counter() - t0)
        launches = mod.ENCODE_LAUNCHES / REPEATS

        kind, flavor = codec._route(2, zigzag, 0)
        encode = codec._KINDS[kind][0]

        def device_pass(encode=encode, flavor=flavor):
            for x, lens in staged:
                encode(x, lens, flavor)

        cold = profiling.cold_ms(device_pass, flush, REPEATS)
        emit({"what": "compress_signals", "options": list(opts.cd_values),
              "zstd_route": api.zstd_route() if level else None,
              "kernel": "E" if zigzag else "E4", "reads": len(reads),
              "raw_bytes": raw, "padded_bytes": padded,
              "buckets": [list(x.shape) for x, _ in staged],
              "launches_per_call": launches,
              "host_to_host_s": best, "host_to_host_gb_s": raw / best / 1e9,
              "device_cold_ms": cold,
              "device_gb_s": raw / (cold / 1e3) / 1e9})

    width, rows = max(by_bucket.items())
    x, lens = codec.padded_rows(rows, dev, width)
    rows_raw = int(lens.sum()) * 2
    keys, data, data_len, _ = sharded.batch_encode_sharded_rows(x, lens)
    enc = lambda: sharded.batch_encode_sharded_rows(x, lens)  # noqa: E731
    dec = lambda: sharded.batch_decode_sharded_rows(  # noqa: E731
        keys, data, lens)
    if not torch.equal(torch.where(
            torch.arange(x.shape[1], device=dev)[None] < lens[:, None],
            x, 0), dec()):
        raise SystemExit("rows plane round trip differs")
    times = {k: (profiling.cold_ms(f, flush, REPEATS),
                 profiling.warm_ms(f, CALLS, REPEATS))
             for k, f in (("encode", enc), ("decode", dec))}
    emit({"what": "rows plane", "shape": list(x.shape), "raw_bytes": rows_raw,
          **{f"{k}_cold_ms": v[0] for k, v in times.items()},
          **{f"{k}_warm_ms": v[1] for k, v in times.items()},
          **{f"{k}_gb_s": rows_raw / (v[0] / 1e3) / 1e9
             for k, v in times.items()}})

    group = multihost.initialize(multihost.local_init_method(), 1, 0, "nccl")
    try:
        gather = lambda: sharded.all_gather(data_len, group)  # noqa: E731
        enc_g = lambda: sharded.batch_encode_sharded_rows(  # noqa: E731
            x, lens, group=group)
        emit({"what": "world-1 NCCL group", "gathered": list(data_len.shape),
              "all_gather_warm_ms": profiling.warm_ms(gather, CALLS,
                                                      REPEATS),
              "all_gather_host_ms": _host_ms(gather),
              "rows_encode_group_warm_ms": profiling.warm_ms(enc_g, CALLS,
                                                             REPEATS),
              "rows_encode_no_group_warm_ms": profiling.warm_ms(enc, CALLS,
                                                                REPEATS),
              "rows_encode_group_host_ms": _host_ms(enc_g),
              "rows_encode_no_group_host_ms": _host_ms(enc),
              "rows_encode_group_ops": _top_ops(enc_g)})
    finally:
        dist.destroy_process_group()
    return lines


def _top_ops(fn) -> list[dict]:
    """The ``TOP_OPS`` operators of ``CALLS`` calls of ``fn`` under
    ``torch.profiler`` by host time, with their host and device ms per
    call."""
    from ..utils import profiling

    fn()
    with profiling.trace() as prof:
        for _ in range(CALLS):
            fn()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [{"op": e.key, "count": e.count / CALLS,
             "self_host_ms": e.self_cpu_time_total / 1e3 / CALLS,
             "device_ms": getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0))
             / 1e3 / CALLS}
            for e in ops[:TOP_OPS]]


def _host_ms(fn) -> float:
    """Host ms of one call that ends in a synchronise, best of ``REPEATS``
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    lines = measure()
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
