"""Where the batch API's time goes, stage by stage and kernel by kernel.

Run from the root of a checkout with one CUDA card visible:

    python -m vbz_compression_tpu_torch.stage_profile [--out FILE]

Measurements, each the best of ``--repeats`` runs, on the 64-read corpus and
the realistic tier of ``chip_smoke.py`` (:mod:`.signals`, the same seeds):

  1. ``api``: the real ``vbz_compress_sized_batch`` /
     ``vbz_decompress_sized_batch`` at options (0,2,1,0), host to host;
  2. ``encode_stages`` / ``decode_stages``: the same two calls replayed by
     :func:`replay_encode` / :func:`replay_decode` with a device synchronize
     after each stage, ms per stage;
  3. ``kernel_us``: kernels E and D on the realistic tier [4, 4M], one call
     per timing, once after a 256 MiB buffer is zeroed (L2 flushed) and once
     without (``utils.profiling.cold_ms`` / ``warm_ms``); the GPU is kept
     busy while the host enqueues, so host launch gaps stay out of both;
     ``bound_us``: the bytes each must move
     (``utils.roofline.codec_bytes``) at the card's data-sheet rate;
  4. ``profiler_us``: device time per CUDA kernel launch from
     ``torch.profiler`` over 5 encode and 5 decode calls on that tier.

Prints the card's name and power limit, then one JSON object, which it also
writes to ``--out`` when given.

The replays follow ``api.vbz_*_sized_batch`` and :class:`TorchSvbBackend`'s
batch methods step for step and return what the real calls return; the
tests hold the two to the same output on the CPU.
"""

from __future__ import annotations

import argparse
import json
import struct
import time

import numpy as np
import torch

from . import CompressionOptions, signals
from . import api as _pipeline
from .models import codec
from .ops import svb_w2
from .utils import profiling, roofline

OPTIONS = (0, 2, 1, 0)
TIER = (4, 4 << 20)
FLUSH_BYTES = 256 << 20
PROFILED_CALLS = 5


class _Stages:
    """Wall time per named stage, each stage ended by a device sync."""

    def __init__(self, device: torch.device):
        self.device = device
        self.ms: dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + (t - self._t) * 1e3
        self._t = t


def replay_encode(backend: codec.TorchSvbBackend, chunks,
                  options: CompressionOptions):
    """``vbz_compress_sized_batch(chunks, options, backend)`` for a W2 flavor
    at zstd level 0, timed per stage; returns (frames, ms per stage)."""
    assert options.zstd_compression_level == 0 and options.integer_size
    clock = _Stages(backend.device)
    raws = [_pipeline._as_bytes(c) for c in chunks]
    headers = [struct.pack("<I", len(r)) for r in raws]
    clock.lap("api _as_bytes")
    kind, flavor = codec._route(options.integer_size,
                                options.perform_delta_zig_zag,
                                options.vbz_version)
    assert kind == "w2"
    typed = [codec._typed_input(r, options.integer_size) for r in raws]
    live = [i for i, t in enumerate(typed) if t.size]
    rows = [typed[i] for i in live]
    counts = [r.size for r in rows]
    clock.lap("typed input")
    host = np.concatenate(rows)
    clock.lap("host concat")
    flat = torch.from_numpy(host).to(backend.device)
    clock.lap("H2D")
    width = -(-max(counts) // 4) * 4
    x = torch.empty(len(rows), width, dtype=flat.dtype, device=backend.device)
    start = 0
    for b, n in enumerate(counts):
        x[b, :n] = flat[start:start + n]
        start += n
    lens = torch.tensor(counts, dtype=torch.int32, device=backend.device)
    clock.lap("pad rows on device")
    keys, data, data_len = svb_w2.encode_w2_rows(x, lens, flavor)
    clock.lap("kernel E")
    key_lens = [(n + 3) // 4 for n in counts]
    data_lens = data_len.tolist()
    clock.lap("data_len pull")
    out_flat = torch.cat([keys[j, :k] for j, k in enumerate(key_lens)]
                         + [data[j, :d] for j, d in enumerate(data_lens)])
    clock.lap("device cat")
    out_host = out_flat.cpu().numpy()
    clock.lap("D2H")
    parts = codec._split(out_host, key_lens + data_lens)
    streams = [b""] * len(typed)
    for j, i in enumerate(live):
        streams[i] = parts[j].tobytes() + parts[len(live) + j].tobytes()
    clock.lap("split + bytes")
    frames = [h + bytes(s) for h, s in zip(headers, streams)]
    clock.lap("api framing")
    return frames, clock.ms


def replay_decode(backend: codec.TorchSvbBackend, frames,
                  options: CompressionOptions):
    """``vbz_decompress_sized_batch(frames, options, backend)`` for a W2
    flavor at zstd level 0, timed per stage; returns (buffers, ms)."""
    assert options.zstd_compression_level == 0 and options.integer_size
    clock = _Stages(backend.device)
    raws = [_pipeline._as_bytes(f) for f in frames]
    sizes = [_pipeline.vbz_decompressed_size(r, options) for r in raws]
    bodies = [r[_pipeline.SIZED_HEADER_BYTES:] for r in raws]
    counts = [s // options.integer_size for s in sizes]
    clock.lap("api unframe")
    kind, flavor = codec._route(options.integer_size,
                                options.perform_delta_zig_zag,
                                options.vbz_version)
    assert kind == "w2"
    dtype = codec._SIGNED_FOR_SIZE[options.integer_size]
    bufs = [codec._as_u8(s) for s in bodies]
    clock.lap("as u8")
    live, key_lens = [], []
    for i, (buf, count) in enumerate(zip(bufs, counts)):
        if not codec._is_empty(buf, count):
            key_lens.append(codec._check_stream(buf, count, kind))
            live.append(i)
    clock.lap("host validation")
    flat = torch.from_numpy(np.concatenate([bufs[i] for i in live])).to(
        backend.device)
    clock.lap("concat + H2D")
    width = -(-max(counts[i] for i in live) // 4) * 4
    B = len(live)
    keys = torch.zeros(B, width // 4, dtype=torch.uint8, device=backend.device)
    data = torch.empty(B, 2 * width, dtype=torch.uint8, device=backend.device)
    start = 0
    for b, (i, k) in enumerate(zip(live, key_lens)):
        n = bufs[i].size
        keys[b, :k] = flat[start:start + k]
        data[b, :n - k] = flat[start + k:start + n]
        start += n
    cnt = torch.tensor([counts[i] for i in live], dtype=torch.int32,
                       device=backend.device)
    clock.lap("pad rows on device")
    rows = svb_w2.decode_w2_rows(keys, data, cnt, flavor)
    clock.lap("kernel D")
    live_sizes = [counts[i] for i in live]
    flat_out = torch.cat([rows[b, :n] for b, n in enumerate(live_sizes)])
    clock.lap("device cat")
    host = flat_out.cpu().numpy()
    clock.lap("D2H")
    outs = [np.zeros(0, dtype)] * len(bufs)
    for i, part in zip(live, codec._split(host, live_sizes)):
        outs[i] = part
    buffers = [np.ascontiguousarray(o).tobytes() for o in outs]
    clock.lap("split + bytes")
    return buffers, clock.ms


def _best(runs: list[dict]) -> dict:
    return {k: min(r[k] for r in runs) for k in runs[0]}


def _api_and_stages(backend, reads, options, repeats: int) -> dict:
    from . import api

    enc_s, dec_s, enc_runs, dec_runs = [], [], [], []
    frames = api.vbz_compress_sized_batch(reads, options, backend=backend)
    for _ in range(repeats):
        t0 = time.perf_counter()
        api.vbz_compress_sized_batch(reads, options, backend=backend)
        t1 = time.perf_counter()
        api.vbz_decompress_sized_batch(frames, options, backend=backend)
        t2 = time.perf_counter()
        enc_s.append(t1 - t0)
        dec_s.append(t2 - t1)
        replayed, ms = replay_encode(backend, reads, options)
        if replayed != frames:
            raise SystemExit("replayed encode differs from the api's")
        enc_runs.append(ms)
        _, ms = replay_decode(backend, frames, options)
        dec_runs.append(ms)
    raw = sum(r.nbytes for r in reads)
    return {"bytes": raw, "reads": len(reads),
            "api": {"enc_ms": min(enc_s) * 1e3, "dec_ms": min(dec_s) * 1e3,
                    "enc_gb_s": raw / min(enc_s) / 1e9,
                    "dec_gb_s": raw / min(dec_s) / 1e9},
            "encode_stages": _best(enc_runs),
            "decode_stages": _best(dec_runs)}


def _kernels(device, repeats: int) -> dict:
    B, N = TIER
    x = torch.from_numpy(signals.TIERS["realistic"](B, N)).to(device)
    lens = torch.full((B,), N, dtype=torch.int32, device=device)
    keys, data, data_len = svb_w2.encode_w2_rows(x, lens, "zz16")
    enc_bytes, dec_bytes = roofline.codec_bytes(x, keys, data_len)

    def enc():
        svb_w2.encode_w2_rows(x, lens, "zz16")

    def dec():
        svb_w2.decode_w2_rows(keys, data, lens, "zz16")

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    out = {name: {"warm": profiling.warm_ms(fn, 1, repeats) * 1e3,
                  "cold": profiling.cold_ms(fn, flush, repeats) * 1e3}
           for name, fn in (("E", enc), ("D", dec))}
    torch.cuda.synchronize()
    with profiling.trace() as prof:
        for _ in range(PROFILED_CALLS):
            enc()
            dec()
    per_launch = {e.key: {"us": e.self_device_time_total / e.count,
                          "launches": e.count}
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0 and e.count}
    return {"tier": f"realistic [{B}, {N}] int16", "kernel_us": out,
            "bound_us": {"E": roofline.bound_ms(enc_bytes) * 1e3,
                         "D": roofline.bound_ms(dec_bytes) * 1e3},
            "profiler_us": per_launch}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON result here")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_profile: no CUDA device is visible")
    smi = profiling.card()
    print(smi)
    device = torch.device("cuda")
    backend = codec.TorchSvbBackend(device)
    options = CompressionOptions.from_cd_values(OPTIONS)
    result = {"card": smi, "options": list(OPTIONS)}
    result.update(_api_and_stages(backend, signals.corpus(), options,
                                  args.repeats))
    result.update(_kernels(device, args.repeats))
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
