"""Kernel times on every codec input, and the probe kernels slower than a
library call beside it, for comparing two trees.

Run with one CUDA card visible, from the root of a checkout:

    python -m vbz_compression_tpu_torch.tools.kernel_times [--out FILE]
        [--only w2|w4|v1|probe|match|own ...]

The script calls only what every version of the port since the one-pass E
and D has (the ``svb_w2``, ``svb_w4`` and ``svb_v1`` wrappers,
``probes.prefix_sum`` and
``fetch_i32``, ``signals``, the timers of ``utils.profiling`` and the byte
count of ``utils.roofline``). Run by path, it imports the package that
``PYTHONPATH`` names, so from the root of another checkout
``PYTHONPATH=. python /path/to/kernel_times.py`` times that checkout's
kernels on the same inputs; to compare two trees, run them in turns (A, B,
B, A) on one card, one after the other. ``chip_smoke.py`` phase 5 times the
same codec inputs (it takes ``w4_rows`` and ``codec2_rows`` from here), but
only with its own checkout's kernels. The match group needs a checkout
with ``ops.zstd_match``.

Inputs, made from seeds with numpy:
- w2 (E, D): the bench tiers and realistic at [4, 4M] int16 (zz16), four
  int8 walks [4, 4M] (zz8), realistic at [64, 8192] (short chunks);
- w4 (E4, D4): each W4 flavor on signal-like content at [4, 4M], zz32 on
  uniform content, and codec2's [1, 4096] zig-zag deltas (none32);
- v1 (V1E, V1D): zz8 and none8 on four int8 walks [4, 4M], zz8 on uniform
  int8 [4, 4M];
- probe: ``prefix_sum`` on [256, 128] (the capability probe's input) and
  [32768, 128] int32 beside ``torch.cumsum``, ``fetch_i32`` on 128 x 32768
  int32 beside ``copy_``, in turns (kernel, library, library, kernel, six
  times), each turn one call with the L2 flushed and ten back to back; then
  the launch floor: CP (``roofline.copy_blocked``) on one [8, 128] int32
  tile, one call with the L2 flushed and ten back to back, six times;
- match (M): the StreamVByte payload of the clean tier's first 8 MiB chunk
  (5,243,482 bytes, the own-tpu stage's input), all-zero bytes and uniform
  bytes of the same length (every position stops at the first offset, and
  almost none stops before the last), each against the plain scan, one
  call with the L2 flushed and ten back to back beside the bound: the int32
  offsets (N bytes read, 4N written) and, where the checkout has
  ``match_index``, the uint8 index (N read, N written); the plain scans on
  the payload; the payload's copy to the card and the int32 map's and the
  index's copies back through pageable memory, on the host clock;
- own: the own-tpu zstd stage at (0,2,1,1) host to host, the clean tier as
  4 x 8 MiB chunks through the batch API and the 256 pseudo-reads through
  ``compress_signals`` (one warm-up call, then three timed); then one
  frame of the clean payload with the device matcher, with the encoder's
  native branches (where the checkout has them) and with them patched
  off: three timed calls each, and one under cProfile, its functions by
  time of their own (shares, not times: cProfile slows Python, not C).
For the codec inputs and each direction: one call with the L2 flushed and
ten back to back, each the best of three (``profiling``'s ``cold_ms`` and
``warm_ms``), and the bound (the bytes the call must move at the data
sheet's 3.35 TB/s). The w4 and v1 groups also list what ``torch.profiler``
sees of five encode calls and five decode calls (w4: zz32 and none16
signal; v1: zz8 and none8 on the int8 walks): each kernel's name, launches
and device us per launch. Prints the card's name and
power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from vbz_compression_tpu_torch import oracle, signals
from vbz_compression_tpu_torch.ops import probes, svb_v1, svb_w2, svb_w4
from vbz_compression_tpu_torch.utils import profiling, roofline

B, N = 4, 4 << 20
FLUSH_BYTES = 256 << 20
PROBE_TURNS = 6   # rounds of kernel, library, library, kernel
OWN_REPEATS = 3   # timed calls of each own-tpu path
W4_FLAVORS = ("zz32", "none32", "none16", "none8")
W4_DTYPES = {"zz32": np.int32, "none32": np.int32, "none16": np.int16,
             "none8": np.int8}


def w4_rows(flavor: str, content: str) -> np.ndarray:
    """[B, N] input of a W4 flavor: signal-like or uniform content."""
    rng = np.random.default_rng(100 + 2 * W4_FLAVORS.index(flavor)
                                + (content == "uniform"))
    if content == "uniform":
        return signals.uniform(rng, B * N, W4_DTYPES[flavor]).reshape(B, N)
    make = {"zz32": signals.int32_walk, "none8": signals.int8_walk,
            "none32": lambda r, n: signals.CORPUS_KINDS["u32"](r, n).view(
                np.int32),
            "none16": lambda r, n: signals.adc_counts(r, n).view(np.int16)}
    return np.stack([make[flavor](rng, N) for _ in range(B)])


def codec2_rows() -> tuple[np.ndarray, np.ndarray]:
    """codec2's input (``test_codec2_pack_matches_e4_none32_and_d``): a
    [1, 4096] int16 walk, and its zig-zag deltas as int32, which E4 none32
    packs as codec2's encode did."""
    rng = np.random.default_rng(0)
    sig = np.clip(500 + np.cumsum(rng.normal(0, 12, 4096)), -2000,
                  2000).astype(np.int16)
    zz = oracle.zigzag_delta_encode(sig, 2).astype(np.int32)
    return sig[None], zz[None]


def walk8() -> np.ndarray:
    """[B, N] int8 walks, row b from seed b: the zz8 and v1 input."""
    return np.stack([signals.int8_walk(np.random.default_rng(b), N)
                     for b in range(B)])


def inputs(pair: str) -> dict:
    """label -> (flavor, rows) of one kernel pair."""
    if pair in ("w2", "v1"):
        walk = walk8()
    if pair == "v1":
        return {f"zz8 int8 walk [{B}, {N}]": ("zz8", walk),
                f"none8 int8 walk [{B}, {N}]": ("none8", walk),
                f"zz8 uniform [{B}, {N}]": ("zz8", signals.uniform(
                    np.random.default_rng(9), B * N, np.int8).reshape(B, N))}
    if pair == "w2":
        out = {f"zz16 {k} [{B}, {N}]": ("zz16", v)
               for k, v in signals.tiers(B, N).items()}
        out[f"zz8 int8 walk [{B}, {N}]"] = ("zz8", walk)
        out["zz16 realistic [64, 8192]"] = (
            "zz16", signals.TIERS["realistic"](64, 8192))
        return out
    out = {f"{f} signal [{B}, {N}]": (f, w4_rows(f, "signal"))
           for f in W4_FLAVORS}
    out[f"zz32 uniform [{B}, {N}]"] = ("zz32", w4_rows("zz32", "uniform"))
    out["none32 codec2 [1, 4096]"] = ("none32", codec2_rows()[1])
    return out


def time_input(enc_fn, dec_fn, flavor: str, rows: np.ndarray,
               flush) -> dict:
    x = torch.from_numpy(rows).cuda()
    lens = torch.full((rows.shape[0],), rows.shape[1], dtype=torch.int32,
                      device=x.device)
    keys, data, data_len = enc_fn(x, lens, flavor)
    if not torch.equal(dec_fn(keys, data, lens, flavor), x):
        raise SystemExit(f"{flavor} {tuple(rows.shape)}: round trip differs")
    enc_bytes, dec_bytes = roofline.codec_bytes(x, keys, data_len)

    def enc():
        enc_fn(x, lens, flavor)

    def dec():
        dec_fn(keys, data, lens, flavor)

    out = {}
    for name, fn, nbytes in (("enc", enc, enc_bytes), ("dec", dec, dec_bytes)):
        out[name + "_ms"] = profiling.cold_ms(fn, flush)
        out[name + "_warm_ms"] = profiling.warm_ms(fn)
        out[name + "_bound_ms"] = roofline.bound_ms(nbytes)
    return out


def profile(pair: str, flavor: str, direction: str) -> dict:
    """{kernel: {"launches", "us"}} over five calls of one direction
    ("encode" or "decode") of one flavor of a pair ("w4" or "v1") on its
    [B, N] signal input (v1: the int8 walks): every kernel a call launches,
    fills included."""
    if pair == "w4":
        rows, enc_fn, dec_fn = (w4_rows(flavor, "signal"),
                                svb_w4.encode_w4_rows, svb_w4.decode_w4_rows)
    else:
        rows = walk8()
        enc_fn, dec_fn = svb_v1.encode_v1_rows, svb_v1.decode_v1_rows
    x = torch.from_numpy(rows).cuda()
    lens = torch.full((B,), N, dtype=torch.int32, device=x.device)
    keys, data, _ = enc_fn(x, lens, flavor)
    if direction == "encode":
        def call():
            enc_fn(x, lens, flavor)
    else:
        def call():
            dec_fn(keys, data, lens, flavor)
    call()
    torch.cuda.synchronize()
    with profiling.trace() as prof:
        for _ in range(5):
            call()
    return {e.key: {"launches": e.count,
                    "us": e.self_device_time_total / e.count}
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.count}


def probe_turns(flush) -> dict:
    """Each probe kernel and its library call in turns: every turn's cold
    and warm ms, and the bound."""
    rng = np.random.default_rng(0)
    out = {}
    for shape in ((256, 128), (32768, 128)):
        a = torch.from_numpy(rng.integers(0, 2, shape, dtype=np.int32)).cuda()
        if not torch.equal(probes.prefix_sum(a), probes.prefix_sum_plain(a)):
            raise SystemExit(f"prefix_sum {shape} differs from plain")
        out[f"prefix_sum {list(shape)} vs cumsum"] = (
            lambda a=a: probes.prefix_sum(a),
            lambda a=a: torch.cumsum(a.view(-1), 0, dtype=torch.int32),
            2 * a.numel() * 4)
    nw = 128 * 32768
    d32 = torch.from_numpy(rng.integers(0, 256, nw + 8192,
                                        dtype=np.int32)).cuda()
    dst = torch.empty(nw // 128, 128, dtype=torch.int32, device="cuda")
    out["fetch_i32 128 x 32768 vs copy_"] = (
        lambda: probes.fetch_i32(d32, nw),
        lambda: dst.copy_(d32[:nw].view(-1, 128)), 8 * nw)
    times = {}
    for label, (kernel, library, nbytes) in out.items():
        t = {"kernel_ms": [], "kernel_warm_ms": [], "library_ms": [],
             "library_warm_ms": [], "bound_ms": roofline.bound_ms(nbytes)}
        for _ in range(PROBE_TURNS):
            for side, fn in (("kernel", kernel), ("library", library),
                             ("library", library), ("kernel", kernel)):
                t[side + "_ms"].append(profiling.cold_ms(fn, flush))
                t[side + "_warm_ms"].append(profiling.warm_ms(fn))
        times[label] = t
    return times


def launch_floor(flush) -> dict:
    """CP (``roofline.copy_blocked``) on one [8, 128] int32 tile: the least a
    launch costs on the card, one call with the L2 flushed and ten back to
    back, PROBE_TURNS times."""
    x = torch.arange(8 * 128, dtype=torch.int32, device="cuda").view(8, 128)
    if not torch.equal(roofline.copy_blocked(x, 8), x):
        raise SystemExit("copy_blocked [8, 128] differs from its input")
    t = {"ms": [], "warm_ms": [], "bound_ms": roofline.bound_ms(2 * 4 * 1024)}
    for _ in range(PROBE_TURNS):
        t["ms"].append(profiling.cold_ms(
            lambda: roofline.copy_blocked(x, 8), flush))
        t["warm_ms"].append(profiling.warm_ms(
            lambda: roofline.copy_blocked(x, 8)))
    return t


def match_times(flush, payload: bytes | None = None) -> dict:
    """M on the payload (``signals.clean_payload()`` unless given), zeros
    and uniform bytes (see the module docstring), int32 and, where the
    checkout has it, the uint8 index; the plain scans and the copies on the
    payload."""
    from vbz_compression_tpu_torch.ops import zstd_match

    payload = np.frombuffer(payload or signals.clean_payload(), np.uint8)
    n = payload.size
    rng = np.random.default_rng(0)
    index = getattr(zstd_match, "match_index", None)
    out = {}
    for label, buf in (("payload", payload), ("zeros", np.zeros(n, np.uint8)),
                       ("uniform", rng.integers(0, 256, n).astype(np.uint8))):
        x = torch.from_numpy(buf.copy()).cuda()
        want = zstd_match.match_candidates_plain(x)
        if not torch.equal(zstd_match.match_candidates(x), want):
            raise SystemExit(f"match {label} differs from plain")
        out[f"match {label}"] = t = {
            "n": n, "candidates": int((want > 0).sum()),
            "ms": profiling.cold_ms(lambda: zstd_match.match_candidates(x),
                                    flush),
            "warm_ms": profiling.warm_ms(
                lambda: zstd_match.match_candidates(x)),
            "bound_ms": roofline.bound_ms(5 * n)}
        if index is not None:
            want_index = zstd_match.match_index_plain(x)
            if not torch.equal(index(x), want_index):
                raise SystemExit(f"match index {label} differs from plain")
            t.update(index_ms=profiling.cold_ms(lambda: index(x), flush),
                     index_warm_ms=profiling.warm_ms(lambda: index(x)),
                     index_bound_ms=roofline.bound_ms(2 * n))
        if label == "payload":
            t["plain_ms"] = profiling.warm_ms(
                lambda: zstd_match.match_candidates_plain(x), 3)
            if index is not None:
                t["index_plain_ms"] = profiling.warm_ms(
                    lambda: zstd_match.match_index_plain(x), 3)
            h2d, d2h, index_d2h = [], [], []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dev = torch.from_numpy(buf.copy()).cuda()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                off = zstd_match.match_candidates(dev)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                off.cpu()
                h2d.append((t1 - t0) * 1e3)
                d2h.append((time.perf_counter() - t2) * 1e3)
                if index is not None:
                    places = index(dev)
                    torch.cuda.synchronize()
                    t3 = time.perf_counter()
                    places.cpu()
                    index_d2h.append((time.perf_counter() - t3) * 1e3)
            t["copy_in_host_ms"], t["map_back_host_ms"] = h2d, d2h
            if index is not None:
                t["index_back_host_ms"] = index_d2h
    return out


def own_tpu_times() -> dict:
    """The own-tpu zstd stage at (0,2,1,1) host to host: the clean tier as
    4 x 8 MiB chunks through the batch API and the 256 pseudo-reads through
    ``compress_signals``, one warm-up call and OWN_REPEATS timed calls
    each."""
    from vbz_compression_tpu_torch import CompressionOptions, api, bench
    from vbz_compression_tpu_torch.parallel import multihost

    opts = CompressionOptions.from_cd_values((0, 2, 1, 1))
    chunks = list(signals.TIERS["clean"](B, N))
    reads = signals.pseudo_reads()
    out = {}
    with bench.encoder_env("own-tpu"):
        for label, fn, raw in (
                ("batch API, clean 4 x 8 MiB",
                 lambda: api.vbz_compress_sized_batch(chunks, opts),
                 sum(c.nbytes for c in chunks)),
                ("compress_signals, 256 pseudo-reads",
                 lambda: multihost.compress_signals(reads, opts),
                 sum(r.nbytes for r in reads))):
            fn()
            seconds = []
            for _ in range(OWN_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                seconds.append(time.perf_counter() - t0)
            out[f"own-tpu {label}"] = {"s": seconds, "bytes": raw}
    return out


def own_profile(top: int = 12) -> dict:
    """Where one own-tpu frame's host time goes: ``zstd_seq.compress_frame``
    on the clean tier's first chunk's payload with the device matcher on the
    card, with the encoder's native branches (where the checkout has them)
    and with them patched off: the best of OWN_REPEATS unprofiled calls,
    then one call under cProfile and its ``top`` functions by time of their
    own. cProfile adds to every Python call and to no C code, so take
    shares from it, not times."""
    import cProfile
    import pstats

    from vbz_compression_tpu_torch.ops import scalar, zstd_huff, zstd_seq

    payload = scalar.svb_compress(signals.TIERS["clean"](B, N)[0], 2, True, 0)
    branches = {"numpy": ((zstd_seq, "_native_lz"),
                          (zstd_huff, "_native_bits"))}
    if hasattr(zstd_seq, "_native_lz"):
        branches = {"native": (), **branches}
    else:  # a tree without the native branches runs only NumPy
        branches["numpy"] = ()
    out = {}
    for branch, off in branches.items():
        saved = [getattr(m, a) for m, a in off]
        for m, a in off:
            setattr(m, a, lambda: None)
        try:
            zstd_seq.compress_frame(payload, "device", "cuda")
            seconds = []
            for _ in range(OWN_REPEATS):
                t0 = time.perf_counter()
                zstd_seq.compress_frame(payload, "device", "cuda")
                seconds.append(time.perf_counter() - t0)
            prof = cProfile.Profile()
            prof.runcall(zstd_seq.compress_frame, payload, "device", "cuda")
        finally:
            for (m, a), fn in zip(off, saved):
                setattr(m, a, fn)
        stats = pstats.Stats(prof).stats
        rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
        out[f"own-tpu frame profile, {branch} branches"] = {
            "bytes": len(payload), "s": seconds,
            "profiled_s": sum(v[2] for v in stats.values()),
            "top": [{"function": f"{os.path.basename(f)}:{line}({name})",
                     "calls": nc, "own_s": tt, "cum_s": ct}
                    for (f, line, name), (_cc, nc, tt, ct, _c) in rows]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON result here")
    ap.add_argument("--only", action="append",
                    choices=("w2", "w4", "v1", "probe", "match", "own"),
                    help="time only these groups (repeatable; default all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device is visible")
    groups = args.only or ["w2", "w4", "v1", "probe", "match", "own"]
    smi = profiling.card()
    print(smi)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    times = {}
    for pair, enc_fn, dec_fn, e, d in (
            ("w2", svb_w2.encode_w2_rows, svb_w2.decode_w2_rows, "E", "D"),
            ("w4", svb_w4.encode_w4_rows, svb_w4.decode_w4_rows, "E4", "D4"),
            ("v1", svb_v1.encode_v1_rows, svb_v1.decode_v1_rows, "V1E",
             "V1D")):
        if pair not in groups:
            continue
        for label, (flavor, rows) in inputs(pair).items():
            times[f"{pair} {label}"] = t = time_input(enc_fn, dec_fn, flavor,
                                                      rows, flush)
            print(f"  {pair} {label:28s} {e} {t['enc_ms']:.4f} ms cold, "
                  f"{t['enc_warm_ms']:.4f} warm, bound "
                  f"{t['enc_bound_ms']:.4f}; {d} {t['dec_ms']:.4f} cold, "
                  f"{t['dec_warm_ms']:.4f} warm, bound "
                  f"{t['dec_bound_ms']:.4f}")
    for pair, flavors, names in (("w4", ("zz32", "none16"), ("E4", "D4")),
                                 ("v1", ("zz8", "none8"), ("V1E", "V1D"))):
        if pair not in groups:
            continue
        for flavor in flavors:
            for direction, kernel in zip(("encode", "decode"), names):
                times[f"{pair} {flavor} {direction} profile"] = kernels = \
                    profile(pair, flavor, direction)
                print(f"  {kernel} {flavor} under torch.profiler, per launch "
                      "over 5 calls:")
                for name, k in kernels.items():
                    print(f"    {k['launches']:3d} x {k['us']:8.2f} us  "
                          f"{name[:90]}")
    if "probe" in groups:
        for label, t in probe_turns(flush).items():
            times[label] = t
            print(f"  {label:34s} kernel {min(t['kernel_ms']):.4f}-"
                  f"{max(t['kernel_ms']):.4f} cold, "
                  f"{min(t['kernel_warm_ms']):.4f}-"
                  f"{max(t['kernel_warm_ms']):.4f} warm; library "
                  f"{min(t['library_ms']):.4f}-{max(t['library_ms']):.4f} "
                  f"cold, {min(t['library_warm_ms']):.4f}-"
                  f"{max(t['library_warm_ms']):.4f} warm; bound "
                  f"{t['bound_ms']:.5f}")
        times["launch floor"] = t = launch_floor(flush)
        print(f"  launch floor: CP on [8, 128] int32 {min(t['ms']):.4f}-"
              f"{max(t['ms']):.4f} ms cold, {min(t['warm_ms']):.4f}-"
              f"{max(t['warm_ms']):.4f} warm; bound {t['bound_ms']:.7f}")
    if "match" in groups:
        for label, t in match_times(flush).items():
            times[label] = t
            extra = ""
            if "index_ms" in t:
                extra += (f"; index {t['index_ms']:.4f} cold, "
                          f"{t['index_warm_ms']:.4f} warm, bound "
                          f"{t['index_bound_ms']:.5f}")
            if "plain_ms" in t:
                extra += (f"; plain {t['plain_ms']:.3f}; copy in "
                          f"{min(t['copy_in_host_ms']):.3f}-"
                          f"{max(t['copy_in_host_ms']):.3f} ms, map back "
                          f"{min(t['map_back_host_ms']):.3f}-"
                          f"{max(t['map_back_host_ms']):.3f} ms host to host")
            if "index_back_host_ms" in t:
                extra += (f", index back "
                          f"{min(t['index_back_host_ms']):.3f}-"
                          f"{max(t['index_back_host_ms']):.3f} ms")
            print(f"  {label:14s} [{t['n']}] M {t['ms']:.4f} ms cold, "
                  f"{t['warm_ms']:.4f} warm, bound {t['bound_ms']:.5f}, "
                  f"{t['candidates']} candidates{extra}")
    if "own" in groups:
        for label, t in own_tpu_times().items():
            times[label] = t
            print(f"  {label}: {min(t['s']):.3f}-{max(t['s']):.3f} s host to "
                  f"host, {t['bytes'] / min(t['s']) / 1e9:.4f} GB/s at best")
        for label, t in own_profile().items():
            times[label] = t
            print(f"  {label} [{t['bytes']}]: {min(t['s']):.3f}-"
                  f"{max(t['s']):.3f} s unprofiled; under cProfile "
                  f"{t['profiled_s']:.3f} s, by time of its own:")
            for r in t["top"]:
                print(f"    {r['own_s']:7.3f} s own {r['cum_s']:7.3f} s cum "
                      f"{r['calls']:6d} calls  {r['function']}")
    text = json.dumps({"card": smi, "times": times})
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
