#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure (each prints its seconds):
  1. device: a CUDA card must be visible; prints nvidia-smi's name and
     power limit;
  2. build: compiles the six kernel libraries from
     vbz_compression_tpu_torch/csrc (the three codecs, the copy, the
     probe, the match scan), one nvcc per source, all at once; then
     native/'s three libraries (phase 11), one g++ each, all at once;
  3. kernels against their plain PyTorch versions on the card, bit for bit,
     one row of each case also against the port's NumPy oracle:
     E/D (W2) on the int16 tiers (B=4 rows of 4M), the int16 wrap
     extremes, zz8 rows, ragged row lengths, a batch of unlike rows, and
     the look-back cases: lengths on tile edges, all-code-0 and all-code-1
     rows, data rows cut short, views at storage offsets off the 16-byte
     alignment, 20 repeated calls giving identical bytes; D's instance on
     the wire plane's v0 stream rows in place (decode_w2_streams) at the
     resident cell's shape, [128, 450,000] into [128, 200,000], values and
     ok against its plain version on the same card tensors, with stream
     lengths moved by +-1 and random rows, at M and M - 3, then timed,
     with the growths of its kept look-back buffer (STREAM_SCRATCH_GROWN:
     at most one, none in the timed calls) beside its launches;
     E4/D4 (W4) per flavor on [4, 4M] signal-like and uniform content, the
     code boundaries, the 32-bit wrap, ragged lengths and unlike rows, and
     the look-back cases of both (signals.w4_tile_cases per flavor: lengths
     on tile edges, all-code-0, all-code-3 and cycling rows, the int32 wrap
     extremes, none16/none8 sign extremes; data rows cut short, inputs and
     outputs at storage offsets off the 16-byte alignment, 20 repeated
     [4, 4M] E4 calls per flavor giving identical bytes and 20 D4 calls on
     zz32 giving identical values);
     V1E/V1D (v1) per flavor on [4, 4M] int8, the odd-nibble input, ragged
     lengths and unlike rows, and the look-back cases of both
     (signals.v1_tile_cases per flavor: lengths on tile edges, all-code-0,
     all-code-3 and cycling rows, odd nibble offsets carried across empty
     tiles, the none8 sign and zz8 delta extremes; data rows cut short,
     inputs at storage offsets 1-3, 20 repeated [4, 4M] V1E and V1D calls
     per flavor giving identical bytes and values);
  4. main paths: a 64-read corpus through vbz_compress_sized_batch /
     vbz_decompress_sized_batch at each option set of MAIN_PATHS, every frame
     identical to the oracle's and every read round-tripped; each path's
     kernels must have launched (counts set to 0 just before the path and
     read just after);
  5. times: kernel (L2 flushed before each call, and back to back) and plain
     version per tier, flavor and direction, with each kernel's bound (the
     bytes it must move at the card's 3.35 TB/s), and the batch API host to
     host per main path; also E/D on zz8 int8 walks [4, 4M] and a [64, 8192]
     batch, and E4 none32 / D on codec2's [1, 4096] input (the W4 and
     codec2 inputs come from tools.kernel_times);
  6. copy and probe kernels against their plain versions on the card, bit
     for bit, each call one launch (the butterfly too, all its stages):
     CP at 256 MiB and on row counts that are not powers of two,
     every case of the capability probe; each kernel timed on its first
     case, and the prefix sum also on 4M values (prefix_sum_4m), with the
     L2 flushed and back to back, beside its plain version, its one-call
     PyTorch equivalent where there is one, and its bound;
  7. the bench path: vbz_compression_tpu_torch.bench on the four tiers (one
     pass), the copy bandwidth, the pipeline line (zstd level 1 through the
     api's zstd stage) and the own encoder's line; E, D and CP must have
     launched (counts set to 0 just before and read just after);
  8. the probe path: vbz_compression_tpu_torch.tools.capability_probe, every
     case OK; every probe kernel, CP and kernel M at both widths (the int32
     offsets and the uint8 index, on signals.match_cases) must have
     launched;
  9. the corpus paths, on the 256 pseudo-reads (signals.pseudo_reads) at zstd
     level 0 (phase 12 runs them at level 1, compress_signals' default):
     (a) parallel.multihost.compress_signals at cd_values
     (0,2,1,0) and (0,2,0,0), one encode launch per bucket (E, then E4),
     every frame equal to the oracle's and every read round-tripped through
     the batch API on the card; (b) the data-parallel plane
     (parallel.sharded) in a world-1 NCCL group in this process on the
     largest bucket: gathered lengths equal to the local ones, totals their
     sums, every ok true, the bytes the oracle's, the rows round-tripped,
     the streams decoded by D in place (w2_decode_streams launched);
     (c) two tools.multihost_smoke processes on the one card, joined by
     gloo, over the pseudo-reads split into two in-memory files (which need
     no h5py; fast5 files and fast5vbz are checked by the CPU tests):
     identical global stats, and each .vbz file byte for byte the oracle's
     frames of that file's reads;
 10. the own-tpu zstd stage: kernel M (the match scan) at both widths, the
     int32 offsets (match_scan) and the uint8 index (match_index), against
     its plain versions bit for bit on signals.match_cases, on the
     StreamVByte payload of the clean tier's first 8 MiB chunk (5,243,482
     bytes), on views of it at storage offsets 1-3 and over 20 repeated
     calls; both timed there (L2 flushed and back to back) beside their
     plain versions and bounds (5N and 2N bytes), and the scan's copies
     timed apart (the payload in, the int32 map and the index back); then
     two paths at cd_values (0,2,1,1)
     with VBZ_ZSTD_ENCODER=own-tpu (the encoder's native branches on, as
     they are by default where libvbz_native.so builds; phase 11 times them
     against the NumPy branches), each frame byte for byte the same call's
     on the CPU with the plain scan: (a) the clean tier as 4 x 8 MiB chunks
     through vbz_compress_sized_batch, timed host to host and split into
     the scan (copy in, M's index, copy back) and the host's encoder, its
     frames' size beside the own host matcher's; (b) compress_signals on the
     256 pseudo-reads. E and M's index must launch on both (counts set to 0
     just before each path and read just after);
 11. the native host runtime, over native/'s three libraries that phase 2
     built (utils/_native_build.py: libvbz_native.so, libvbz_hdf_plugin.so,
     libfast5_reader.so; with the system's zstd.h, else, printed with the
     compiler's first error line, with the port's declarations of libzstd's
     ABI against libzstd.so.1; a failed build ends the run): (a) phase
     10's two own-tpu paths again, in turns with the encoder's native
     branches and with them patched off
     (zstd_seq._native_lz and zstd_huff._native_bits returning None), best
     of REPEATS each, every frame byte for byte phase 10's, the native calls
     counted (native_backend.CALLS) on the native turns and none on the
     NumPy turns, E and M's index launched on both; (b) every own-tpu frame
     of (a) decoded through the native C ABI (vbz_decompress_sized, libzstd
     in C: the first level-1 decode on a machine without zstandard) to its
     input; (c) NativeSvbBackend through the batch API on phase 4's 64-read
     corpus at (0,2,1,0), every frame phase 4's oracle frame, and back;
     (d) the pseudo-reads through the batch API with NativeSvbBackend at
     (0,2,1,1), own-tpu (the gil_free_svb branch: each chunk's whole
     pipeline in the pool, M on the card), the frames of (a); (e) the C ABI
     vbz_compress_sized / vbz_decompress_sized at (0,2,1,1) on the 64-read
     corpus, round trip; (f) the fast5 reader: which libhdf5 it found, or
     that none was (it reads no file here: no fast5 file can be written
     without h5py);
 12. the main path at zstd level 1, through the api's zstd stage (libzstd
     through the zstandard package where it imports, else libzstd.so.1
     through ctypes, utils/libzstd.py; a machine with neither fails the
     run): (a) the route, which must be libzstd.so.1 wherever zstandard
     cannot be imported; (b) each option set of MAIN_PATHS with its level
     set to 1 on phase 4's corpus through the batch API on the card, every
     frame the oracle backend's on the CPU (one process, one route), every
     read round-tripped, the pair's kernels launched and libzstd called
     (ZSTD_compress2 once a frame; counts set to 0 just before each path
     and read just after), timed host to host; the (0,2,1,1) frames also
     decoded through the native C ABI; (c) api.compress / decompress on
     default options for one read of each corpus dtype, and
     vbz_compress_sized / vbz_decompress_sized on single reads at
     (0,2,1,1); (d) compress_signals on the pseudo-reads at its defaults
     (level 1), frames the oracle's, and phase 9's two-process run at
     --zstd-level 1, each .vbz file the oracle's frames, both processes on
     the same route; (e) times: the batch API at (0,2,1,1) split into the
     StreamVByte stage and the zstd stage each way, compress_signals at
     levels 0 and 1 in turns, the bench's pipeline line at levels 1 and 0.
The line before the last lists the kernels with their launches, errors,
times and bounds (w2_decode_streams also its look-back buffer's growths,
scratch_grown); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np

B, N = 4, 4 << 20          # the timed shape: 4 rows of 4M values
CORPUS_READS = 64
READ_MIN, READ_MAX = 2_000, 4_000_000
REPEATS = 3
CALLS = 10                 # launches per back-to-back timed run
DEVICE = "cuda"
FLUSH_BYTES = 256 << 20    # zeroed before a cold call: over 5x the 50 MB L2
# (R, rows) of the copy cases: 256 MiB in the bench's tiles, then row
# counts that are not powers of two, a ragged last step inside the tile,
# and single-row tiles.
COPY_CASES = ((1 << 19, 8192), (3000, 600), (1000, 1))
RAGGED = np.array([1, 3, 4, 5, 4095, 4097, 16383, 16385], np.int32)

# (cd_values, corpus content, kernel pair) of each main path, in run order.
MAIN_PATHS = [
    ((0, 2, 1, 0), "int16", "w2"),
    ((0, 4, 1, 0), "int32_walk", "w4"),
    ((1, 1, 1, 0), "int8_walk", "v1"),
    ((0, 2, 0, 0), "adc_u16", "w4"),
    ((1, 1, 0, 0), "u8", "v1"),
    ((0, 1, 0, 0), "u8", "w4"),
    ((0, 4, 0, 0), "u32", "w4"),
]
# kernel pair -> (names, source, replaced pallas_call sites: encode, decode)
_OPS = "vbz_compression_tpu/ops/"
PAIRS = {
    "w2": (("w2_encode", "w2_decode"), "w2_codec.cu",
           [_OPS + "pallas_codec5.py:930", _OPS + "pallas_codec5.py:495",
            _OPS + "pallas_dense.py:311", _OPS + "pallas_codec3.py:433"],
           [_OPS + "pallas_codec5.py:1039", _OPS + "pallas_codec5.py:841",
            _OPS + "pallas_dense.py:522", _OPS + "pallas_codec3.py:632"]),
    "w4": (("w4_encode", "w4_decode"), "w4_codec.cu",
           [_OPS + "pallas_w4.py:188", _OPS + "pallas_codec3.py:762"],
           [_OPS + "pallas_w4.py:338", _OPS + "pallas_codec3.py:869"]),
    "v1": (("v1_encode", "v1_decode"), "v1_codec.cu",
           [_OPS + "pallas_v1.py:264"], [_OPS + "pallas_v1.py:425"]),
}
# flavor of a kernel pair -> oracle arguments (integer_size, zigzag, version)
ORACLE_ARGS = {
    ("w2", "zz16"): (2, True, 0), ("w2", "zz8"): (1, True, 0),
    ("w4", "zz32"): (4, True, 0), ("w4", "none32"): (4, False, 0),
    ("w4", "none16"): (2, False, 0), ("w4", "none8"): (1, False, 0),
    ("v1", "zz8"): (1, True, 1), ("v1", "none8"): (1, False, 1),
}
# The flavor each pair's headline time is taken on.
HEADLINE = {"w2": ("zz16", "realistic"), "w4": ("zz32", "signal"),
            "v1": ("zz8", "signal")}
# copy and probe kernels -> (source, replaced pallas_call site)
_PROBE = "vbz_compression_tpu_torch/csrc/probe.cu"
AUX = {
    "copy": ("vbz_compression_tpu_torch/csrc/copy.cu",
             "vbz_compression_tpu/utils/roofline.py:68"),
    "roll_lanes": (_PROBE, "tools/probe_dynroll.py:79"),
    "roll_rows": (_PROBE, "tools/probe_dynroll.py:79"),
    "flat_shift_right": (_PROBE, "tools/probe_dynroll.py:79"),
    "prefix_sum": (_PROBE, "tools/probe_dynroll.py:79"),
    "prefix_sum_4m": (_PROBE, "tools/probe_dynroll.py:79"),
    "store_bytes": (_PROBE, "tools/probe_i8dma.py:45"),
    "load_bytes": (_PROBE, "tools/probe_i8dma.py:64"),
    "pack_keys": (_PROBE, "tools/probe_keypack.py:50"),
    "unpack_keys": (_PROBE, "tools/probe_keypack.py:64"),
    "fetch_i32": (_PROBE, "tools/probe_widen.py:62"),
    "fetch_i8_widen": (_PROBE, "tools/probe_widen.py:62"),
    "butterfly_i16": (_PROBE, "tools/probe_i16roll.py:76"),
    "butterfly_i32": (_PROBE, "tools/probe_i16roll.py:76"),
}


class Port:
    """The port's modules, imported once the card is known to be there."""

    def __init__(self):
        import torch

        import vbz_compression_tpu_torch as pkg
        from vbz_compression_tpu_torch import (api, bench, native_backend,
                                               signals)
        from vbz_compression_tpu_torch.models import codec
        from vbz_compression_tpu_torch.ops import (_build, _rows, probes,
                                                   svb_v1, svb_w2, svb_w4,
                                                   zstd_huff, zstd_match,
                                                   zstd_seq)
        from vbz_compression_tpu_torch.parallel import multihost, sharded
        from vbz_compression_tpu_torch.tools import (capability_probe,
                                                     kernel_times)
        from vbz_compression_tpu_torch.utils import (_native_build, libzstd,
                                                     native_fast5, profiling,
                                                     roofline)

        self.torch, self.pkg, self.api, self.signals = torch, pkg, api, signals
        self.codec, self.multihost, self.sharded = codec, multihost, sharded
        self.build, self.bench, self.probe = _build, bench, capability_probe
        self.rows = _rows
        self.times = kernel_times
        self.probes, self.profiling, self.roofline = probes, profiling, roofline
        self.match, self.zstd_seq, self.zstd_huff = (zstd_match, zstd_seq,
                                                     zstd_huff)
        self.native, self.native_build = native_backend, _native_build
        self.native_fast5, self.libzstd = native_fast5, libzstd
        self.mods = {"w2": svb_w2, "w4": svb_w4, "v1": svb_v1}
        self.fns = {
            "w2": (svb_w2.encode_w2_rows, svb_w2.encode_w2_rows_plain,
                   svb_w2.decode_w2_rows, svb_w2.decode_w2_rows_plain),
            "w4": (svb_w4.encode_w4_rows, svb_w4.encode_w4_rows_plain,
                   svb_w4.decode_w4_rows, svb_w4.decode_w4_rows_plain),
            "v1": (svb_v1.encode_v1_rows, svb_v1.encode_v1_rows_plain,
                   svb_v1.decode_v1_rows, svb_v1.decode_v1_rows_plain),
        }

    def zero_counts(self) -> None:
        for m in self.mods.values():
            m.ENCODE_LAUNCHES = 0
            m.DECODE_LAUNCHES = 0
        self.mods["w2"].DECODE_STREAM_LAUNCHES = 0
        self.roofline.COPY_LAUNCHES = 0
        for key in self.match.LAUNCHES:
            self.match.LAUNCHES[key] = 0
        for key in self.probes.LAUNCHES:
            self.probes.LAUNCHES[key] = 0

    def counts(self) -> dict:
        """Launches per kernel name since the last zero_counts."""
        out = {}
        for pair, m in self.mods.items():
            e_name, d_name = PAIRS[pair][0]
            out[e_name], out[d_name] = m.ENCODE_LAUNCHES, m.DECODE_LAUNCHES
        out["w2_decode_streams"] = self.mods["w2"].DECODE_STREAM_LAUNCHES
        out["copy"] = self.roofline.COPY_LAUNCHES
        out.update(self.match.LAUNCHES)
        out.update(self.probes.LAUNCHES)
        return out

    def require_launched(self, what: str, launches: dict, names) -> None:
        idle = [n for n in names if launches[n] <= 0]
        if idle:
            raise SystemExit(f"{what} did not launch {idle}: {launches}")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _full(rows: np.ndarray) -> np.ndarray:
    return np.full(rows.shape[0], rows.shape[1], np.int32)


def w2_cases(sig, tier_rows: dict, tile: int) -> list:
    """(name, pair, flavor, rows [B, N], lens [B]) for kernels E and D."""
    rng = np.random.default_rng(5)
    cases = [(f"tier {k}", "w2", "zz16", v, _full(v))
             for k, v in tier_rows.items()]
    cases += [(name, "w2", flavor, rows, lens)
              for name, flavor, rows, lens in sig.w2_tile_cases(tile)]
    wrap = np.tile(np.array([-32768, 32767], np.int16), (2, 32768))
    cases.append(("wrap extremes", "w2", "zz16", wrap, _full(wrap)))
    n8 = 1 << 20
    zz8 = np.stack([sig.int8_walk(rng, n8), sig.uniform(rng, n8, np.int8),
                    np.full(n8, -7, np.int8)])
    cases.append(("zz8", "w2", "zz8", zz8,
                  np.array([n8, n8 - 3, 4097], np.int32)))
    ragged = sig.uniform(rng, RAGGED.size * 16388, np.int16).reshape(
        RAGGED.size, 16388)  # tails are garbage: masked by lens
    ragged[::2] = np.cumsum(rng.integers(-300, 300, (4, 16388)),
                            axis=1).astype(np.int16)
    cases.append(("ragged", "w2", "zz16", ragged, RAGGED))
    n = min(1 << 20, N)
    unlike = np.stack([tier_rows["pure"][0, :n], tier_rows["hard"][0, :n],
                       np.full(n, 1234, np.int16), tier_rows["mixed"][-1, :n],
                       wrap[0, :n // 16].repeat(16),
                       tier_rows["realistic"][-1, :n]])
    cases.append(("unlike rows", "w2", "zz16", unlike,
                  np.array([n, n - 1, n // 2, 3, 0, n - 4093], np.int32)))
    return cases


def v1_rows(sig, flavor: str) -> np.ndarray:
    """[B, N] int8 for v1: an int8 walk, uniform bytes, the odd-nibble
    pattern and a walk with long zero runs."""
    rng = np.random.default_rng(17 if flavor == "zz8" else 18)
    runs = sig.int8_walk(rng, N)
    runs[(np.arange(N) // 4096) % 2 == 0] = 0
    return np.stack([sig.int8_walk(rng, N), sig.uniform(rng, N, np.int8),
                     sig.v1_odd_nibbles(N), runs])


def new_cases(port: Port, sig) -> list:
    """(name, pair, flavor, rows, lens) for E4/D4 and V1E/V1D."""
    rng = np.random.default_rng(6)
    cases = [(name, "w4", flavor, rows, lens)
             for name, flavor, rows, lens in sig.w4_tile_cases(
                 port.build.lib("w4").vbz_w4_decode_tile())]
    cases += [(name, "v1", flavor, rows, lens)
              for name, flavor, rows, lens in sig.v1_tile_cases(
                  port.build.lib("v1").vbz_v1_decode_tile())]
    for flavor in ("zz32", "none32", "none16", "none8"):
        for content in ("signal", "uniform"):
            rows = port.times.w4_rows(flavor, content)
            cases.append((f"{flavor} {content}", "w4", flavor, rows,
                          _full(rows)))
    bounds = np.tile(np.array([0, 1, 255, 256, 65535, 65536, (1 << 24) - 1,
                               1 << 24], np.int32), (2, 8192))
    bounds[1] = -bounds[1]
    cases.append(("code boundaries", "w4", "none32", bounds, _full(bounds)))
    wrap = np.tile(np.array([-(1 << 31), (1 << 31) - 1], np.int32), (2, 32768))
    cases.append(("32-bit wrap", "w4", "zz32", wrap, _full(wrap)))
    ragged = sig.uniform(rng, RAGGED.size * 16388, np.int32).reshape(
        RAGGED.size, 16388)
    ragged[::2] = np.cumsum(rng.integers(-70000, 70000, (4, 16388)), axis=1)
    cases.append(("ragged", "w4", "zz32", ragged, RAGGED))
    cases.append(("ragged", "w4", "none16",
                  ragged.astype(np.int16), RAGGED))
    n = min(1 << 20, N)
    unlike = np.stack([sig.int32_walk(rng, n), sig.uniform(rng, n, np.int32),
                       np.full(n, 70000, np.int32), bounds[0, :n // 16].repeat(16),
                       np.zeros(n, np.int32)])
    unlike_lens = np.array([n, n - 1, n // 2, 3, 0], np.int32)
    cases.append(("unlike rows", "w4", "none32", unlike, unlike_lens))
    cases.append(("unlike rows", "w4", "zz32", unlike, unlike_lens))
    for flavor in ("zz8", "none8"):
        rows = v1_rows(sig, flavor)
        cases.append(("mixed int8", "v1", flavor, rows, _full(rows)))
        odd = sig.v1_odd_nibbles()[None]
        cases.append(("odd nibbles", "v1", flavor, odd, _full(odd)))
        ragged8 = sig.uniform(rng, RAGGED.size * 16388, np.int8).reshape(
            RAGGED.size, 16388)
        ragged8[::2] = sig.v1_odd_nibbles(4 * 16388).reshape(4, 16388)
        cases.append(("ragged", "v1", flavor, ragged8, RAGGED))
        unlike8 = np.stack([rows[0, :n], rows[1, :n], np.zeros(n, np.int8),
                            np.full(n, 9, np.int8), rows[2, :n]])
        cases.append(("unlike rows", "v1", flavor, unlike8, unlike_lens))
    return cases


def check_kernels(port: Port, cases) -> dict:
    """Each pair's kernels against its plain versions on the same CUDA
    tensors; returns the largest absolute difference seen per kernel name
    (must be 0)."""
    torch = port.torch
    err = {}
    for name, pair, flavor, rows, lens in cases:
        enc, enc_plain, dec, dec_plain = port.fns[pair]
        x = torch.from_numpy(rows).to(DEVICE)
        n = torch.from_numpy(lens).to(DEVICE)
        k1, d1, l1 = enc(x, n, flavor)
        k0, d0, l0 = enc_plain(x, n, flavor)
        written = torch.arange(d0.shape[1], device=DEVICE)[None, :] < l0[:, None]
        enc_err = max(
            int((l1 - l0).abs().max()),
            int((k1.int() - k0.int()).abs().max()),
            int((torch.where(written, d1, 0).int()
                 - torch.where(written, d0, 0).int()).abs().max()))
        o1 = dec(k1, d1, n, flavor)
        o0 = dec_plain(k1, d1, n, flavor)
        valid = torch.arange(x.shape[1], device=DEVICE)[None, :] < n[:, None]
        want = torch.where(valid, x, 0)
        dec_err = max(int((o1.long() - o0.long()).abs().max()),
                      int((o1.long() - want.long()).abs().max()))
        torch.cuda.synchronize()
        # One row against the NumPy oracle: the plain version is not the
        # only reference.
        r = int(np.argmax(lens))
        cnt = int(lens[r])
        stream = (k1[r, :(cnt + 3) // 4].cpu().numpy().tobytes()
                  + d1[r, :int(l1[r])].cpu().numpy().tobytes())
        oracle_ok = stream == port.pkg.oracle.svb_compress(
            rows[r, :cnt], *ORACLE_ARGS[(pair, flavor)])
        print(f"  {pair} {flavor:6s} {name:16s} [{rows.shape[0]}, "
              f"{rows.shape[1]}]: encode err {enc_err}, decode err "
              f"{dec_err}, row {r} vs oracle "
              f"{'ok' if oracle_ok else 'DIFFERS'}")
        if enc_err or dec_err or not oracle_ok:
            raise SystemExit(f"kernel mismatch in case {pair} {flavor} "
                             f"{name!r}")
        e_name, d_name = PAIRS[pair][0]
        err[e_name] = max(err.get(e_name, 0), enc_err)
        err[d_name] = max(err.get(d_name, 0), dec_err)
    return err


def _shifted(t, shift: int):
    """A contiguous copy of t that starts ``shift`` elements into its own
    buffer, so its address sits off the 16-byte alignment."""
    buf = t.new_empty(t.numel() + shift)
    view = buf[shift:].view(t.shape)
    view.copy_(t)
    return view


def check_w2_lookback(port: Port, tile: int, rows: np.ndarray) -> None:
    """D on data rows cut shorter than the keys require (the next row's
    bytes would show if D read at or past the cut); E and D on views at
    storage offsets off the vector alignment; and 20 calls of E and D on
    ``rows`` giving the same bytes: a look-back race would make them differ
    from call to call."""
    torch, w2 = port.torch, port.mods["w2"]
    for flavor in ("zz16", "zz8"):
        x, lens = next(c[2:] for c in port.signals.w2_tile_cases(tile)
                       if c[:2] == ("all code 1", flavor))
        n = torch.from_numpy(lens).to(DEVICE)
        keys, data, data_len = w2.encode_w2_rows(torch.from_numpy(x).to(
            DEVICE), n, flavor)
        for D in (1, tile - 1, 2 * tile + 1, int(data_len.min()) - 3):
            short = data[:, :D].contiguous()
            if not torch.equal(w2.decode_w2_rows(keys, short, n, flavor),
                               w2.decode_w2_rows_plain(keys, short, n,
                                                       flavor)):
                raise SystemExit(f"w2 {flavor}: D differs from plain on a "
                                 f"data row cut at {D} bytes")
    print("  w2 short data rows: D equals plain at every cut, zz16 and zz8")
    for flavor, shift in (("zz16", 1), ("zz16", 2), ("zz16", 4), ("zz8", 1),
                          ("zz8", 2), ("zz8", 3), ("zz8", 4)):
        x, lens = next(c[2:] for c in port.signals.w2_tile_cases(tile)
                       if c[:2] == ("tile edges", flavor))
        n = torch.from_numpy(lens).to(DEVICE)
        x = _shifted(torch.from_numpy(x).to(DEVICE), shift)
        keys, data, data_len = w2.encode_w2_rows(x, n, flavor)
        k0, d0, l0 = w2.encode_w2_rows_plain(x, n, flavor)
        written = torch.arange(d0.shape[1], device=DEVICE)[None] < l0[:, None]
        same = (torch.equal(keys, k0) and torch.equal(data_len, l0)
                and torch.equal(torch.where(written, data, 0),
                                torch.where(written, d0, 0))
                and torch.equal(
                    w2.decode_w2_rows(_shifted(keys, shift),
                                      _shifted(data, shift), n, flavor),
                    w2.decode_w2_rows_plain(keys, data, n, flavor)))
        if not same:
            raise SystemExit(f"w2 {flavor}: a view {shift} elements off its "
                             "buffer's start differs from plain")
    print("  w2 views at storage offsets 1, 2, 4 (int16) and 1-4 (int8): E "
          "and D equal plain")
    x = torch.from_numpy(rows).to(DEVICE)
    n = torch.from_numpy(_full(rows)).to(DEVICE)
    keys, data, data_len = w2.encode_w2_rows(x, n, "zz16")
    written = (torch.arange(data.shape[1], device=DEVICE)[None]
               < data_len[:, None])
    for _ in range(20):
        k, d, l = w2.encode_w2_rows(x, n, "zz16")
        same = (torch.equal(k, keys) and torch.equal(l, data_len)
                and torch.equal(torch.where(written, d, 0),
                                torch.where(written, data, 0))
                and torch.equal(w2.decode_w2_rows(keys, data, n, "zz16"), x))
        if not same:
            raise SystemExit("w2: a repeated call gave other bytes")
    print(f"  w2 repeats: 20 calls of E and D on {list(rows.shape)} give "
          "identical bytes")


# The resident cell's calls (benchmark/entries/plane_decode.py): 128 reads
# of 30,000-200,000 samples a call, each a row of M = W/4 + 2W stream bytes.
STREAM_B, STREAM_W = 128, 200_000
PLANE_DECODE = "vbz_compression_tpu/parallel/sharded.py:45"


def check_w2_streams(port: Port, tier_rows: dict) -> dict:
    """D's in-place instance (decode_w2_streams) at the resident cell's
    shape, [128, M = 450,000] stream rows into [128, 200,000]: against its
    plain version on the same card tensors, values and ok bit for bit, with
    stream lengths moved by +-1 and rows of random bytes (codes 2 and 3,
    data ends past M), on rows of M and of M - 3 bytes (key rows and data
    starts off every alignment); then timed on the rows as encoded, beside
    the plain version and the bound of the bytes it must move."""
    torch, w2, rows = port.torch, port.mods["w2"], port.rows
    B_S, W = STREAM_B, STREAM_W
    M = W // 4 + 2 * W
    rng = np.random.default_rng(23)
    lens = rng.integers(30_000, W + 1, B_S).astype(np.int32)
    lens[:8] = [W, 0, 1, 7, 4095, 4097, 30_000, W - 1]
    lens[10:12] = W  # the random rows: data ends past M
    flat = np.concatenate([tier_rows["realistic"].ravel(),
                           tier_rows["clean"].ravel()])[:B_S * W]
    x = torch.from_numpy(flat.reshape(B_S, W)).to(DEVICE)
    n = torch.from_numpy(lens).to(DEVICE)
    streams, slen, _ = port.sharded.batch_encode_sharded(x, n)
    if tuple(streams.shape) != (B_S, M):
        raise SystemExit(f"plane streams {tuple(streams.shape)}, not "
                         f"{(B_S, M)}")
    as_encoded = streams.clone(), slen.clone()
    bad = [8, 9, 11]  # rows whose stream length is not their keys' data end
    slen[8] += 1
    slen[9] -= 1
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    streams[10:12] = torch.randint(0, 256, (2, M), dtype=torch.uint8,
                                   device=DEVICE, generator=gen)
    keys, _, kl = rows.stream_sections(streams[10:12], n[10:12], W)
    codes = rows.unpack_keys(keys)
    live = rows.valid_mask(n[10:12], W)
    ends = kl + ((codes + 1) * live).sum(dim=1)
    if not bool(((codes >= 2) & live).any()) or not bool((ends > M).all()):
        raise SystemExit("random stream rows: no code 2 or 3, or a data end "
                         "inside the row")
    slen[10:12] = (ends + torch.tensor([0, 1], device=DEVICE)).to(slen.dtype)
    want_ok = torch.ones(B_S, dtype=torch.bool, device=DEVICE)
    want_ok[bad] = False
    good = want_ok.clone()
    good[10] = False
    want_x = torch.where(torch.arange(W, device=DEVICE)[None] < n[:, None],
                         x, 0)
    err = 0
    grown = w2.STREAM_SCRATCH_GROWN
    for width in (M, M - 3):
        s = streams[:, :width].contiguous()
        before = (w2.DECODE_STREAM_LAUNCHES, w2.DECODE_LAUNCHES)
        out, ok = w2.decode_w2_streams(s, n, slen, W, "zz16")
        launched = (w2.DECODE_STREAM_LAUNCHES - before[0],
                    w2.DECODE_LAUNCHES - before[1])
        p_out, p_ok = w2.decode_w2_streams_plain(s, n, slen, W, "zz16")
        err = max(err, int((out.long() - p_out.long()).abs().max()))
        same = (torch.equal(out, p_out) and torch.equal(ok, p_ok)
                and torch.equal(ok, want_ok)
                and torch.equal(out[good], want_x[good]))
        torch.cuda.synchronize()
        print(f"  w2 streams [{B_S}, {width}] -> [{B_S}, {W}]: values and "
              f"ok {'equal' if same else 'DIFFER FROM'} plain, rows {bad} "
              f"not ok, {launched[0]} launch of the streams instance, "
              f"{launched[1]} of D on sections, look-back buffer grown "
              f"{w2.STREAM_SCRATCH_GROWN - grown} times so far")
        if not same or err or launched != (1, 0):
            raise SystemExit(f"w2 streams on rows of {width} bytes: kernel "
                             "and plain differ, or the launches")
    del streams, out, p_out, s
    s, sl = as_encoded
    prof, roof = port.profiling, port.roofline
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    nbytes = int(sl.sum()) + (4 + 4 + 1) * B_S + 2 * B_S * W

    def kernel():
        return w2.decode_w2_streams(s, n, sl, W, "zz16")

    def plain():
        return w2.decode_w2_streams_plain(s, n, sl, W, "zz16")

    checked = w2.STREAM_SCRATCH_GROWN - grown
    launches = w2.DECODE_STREAM_LAUNCHES
    t = {"max_abs_err": err, "bytes": nbytes,
         "ms": prof.cold_ms(kernel, flush, REPEATS),
         "warm_ms": prof.warm_ms(kernel, CALLS, REPEATS),
         "plain_ms": prof.warm_ms(plain, CALLS, REPEATS),
         "bound_ms": roof.bound_ms(nbytes),
         "scratch_grown": w2.STREAM_SCRATCH_GROWN - grown,
         "timed_launches": w2.DECODE_STREAM_LAUNCHES - launches}
    print(f"    {t['ms']:.4f} ms cold, {t['warm_ms']:.4f} warm, plain "
          f"{t['plain_ms']:.3f}, bound {t['bound_ms']:.5f} ({nbytes} bytes: "
          "the streams, counts, stream lengths and ok, the values written)")
    print(f"    look-back buffer grown {t['scratch_grown']} times over "
          f"{t['timed_launches'] + 2} launches of the streams instance")
    if checked > 1 or t["scratch_grown"] != checked:
        raise SystemExit(f"w2 streams: the kept look-back buffer grew "
                         f"{checked} times in the checks and "
                         f"{t['scratch_grown'] - checked} in the timed calls "
                         "of one shape")
    return t


def check_w4_lookback(port: Port, tile: int) -> None:
    """D4 on data rows cut shorter than the keys require, per flavor;
    encoding inputs and decoding into outputs that start 1-3 elements into
    their buffer (off the 16-byte alignment); 20 E4 calls on [4, 4M] of each
    flavor giving the same bytes and 20 D4 calls on zz32 giving the same
    values: a look-back race would make them differ from call to call."""
    torch, w4 = port.torch, port.mods["w4"]
    cases = {c[:2]: c[2:] for c in port.signals.w4_tile_cases(tile)}
    flavors = ("zz32", "none32", "none16", "none8")
    for flavor in flavors:
        x, lens = cases[("tile edges", flavor)]
        n = torch.from_numpy(lens).to(DEVICE)
        x = torch.from_numpy(x).to(DEVICE)
        k0, d0, l0 = w4.encode_w4_rows_plain(x, n, flavor)
        written = torch.arange(d0.shape[1], device=DEVICE)[None] < l0[:, None]
        want = torch.where(torch.arange(x.shape[1], device=DEVICE)[None]
                           < n[:, None], x, 0)
        for shift in (1, 2, 3):
            keys, data, data_len = w4.encode_w4_rows(_shifted(x, shift), n,
                                                     flavor)
            same = (torch.equal(keys, k0) and torch.equal(data_len, l0)
                    and torch.equal(torch.where(written, data, 0),
                                    torch.where(written, d0, 0))
                    and torch.equal(w4.decode_w4_rows(keys, data, n, flavor),
                                    want))
            if not same:
                raise SystemExit(f"w4 {flavor}: E4 on an input {shift} "
                                 "elements off its buffer's start differs "
                                 "from plain")
    print("  w4 inputs at storage offsets 1-3: E4 equals plain, every flavor")
    for flavor in flavors:
        x, lens = cases[("all code 3", flavor)]
        x = torch.from_numpy(x).to(DEVICE)
        n = torch.from_numpy(lens).to(DEVICE)
        keys, data, data_len = w4.encode_w4_rows(x, n, flavor)
        for D in (1, tile - 1, 4 * tile + 1, int(data_len.min()) - 3):
            short = data[:, :D].contiguous()
            if not torch.equal(w4.decode_w4_rows(keys, short, n, flavor),
                               w4.decode_w4_rows_plain(keys, short, n,
                                                       flavor)):
                raise SystemExit(f"w4 {flavor}: D4 differs from plain on a "
                                 f"data row cut at {D} bytes")
        for shift in (1, 2, 3):
            out = _shifted(torch.zeros_like(x), shift)
            w4.decode_w4_rows(keys, data, n, flavor, out=out)
            if not torch.equal(out, x):
                raise SystemExit(f"w4 {flavor}: D4 into an output {shift} "
                                 "elements off its buffer's start differs")
    print("  w4 short data rows and outputs at storage offsets 1-3: D4 "
          "equals plain, every flavor")
    for flavor in flavors:
        x = torch.from_numpy(port.times.w4_rows(flavor, "signal")).to(DEVICE)
        n = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                       device=DEVICE)
        keys, data, data_len = w4.encode_w4_rows(x, n, flavor)
        written = (torch.arange(data.shape[1], device=DEVICE)[None]
                   < data_len[:, None])
        for _ in range(20):
            k, d, l = w4.encode_w4_rows(x, n, flavor)
            if not (torch.equal(k, keys) and torch.equal(l, data_len)
                    and torch.equal(torch.where(written, d, 0),
                                    torch.where(written, data, 0))):
                raise SystemExit(f"w4 {flavor}: a repeated E4 call gave "
                                 "other bytes")
            if flavor == "zz32" and not torch.equal(
                    w4.decode_w4_rows(keys, data, n, flavor), x):
                raise SystemExit("w4: a repeated D4 call gave other values")
    print(f"  w4 repeats: 20 calls of E4 on {list(x.shape)} of each flavor "
          "give identical bytes, 20 of D4 on zz32 identical values")


def check_v1_lookback(port: Port, tile: int) -> None:
    """V1E and V1D on inputs that start 1-3 bytes into their buffer (off
    the 16-byte alignment), with keys and data at the same shift; V1D on
    data rows cut shorter than the keys require, per flavor; 20 V1E and V1D
    calls on [4, 4M] int8 walks of each flavor giving the same bytes and
    values: a race in the look-back, or in the half-byte it carries, would
    make them differ from call to call."""
    torch, v1 = port.torch, port.mods["v1"]
    cases = {c[:2]: c[2:] for c in port.signals.v1_tile_cases(tile)}
    flavors = ("zz8", "none8")
    for flavor in flavors:
        x, lens = cases[("tile edges", flavor)]
        n = torch.from_numpy(lens).to(DEVICE)
        x = torch.from_numpy(x).to(DEVICE)
        k0, d0, l0 = v1.encode_v1_rows_plain(x, n, flavor)
        written = torch.arange(d0.shape[1], device=DEVICE)[None] < l0[:, None]
        want = torch.where(torch.arange(x.shape[1], device=DEVICE)[None]
                           < n[:, None], x, 0)
        for shift in (1, 2, 3):
            keys, data, data_len = v1.encode_v1_rows(_shifted(x, shift), n,
                                                     flavor)
            same = (torch.equal(keys, k0) and torch.equal(data_len, l0)
                    and torch.equal(torch.where(written, data, 0),
                                    torch.where(written, d0, 0))
                    and torch.equal(v1.decode_v1_rows(
                        _shifted(keys, shift), _shifted(data, shift), n,
                        flavor), want))
            if not same:
                raise SystemExit(f"v1 {flavor}: V1E or V1D on views {shift} "
                                 "bytes off their buffer's start differs "
                                 "from plain")
    print("  v1 views at storage offsets 1-3: V1E and V1D equal plain, both "
          "flavors")
    for flavor in flavors:
        x, lens = cases[("all code 3", flavor)]
        n = torch.from_numpy(lens).to(DEVICE)
        keys, data, data_len = v1.encode_v1_rows(torch.from_numpy(x).to(
            DEVICE), n, flavor)
        for D in (1, tile - 1, int(data_len.min()) - 3):
            short = data[:, :D].contiguous()
            if not torch.equal(v1.decode_v1_rows(keys, short, n, flavor),
                               v1.decode_v1_rows_plain(keys, short, n,
                                                       flavor)):
                raise SystemExit(f"v1 {flavor}: V1D differs from plain on a "
                                 f"data row cut at {D} bytes")
    print("  v1 short data rows: V1D equals plain at every cut, both flavors")
    x = torch.from_numpy(port.times.walk8()).to(DEVICE)
    n = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                   device=DEVICE)
    for flavor in flavors:
        keys, data, data_len = v1.encode_v1_rows(x, n, flavor)
        written = (torch.arange(data.shape[1], device=DEVICE)[None]
                   < data_len[:, None])
        for _ in range(20):
            k, d, l = v1.encode_v1_rows(x, n, flavor)
            if not (torch.equal(k, keys) and torch.equal(l, data_len)
                    and torch.equal(torch.where(written, d, 0),
                                    torch.where(written, data, 0))):
                raise SystemExit(f"v1 {flavor}: a repeated V1E call gave "
                                 "other bytes")
            if not torch.equal(v1.decode_v1_rows(keys, data, n, flavor), x):
                raise SystemExit(f"v1 {flavor}: a repeated V1D call gave "
                                 "other values")
    print(f"  v1 repeats: 20 calls of V1E and V1D on {list(x.shape)} of each "
          "flavor give identical bytes and values")


# ---------------------------------------------------------------------------
# Phase 4: the main paths
# ---------------------------------------------------------------------------


def main_path(port: Port, reads, cd_values, pair: str) -> dict:
    api, torch = port.api, port.torch
    opts = port.pkg.CompressionOptions.from_cd_values(cd_values)
    torch.cuda.synchronize()
    port.zero_counts()
    frames = api.vbz_compress_sized_batch(reads, opts)
    back = api.vbz_decompress_sized_batch(frames, opts)
    launches = port.counts()
    port.require_launched(f"main path {cd_values}", launches, PAIRS[pair][0])
    for i, (r, f, b) in enumerate(zip(reads, frames, back)):
        if f != api.vbz_compress_sized(r, opts, backend=port.pkg.oracle):
            raise SystemExit(f"{cd_values} read {i}: frame differs from the "
                             "NumPy oracle")
        if not np.array_equal(np.frombuffer(b, r.dtype), r):
            raise SystemExit(f"{cd_values} read {i}: round trip differs")
    enc_s = dec_s = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        api.vbz_compress_sized_batch(reads, opts)
        t1 = time.perf_counter()
        api.vbz_decompress_sized_batch(frames, opts)
        t2 = time.perf_counter()
        enc_s, dec_s = min(enc_s, t1 - t0), min(dec_s, t2 - t1)
    raw = sum(r.nbytes for r in reads)
    out = {"options": list(cd_values), "content": str(reads[0].dtype),
           "pair": pair, "reads": len(reads), "bytes": raw,
           "frame_bytes": sum(len(f) for f in frames),
           "launches": {k: v for k, v in launches.items() if v},
           "enc_s": enc_s, "dec_s": dec_s,
           "enc_gb_s": raw / enc_s / 1e9, "dec_gb_s": raw / dec_s / 1e9,
           "frames": frames}  # main() keeps NATIVE_OPTIONS' for phase 11
    print(f"  options {cd_values} ({out['content']}): {len(reads)} reads, "
          f"{raw} bytes -> {out['frame_bytes']} framed; every frame equals "
          f"the oracle's, every read round-trips; launches "
          f"{out['launches']}; host to host encode {out['enc_gb_s']:.3f} "
          f"GB/s, decode {out['dec_gb_s']:.3f} GB/s (best of {REPEATS})")
    return out


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------


def time_pair(port: Port, label: str, rows: np.ndarray, flush) -> dict:
    """Kernel (cold and warm) and plain times of one pair on [B, N] rows,
    with the bound of each direction: bytes it must move
    (``roofline.codec_bytes``) over the card's memory rate."""
    torch, prof, roof = port.torch, port.profiling, port.roofline
    pair, flavor, _ = label.split()
    enc, enc_plain, dec, dec_plain = port.fns[pair]
    x = torch.from_numpy(rows).to(DEVICE)
    lens = torch.from_numpy(_full(rows)).to(DEVICE)
    keys, data, data_len = enc(x, lens, flavor)
    raw = rows.nbytes
    enc_bytes, dec_bytes = roof.codec_bytes(x, keys, data_len)
    t = {
        "enc_ms": prof.cold_ms(lambda: enc(x, lens, flavor), flush, REPEATS),
        "enc_warm_ms": prof.warm_ms(lambda: enc(x, lens, flavor), CALLS,
                                    REPEATS),
        "enc_plain_ms": prof.warm_ms(lambda: enc_plain(x, lens, flavor),
                                     CALLS, REPEATS),
        "dec_ms": prof.cold_ms(lambda: dec(keys, data, lens, flavor), flush,
                               REPEATS),
        "dec_warm_ms": prof.warm_ms(lambda: dec(keys, data, lens, flavor),
                                    CALLS, REPEATS),
        "dec_plain_ms": prof.warm_ms(
            lambda: dec_plain(keys, data, lens, flavor), CALLS, REPEATS),
        "enc_bytes": enc_bytes, "dec_bytes": dec_bytes,
        "enc_bound_ms": roof.bound_ms(enc_bytes),
        "dec_bound_ms": roof.bound_ms(dec_bytes),
        "input_bytes": raw, "stream_bytes": dec_bytes - 4 * len(rows) - raw,
    }
    for k in ("enc", "enc_warm", "enc_plain", "dec", "dec_warm",
              "dec_plain"):
        t[k + "_gb_s"] = raw / (t[k + "_ms"] / 1e3) / 1e9
    print(f"  {label:22s} encode {t['enc_ms']:.4f} ms cold, "
          f"{t['enc_warm_ms']:.4f} warm, plain {t['enc_plain_ms']:.3f}, "
          f"bound {t['enc_bound_ms']:.4f}; decode {t['dec_ms']:.4f} cold, "
          f"{t['dec_warm_ms']:.4f} warm, plain {t['dec_plain_ms']:.3f}, "
          f"bound {t['dec_bound_ms']:.4f} ({raw / 1e6:.3f} MB in)")
    return t


# ---------------------------------------------------------------------------
# Phase 6: the copy and probe kernels against their plain versions
# ---------------------------------------------------------------------------


def check_aux(port: Port) -> dict:
    """CP on COPY_CASES and every capability-probe case, kernel against
    plain version on the card (must be equal); each kernel timed on its
    first case, one call with the L2 flushed and back to back, beside its
    plain version (back to back) and its one-call PyTorch equivalent (both
    ways). Returns {kernel name: numbers}."""
    torch, prof, roof = port.torch, port.profiling, port.roofline
    probe = port.probe
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    cases = []
    for R, rows in COPY_CASES:
        gen = torch.Generator(device=DEVICE).manual_seed(R)
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (R, 128), dtype=torch.int32,
                          device=DEVICE, generator=gen)
        dst = torch.empty_like(x)
        cases.append(probe.Case(
            f"copy [{R}, 128] tiles of {rows}", "copy",
            lambda x=x, rows=rows: roof.copy_blocked(x, rows),
            lambda x=x: roof.copy_blocked_plain(x),
            lambda x=x, dst=dst: dst.copy_(x), 2 * x.numel() * 4))
    cases += probe.cases(DEVICE)
    out = {}
    for case in cases:
        before = port.counts()[case.key]
        got = case.kernel()
        launches = port.counts()[case.key] - before
        err = probe.max_abs_err(got, case.plain())
        torch.cuda.synchronize()
        print(f"  {case.key:16s} {case.name:28s} max abs err {err}, "
              f"{launches} launch")
        if err != 0:
            raise SystemExit(f"kernel mismatch in {case.key} {case.name!r}")
        if launches != 1:
            raise SystemExit(f"{case.key} {case.name!r} took {launches} "
                             "launches, not one")
        name = case.timed_as or case.key
        if name in out:
            continue
        bound_ms = roof.bound_ms(case.nbytes)
        lib = case.library
        out[name] = t = {
            "max_abs_err": err, "timed_on": case.name, "counts_in": case.key,
            "ms": prof.cold_ms(case.kernel, flush, REPEATS),
            "warm_ms": prof.warm_ms(case.kernel, CALLS, REPEATS),
            "plain_ms": prof.warm_ms(case.plain, CALLS, REPEATS),
            "library_ms": prof.cold_ms(lib, flush, REPEATS) if lib else None,
            "library_warm_ms": (prof.warm_ms(lib, CALLS, REPEATS) if lib
                                else None),
            "bound_ms": bound_ms, "bound_by": "bytes"}
        libs = ("none" if lib is None else
                f"{t['library_ms']:.4f} cold, {t['library_warm_ms']:.4f} warm")
        print(f"    {t['ms']:.4f} ms cold, {t['warm_ms']:.4f} warm, plain "
              f"{t['plain_ms']:.4f}, library {libs}, bound {bound_ms:.5f}")
    return out


# ---------------------------------------------------------------------------
# Phases 7 and 8: the bench and probe paths
# ---------------------------------------------------------------------------


def bench_path(port: Port, tier_rows: dict) -> tuple[dict, list]:
    """The bench entry point once (one pass), launches counted."""
    rows = {t: tier_rows[t] for t in port.bench.TIERS}
    port.torch.cuda.synchronize()
    port.zero_counts()
    lines = port.bench.run(rows, passes=1)
    launches = port.counts()
    port.require_launched("the bench path", launches,
                          ("w2_encode", "w2_decode", "copy"))
    for line in lines:
        print("  " + json.dumps(line))
    pipe, codec = lines[0], lines[-1]
    numbers = [v for v in codec.values() if isinstance(v, float)]
    if pipe["zstd_level"] not in (0, 1) or not all(
            np.isfinite(numbers)) or not codec["value"] > 0:
        raise SystemExit("the bench's lines are not finite and positive")
    return {k: v for k, v in launches.items() if v}, lines


def probe_path(port: Port) -> tuple[dict, dict]:
    """The capability probe once, launches counted; every case OK."""
    port.torch.cuda.synchronize()
    port.zero_counts()
    result = port.probe.run()
    launches = port.counts()
    port.require_launched("the probe path", launches,
                          ("copy", *port.probes.LAUNCHES,
                           *port.match.LAUNCHES))
    for r in result["probes"]:
        print(f"  {r['case']:28s} {'OK' if r['ok'] else 'WRONG'} "
              f"{r['ms']:.4f} ms")
    print(f"  copy GB/s by tile rows: {result['copy_gb_s']}; dst.copy_: "
          f"{result['copy_library_gb_s']}")
    print(f"  {json.dumps(result['versions'])}")
    if not port.probe.ok(result):
        raise SystemExit("a capability probe case is WRONG")
    return {k: v for k, v in launches.items() if v}, result


# ---------------------------------------------------------------------------
# Phase 9: the corpus paths
# ---------------------------------------------------------------------------

# (cd_values, kernel pair) of the corpus driver's runs, at zstd level 0.
CORPUS_PATHS = (((0, 2, 1, 0), "w2"), ((0, 2, 0, 0), "w4"))
SMOKE_FILES = 2            # in-memory files of the two-process run
SMOKE_TIMEOUT = 300        # seconds each smoke process may take


def corpus_driver(port: Port, reads, cd_values, pair: str,
                  defaults: bool = False):
    """(a) compress_signals on the card: one encode launch per bucket, every
    frame the oracle's at ``cd_values``, every read round-tripped through
    the batch API on the card; with ``defaults``, compress_signals is given
    no options (its default is (0,2,1,1)). Returns (run, the oracle's
    frames)."""
    api, torch, pkg = port.api, port.torch, port.pkg
    opts = pkg.CompressionOptions.from_cd_values(cd_values)
    buckets = len({port.multihost.bucket_of(r.size) for r in reads})
    e_name, d_name = PAIRS[pair][0]
    torch.cuda.synchronize()
    port.zero_counts()
    zero_zstd_calls(port)
    t0 = time.perf_counter()
    frames = port.multihost.compress_signals(reads, None if defaults
                                             else opts)
    secs = time.perf_counter() - t0
    zstd_calls = port.libzstd.CALLS["ZSTD_compress2"]
    encodes = port.counts()[e_name]
    back = api.vbz_decompress_sized_batch(frames, opts)
    launches = port.counts()
    if encodes != buckets:
        raise SystemExit(f"corpus driver {cd_values}: {encodes} {e_name} "
                         f"launches for {buckets} buckets")
    port.require_launched(f"corpus driver {cd_values}", launches,
                          (e_name, d_name))
    want = [api.vbz_compress_sized(r, opts, backend=pkg.oracle)
            for r in reads]
    for i, (r, f, w, b) in enumerate(zip(reads, frames, want, back)):
        if f != w:
            raise SystemExit(f"corpus driver {cd_values} read {i}: frame "
                             "differs from the NumPy oracle")
        if not np.array_equal(np.frombuffer(b, np.int16), r):
            raise SystemExit(f"corpus driver {cd_values} read {i}: round "
                             "trip differs")
    raw = sum(r.nbytes for r in reads)
    what = "its defaults, " if defaults else ""
    run = {"path": f"corpus driver {what}{cd_values}", "reads": len(reads),
           "bytes": raw, "frame_bytes": sum(map(len, frames)),
           "buckets": buckets, "encode_launches": encodes,
           "libzstd_compress_calls": zstd_calls,
           "launches": {k: v for k, v in launches.items() if v},
           "host_to_host_s": secs}
    print(f"  compress_signals at {what}{cd_values}: {len(reads)} reads, "
          f"{raw} bytes -> {run['frame_bytes']} framed in {buckets} "
          f"buckets, {encodes} {e_name} launches, {zstd_calls} "
          "ZSTD_compress2 calls through libzstd.so.1; every frame equals the "
          f"oracle's, every read round-trips on the card; {secs:.3f} s host "
          "to host (one call)")
    return run, want


def plane_world1(port: Port, reads) -> dict:
    """(b) the data-parallel plane in a world-1 NCCL group on the largest
    bucket of ``reads``: both planes' gathered lengths against the local
    ones, totals, ok, the oracle's bytes and the round trips."""
    torch, sharded, oracle = port.torch, port.sharded, port.pkg.oracle
    mh = port.multihost
    width = max(mh.bucket_of(r.size) for r in reads)
    rows = [r for r in reads if mh.bucket_of(r.size) == width]
    x, lens = port.codec.padded_rows(rows, DEVICE, width)
    want = torch.where(torch.arange(width, device=DEVICE)[None]
                       < lens[:, None], x, 0)
    group = mh.initialize(mh.local_init_method(), 1, 0, "nccl")
    try:
        torch.cuda.synchronize()
        port.zero_counts()
        keys, data, data_len, total = sharded.batch_encode_sharded_rows(
            x, lens, group=group)
        back = sharded.batch_decode_sharded_rows(keys, data, lens,
                                                 group=group)
        streams, stream_lens, s_total = sharded.batch_encode_sharded(
            x, lens, group=group)
        out, ok = sharded.batch_decode_sharded(streams, lens, stream_lens,
                                               group=group, out_n=width)
        launches = port.counts()
        t0 = time.perf_counter()
        sharded.all_gather(data_len, group)
        torch.cuda.synchronize()
        gather_ms = (time.perf_counter() - t0) * 1e3
    finally:
        port.torch.distributed.destroy_process_group()
    port.require_launched("the plane", launches,
                          ("w2_encode", "w2_decode", "w2_decode_streams"))
    _, _, local_len, _ = sharded.batch_encode_sharded_rows(x, lens)
    _, local_stream_lens, _ = sharded.batch_encode_sharded(x, lens)
    B, N = x.shape
    keys_h, data_h = keys.cpu().numpy(), data.cpu().numpy()
    streams_h = streams.cpu().numpy()
    for b, r in enumerate(rows):
        ref = oracle.svb_compress(r, 2, True, 0)
        k = (r.size + 3) // 4
        if (keys_h[b, :k].tobytes() + data_h[b, :int(data_len[b])].tobytes()
                != ref or streams_h[b, :int(stream_lens[b])].tobytes()
                != ref):
            raise SystemExit(f"plane row {b}: bytes differ from the oracle")
    checks = {
        "rows lengths gathered = local": torch.equal(data_len, local_len),
        "rows total": int(total) == int(data_len.sum()) + B * N // 4,
        "rows round trip": torch.equal(back, want),
        "stream lengths gathered = local": torch.equal(stream_lens,
                                                       local_stream_lens),
        "streams total": int(s_total) == int(stream_lens.sum()),
        "every ok": bool(ok.all()),
        "streams round trip": torch.equal(out, want)}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"the plane in a world-1 NCCL group: {failed}")
    print(f"  plane, world-1 NCCL group, [{B}, {N}] int16: rows and wire "
          f"streams equal the oracle's, {', '.join(checks)}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; one all_gather of "
          f"{B} lengths {gather_ms:.3f} ms host to host")
    return {"path": "plane, world-1 NCCL group", "shape": [B, N],
            "launches": {k: v for k, v in launches.items() if v},
            "all_gather_host_ms": gather_ms}


def two_process_run(port: Port, n_reads: int, frames: list,
                    level: int = 0) -> dict:
    """(c) two multihost_smoke processes on the one card, gloo between them,
    over the pseudo-reads in SMOKE_FILES in-memory files at (0,2,1,level):
    identical global stats, each .vbz file the oracle's ``frames`` (one per
    read, in read order) of that file's reads."""
    import subprocess
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m",
               "vbz_compression_tpu_torch.tools.multihost_smoke",
               "file://" + os.path.join(tmp, "rendezvous"), "2", "RANK", tmp,
               "--backend", "gloo", "--pseudo-reads", str(n_reads),
               "--files", str(SMOKE_FILES), "--zstd-level", str(level)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([str(r) if a == "RANK" else a for a in cmd],
                                  cwd=root, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=SMOKE_TIMEOUT)
                if p.returncode != 0:
                    raise SystemExit(f"smoke rank failed: {err[-3000:]}")
                outs.append(json.loads([ln for ln in out.splitlines()
                                        if ln.startswith("{")][-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        keys = ("files", "reads", "raw_bytes", "compressed_bytes")
        stats = [{k: o[k] for k in keys} for o in outs]
        want = {"files": SMOKE_FILES, "reads": n_reads,
                "raw_bytes": sum(int.from_bytes(f[:4], "little")
                                 for f in frames),
                "compressed_bytes": sum(map(len, frames))}
        if stats != [want, want]:
            raise SystemExit(f"two-process stats {stats}, want {want}")
        names = sorted(n for n in os.listdir(tmp) if n.endswith(".vbz"))
        if len(names) != SMOKE_FILES:
            raise SystemExit(f"the two processes wrote {names}")
        for k, name in enumerate(names):
            expect = b"".join(np.uint32(len(frames[i])).tobytes() + frames[i]
                              for i in range(k, n_reads, SMOKE_FILES))
            with open(os.path.join(tmp, name), "rb") as f:
                if f.read() != expect:
                    raise SystemExit(f"{name} differs from the oracle's "
                                     "frames")
    launches = {}
    for o in outs:
        for k, v in o["launches"].items():
            launches[k] = launches.get(k, 0) + v
    routes = sorted({str(o["zstd_route"]) for o in outs})
    zstd_calls = sum(o["libzstd_compress_calls"] for o in outs)
    print(f"  two processes on one card (gloo), zstd level {level}: "
          f"identical stats {stats[0]}; both .vbz files equal the oracle's "
          f"frames; launches {launches}; zstd route {routes}, "
          f"ZSTD_compress2 calls {zstd_calls}; {wall:.2f} s wall from start "
          f"to both exits, ranks {[round(o['seconds'], 3) for o in outs]} s "
          "in compress_corpus")
    return {"path": f"two-process corpus run, zstd level {level}",
            "launches": launches, "stats": stats[0], "wall_s": wall,
            "rank_s": [o["seconds"] for o in outs], "zstd_routes": routes,
            "libzstd_compress_calls": zstd_calls}


# ---------------------------------------------------------------------------
# Phase 10: the own-tpu zstd stage
# ---------------------------------------------------------------------------

OWN_OPTIONS = (0, 2, 1, 1)  # the fast5 default, at zstd level 1
MATCH = "vbz_compression_tpu/ops/zstd_match_tpu.py:37"


def check_match(port: Port, clean: bytes) -> tuple[dict, dict]:
    """M at both widths (int32 offsets, uint8 index) against its plain
    versions on the same CUDA tensors: every case of signals.match_cases,
    the clean payload, views of it 1-3 bytes into their buffer, 20 repeated
    calls; then M's times (tools.kernel_times match_times) on the clean
    payload, zeros and uniform bytes beside its bounds (N bytes read, 4N or
    N written), the plain versions' times and the scan's copies (payload in,
    int32 map and index back) on the host clock. Returns the int32 and the
    index instance's numbers on the payload, the others under "inputs"."""
    torch, zm = port.torch, port.match
    lib = port.build.lib("match")
    cases = port.signals.match_cases(lib.vbz_match_tile(),
                                     lib.vbz_match_halo())
    cases.append(("clean payload", np.frombuffer(clean, np.uint8), None))
    widths = (("int32", zm.match_candidates, zm.match_candidates_plain,
               torch.int32),
              ("index", zm.match_index, zm.match_index_plain, torch.uint8))
    err = dict.fromkeys(("int32", "index"), 0)
    for name, buf, offsets in cases:
        offsets = zm.DEFAULT_OFFSETS if offsets is None else offsets
        x = torch.from_numpy(buf.copy()).to(DEVICE)
        line = f"  match {name:24s} [{buf.size}]:"
        for width, fn, plain, dtype in widths:
            got = fn(x, offsets)
            want = plain(x, offsets)
            e = int((got.long() - want.long()).abs().max()) if buf.size else 0
            torch.cuda.synchronize()
            line += f" {width} max abs err {e},"
            if e or got.dtype != dtype or got.shape != want.shape:
                raise SystemExit(f"kernel M ({width}) differs from plain on "
                                 f"{name!r}")
            err[width] = max(err[width], e)
        print(f"{line} {int((want > 0).sum())} candidates")
    x = torch.from_numpy(np.frombuffer(clean, np.uint8).copy()).to(DEVICE)
    for width, fn, plain, _ in widths:
        want = plain(x)
        for shift in (1, 2, 3):
            if not torch.equal(fn(_shifted(x, shift)), want):
                raise SystemExit(f"kernel M ({width}) on a view {shift} "
                                 "bytes off its buffer's start differs from "
                                 "plain")
        for _ in range(20):
            if not torch.equal(fn(x), want):
                raise SystemExit(f"kernel M ({width}): a repeated call gave "
                                 "other values")
    print("  match clean payload at storage offsets 1-3 and 20 repeated "
          "calls, both widths: equal to plain")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    inputs = port.times.match_times(flush, clean)
    del flush
    p = inputs.pop("match payload")
    t = dict(p, max_abs_err=err["int32"], bound_by="bytes", inputs=inputs)
    t_index = {"n": p["n"], "ms": p["index_ms"],
               "warm_ms": p["index_warm_ms"],
               "plain_ms": p["index_plain_ms"],
               "bound_ms": p["index_bound_ms"], "bound_by": "bytes",
               "max_abs_err": err["index"]}
    print(f"  M on the clean payload [{t['n']}]: int32 {t['ms']:.4f} ms cold, "
          f"{t['warm_ms']:.4f} warm, plain {t['plain_ms']:.3f}, bound "
          f"{t['bound_ms']:.5f}; index {t_index['ms']:.4f} ms cold, "
          f"{t_index['warm_ms']:.4f} warm, plain {t_index['plain_ms']:.3f}, "
          f"bound {t_index['bound_ms']:.5f}; copy in "
          f"{min(t['copy_in_host_ms']):.3f} ms, int32 map back "
          f"{min(t['map_back_host_ms']):.3f} ms, index back "
          f"{min(t['index_back_host_ms']):.3f} ms host to host (pageable, "
          "best of 5); on zeros int32 "
          f"{inputs['match zeros']['ms']:.4f} / index "
          f"{inputs['match zeros']['index_ms']:.4f} ms cold, on uniform "
          f"bytes {inputs['match uniform']['ms']:.4f} / "
          f"{inputs['match uniform']['index_ms']:.4f}")
    return t, t_index


def scan_split(port: Port, payloads: list) -> dict:
    """The own-tpu encoder per chunk payload, one after another: the scan
    (the payload's copy to the card, M, the index's copy back) and the whole
    frame, on the host clock; the host's part is their difference."""
    torch, zm = port.torch, port.match
    scan_s = frame_s = 0.0
    for p in payloads:
        buf = np.frombuffer(p, np.uint8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zm.match_index(torch.from_numpy(buf.copy()).to(DEVICE)).cpu()
        t1 = time.perf_counter()
        port.zstd_seq.compress_frame(p, matcher="device", device=DEVICE)
        t2 = time.perf_counter()
        scan_s, frame_s = scan_s + t1 - t0, frame_s + t2 - t1
    return {"scan_s": scan_s, "frame_s": frame_s,
            "host_s": frame_s - scan_s}


def own_tpu_paths(port: Port, chunks: list, reads: list) -> tuple:
    """(a) the clean chunks through the batch API and (b) the pseudo-reads
    through compress_signals at OWN_OPTIONS with VBZ_ZSTD_ENCODER=own-tpu:
    E and M launched, every frame the same call's on the CPU with the plain
    scan. Returns the two runs and their frames."""
    api, torch, pkg = port.api, port.torch, port.pkg
    opts = pkg.CompressionOptions.from_cd_values(OWN_OPTIONS)
    cpu = port.codec.TorchSvbBackend("cpu")
    with port.bench.encoder_env("own-tpu"):
        torch.cuda.synchronize()
        port.zero_counts()
        t0 = time.perf_counter()
        frames = api.vbz_compress_sized_batch(chunks, opts)
        first_s = time.perf_counter() - t0
        launches_a = port.counts()
        port.require_launched("own-tpu batch API", launches_a,
                              ("w2_encode", "match_index"))
        enc_s = first_s
        for _ in range(REPEATS - 1):
            t0 = time.perf_counter()
            again = api.vbz_compress_sized_batch(chunks, opts)
            enc_s = min(enc_s, time.perf_counter() - t0)
            if again != frames:
                raise SystemExit("own-tpu batch API: a repeated call gave "
                                 "other frames")
        if frames != api.vbz_compress_sized_batch(chunks, opts, backend=cpu):
            raise SystemExit("own-tpu batch API: frames differ from the "
                             "CPU path's (plain scan)")
        payloads = port.codec.TorchSvbBackend(DEVICE).svb_compress_batch(
            chunks, 2, True, 0)
        split = scan_split(port, [bytes(p) for p in payloads])
        torch.cuda.synchronize()
        port.zero_counts()
        t0 = time.perf_counter()
        corpus = port.multihost.compress_signals(reads, opts)
        corpus_s = time.perf_counter() - t0
        launches_b = port.counts()
        port.require_launched("own-tpu corpus driver", launches_b,
                              ("w2_encode", "match_index"))
        if corpus != port.multihost.compress_signals(reads, opts,
                                                     device="cpu"):
            raise SystemExit("own-tpu corpus driver: frames differ from the "
                             "CPU path's (plain scan)")
    with port.bench.encoder_env("own"):
        host_frames = api.vbz_compress_sized_batch(chunks, opts)
    for f, c in zip(frames + corpus, chunks + reads):
        # The sized header (the raw size), then the zstd magic number.
        if (f[:4] != np.uint32(c.nbytes).tobytes()
                or f[4:8] != bytes.fromhex("28b52ffd")):
            raise SystemExit("own-tpu: a frame is not a sized zstd frame")
    raw = sum(c.nbytes for c in chunks)
    run_a = {"path": f"own-tpu batch API {OWN_OPTIONS}", "chunks": len(chunks),
             "bytes": raw, "frame_bytes": sum(map(len, frames)),
             "own_host_frame_bytes": sum(map(len, host_frames)),
             "payload_bytes": sum(map(len, payloads)),
             "launches": {k: v for k, v in launches_a.items() if v},
             "enc_s": enc_s, "enc_gb_s": raw / enc_s / 1e9, **split}
    raw_b = sum(r.nbytes for r in reads)
    run_b = {"path": f"own-tpu corpus driver {OWN_OPTIONS}",
             "reads": len(reads), "bytes": raw_b,
             "frame_bytes": sum(map(len, corpus)),
             "launches": {k: v for k, v in launches_b.items() if v},
             "host_to_host_s": corpus_s, "gb_s": raw_b / corpus_s / 1e9}
    print(f"  own-tpu batch API {OWN_OPTIONS}: {len(chunks)} chunks, {raw} "
          f"bytes -> {run_a['frame_bytes']} framed (own host matcher "
          f"{run_a['own_host_frame_bytes']}); frames equal the CPU path's; "
          f"launches {run_a['launches']}; encode {enc_s:.3f} s host to host "
          f"({run_a['enc_gb_s']:.4f} GB/s, best of {REPEATS}); per chunk in "
          f"turn: scan {split['scan_s']:.3f} s, host {split['host_s']:.3f} "
          f"s of {split['frame_s']:.3f} s")
    print(f"  own-tpu compress_signals {OWN_OPTIONS}: {len(reads)} reads, "
          f"{raw_b} bytes -> {run_b['frame_bytes']} framed; frames equal the "
          f"CPU path's; launches {run_b['launches']}; {corpus_s:.3f} s host "
          f"to host ({run_b['gb_s']:.4f} GB/s, one call)")
    return [run_a, run_b], frames, corpus


# ---------------------------------------------------------------------------
# Phase 11: the native host runtime
# ---------------------------------------------------------------------------

NATIVE_OPTIONS = (0, 2, 1, 0)  # NativeSvbBackend against phase 4's frames


@contextlib.contextmanager
def numpy_branches(port: Port, on: bool = True):
    """With ``on``, the own zstd encoder with its native branches patched
    off, as tests/test_torch_native.py does: the NumPy code runs."""
    mods = ((port.zstd_seq, "_native_lz"), (port.zstd_huff, "_native_bits"))
    saved = [getattr(m, a) for m, a in mods]
    if on:
        for m, a in mods:
            setattr(m, a, lambda: None)
    try:
        yield
    finally:
        for (m, a), fn in zip(mods, saved):
            setattr(m, a, fn)


def native_build(port: Port) -> dict:
    """Build native/'s three libraries (phase 2); print the compiler, the
    zstd route and each build's seconds. A failed build raises (the run
    ends)."""
    import subprocess

    nb = port.native_build
    gxx = subprocess.run([nb.CXX, "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    err = nb.zstd_header_error()
    print(f"  {gxx}")
    if err is None:
        print("  zstd.h: the system's; -lzstd")
    else:
        print(f"  zstd.h: absent on this machine ({err}); libzstd through "
              "the port's declarations (vbz_compression_tpu_torch/"
              "native_include/zstd.h), linked against libzstd.so.1")
    built = nb.build()
    for name, (path, secs) in built.items():
        print(f"  build: {path.relative_to(nb.BUILD_ROOT.parent.parent)} in "
              f"{secs:.1f} s")
    return {"gxx": gxx, "zstd_header_error": err,
            "zstd_route": nb.zstd_route(),
            "build_s": {k: v for k, (_p, v) in built.items()}}


def _native_moved(port: Port, before: dict) -> dict:
    return {k: v - before[k] for k, v in port.native.CALLS.items()
            if v != before[k]}


def own_tpu_turns(port: Port, chunks: list, frames: list, reads: list,
                  corpus: list) -> tuple:
    """Phase 10's two own-tpu paths, in turns with the encoder's native
    branches and without, REPEATS turns each: every frame phase 10's, the
    native calls counted on the native turns only, E and M's index launched
    on every run. Returns the best times, the counts and each branch's
    last launches."""
    api, torch = port.api, port.torch
    opts = port.pkg.CompressionOptions.from_cd_values(OWN_OPTIONS)
    best = {b: {"batch_s": float("inf"), "corpus_s": float("inf")}
            for b in ("native", "numpy")}
    calls, launches = {}, {}
    with port.bench.encoder_env("own-tpu"):
        for _ in range(REPEATS):
            for branch in ("native", "numpy"):
                with numpy_branches(port, on=branch == "numpy"):
                    for path, fn, want, key in (
                            ("batch API", lambda: api.vbz_compress_sized_batch(
                                chunks, opts), frames, "batch_s"),
                            ("compress_signals",
                             lambda: port.multihost.compress_signals(
                                 reads, opts), corpus, "corpus_s")):
                        before = dict(port.native.CALLS)
                        torch.cuda.synchronize()
                        port.zero_counts()
                        t0 = time.perf_counter()
                        got = fn()
                        dt = time.perf_counter() - t0
                        ran = port.counts()
                        moved = _native_moved(port, before)
                        what = f"own-tpu {path} ({branch} branches)"
                        port.require_launched(what, ran,
                                              ("w2_encode", "match_index"))
                        if got != want:
                            raise SystemExit(f"{what}: frames differ from "
                                             "phase 10's")
                        if (branch == "native") != bool(moved):
                            raise SystemExit(f"{what}: native calls {moved}")
                        best[branch][key] = min(best[branch][key], dt)
                        calls[f"{branch} {path}"] = moved
                        launches[f"{branch} {path}"] = {
                            k: v for k, v in ran.items() if v}
    return best, calls, launches


def native_runtime(port: Port, built: dict, chunks: list, frames: list,
                   reads: list, corpus: list, corpus64: list,
                   oracle_frames: list) -> dict:
    """Phase 11 (see the module's docstring) over the libraries that phase 2
    built (``built``, :func:`native_build`'s result). Returns its numbers
    and its runs, each with the kernel launches counted over it."""
    api, torch, nb = port.api, port.torch, port.native
    out = dict(built)
    runs = []
    print(f"  native libraries built in phase 2 ({built['gxx']}; zstd "
          f"{built['zstd_route']}: "
          f"{built['zstd_header_error'] or 'the system header'})")

    # (a) own-tpu with and without the native branches, in turns.
    best, calls, launches = own_tpu_turns(port, chunks, frames, reads, corpus)
    raw_a = sum(c.nbytes for c in chunks)
    raw_b = sum(r.nbytes for r in reads)
    for branch in ("native", "numpy"):
        t = best[branch]
        print(f"  own-tpu batch API {OWN_OPTIONS}, {branch} branches: "
              f"{t['batch_s']:.4f} s host to host "
              f"({raw_a / t['batch_s'] / 1e9:.4f} GB/s, best of {REPEATS})")
        print(f"  own-tpu compress_signals {OWN_OPTIONS}, {branch} branches: "
              f"{t['corpus_s']:.4f} s host to host "
              f"({raw_b / t['corpus_s'] / 1e9:.4f} GB/s, best of {REPEATS})")
    for key in calls:
        print(f"  {key}: native calls {calls[key]}")
        print(f"  {key}: launches {launches[key]}")
        runs.append({"path": f"own-tpu {key}", "launches": launches[key]})
    print("  own-tpu frames with and without the native branches: equal to "
          "phase 10's, byte for byte")
    out.update(own_tpu=best, native_calls=calls, own_tpu_launches=launches,
               own_tpu_bytes={"batch": raw_a, "corpus": raw_b})

    # (b) every own-tpu frame decoded through the native C ABI.
    opts = port.pkg.CompressionOptions.from_cd_values(OWN_OPTIONS)
    before = dict(nb.CALLS)
    t0 = time.perf_counter()
    for f, c in zip(frames + corpus, chunks + reads):
        if nb.vbz_decompress_sized(f, opts) != c.tobytes():
            raise SystemExit("native C ABI: an own-tpu frame does not decode "
                             "to its input")
    dec_s = time.perf_counter() - t0
    n = len(frames) + len(corpus)
    moved = _native_moved(port, before)
    if moved.get("vbz_decompress_sized") != n:
        raise SystemExit(f"native C ABI decode: calls {moved}")
    print(f"  level-1 decode through the native C ABI: {n} own-tpu frames, "
          f"{raw_a + raw_b} bytes, every one its input; {dec_s:.4f} s host "
          f"to host ({(raw_a + raw_b) / dec_s / 1e9:.4f} GB/s, one pass); "
          f"native calls {moved}")
    out["level1_decode"] = {"frames": n, "bytes": raw_a + raw_b, "s": dec_s}

    # (c) NativeSvbBackend on phase 4's corpus against its oracle frames.
    o = port.pkg.CompressionOptions.from_cd_values(NATIVE_OPTIONS)
    before = dict(nb.CALLS)
    t0 = time.perf_counter()
    got = api.vbz_compress_sized_batch(corpus64, o, backend=nb.native_backend)
    t1 = time.perf_counter()
    back = api.vbz_decompress_sized_batch(got, o, backend=nb.native_backend)
    t2 = time.perf_counter()
    moved = _native_moved(port, before)
    if got != oracle_frames:
        raise SystemExit(f"NativeSvbBackend {NATIVE_OPTIONS}: frames differ "
                         "from phase 4's oracle frames")
    for r, b in zip(corpus64, back):
        if b != r.tobytes():
            raise SystemExit(f"NativeSvbBackend {NATIVE_OPTIONS}: a read does "
                             "not round-trip")
    if (moved.get("vbz_compress"), moved.get("vbz_decompress")) != \
            (len(corpus64), len(corpus64)):
        raise SystemExit(f"NativeSvbBackend: calls {moved}")
    raw64 = sum(r.nbytes for r in corpus64)
    print(f"  NativeSvbBackend batch API {NATIVE_OPTIONS}: {len(corpus64)} "
          f"reads, {raw64} bytes, every frame phase 4's oracle frame, every "
          f"read back; encode {t1 - t0:.4f} s, decode {t2 - t1:.4f} s host "
          f"to host (one pass); native calls {moved}")
    out["native_backend"] = {"options": list(NATIVE_OPTIONS), "bytes": raw64,
                             "enc_s": t1 - t0, "dec_s": t2 - t1}

    # (d) NativeSvbBackend with own-tpu: the gil_free_svb branch, M on the
    # card.
    with port.bench.encoder_env("own-tpu"):
        before = dict(nb.CALLS)
        torch.cuda.synchronize()
        port.zero_counts()
        t0 = time.perf_counter()
        got = api.vbz_compress_sized_batch(reads, opts,
                                           backend=nb.native_backend)
        dt = time.perf_counter() - t0
        ran = port.counts()
        moved = _native_moved(port, before)
    port.require_launched("NativeSvbBackend own-tpu", ran, ("match_index",))
    if got != corpus:
        raise SystemExit("NativeSvbBackend own-tpu: frames differ from "
                         "compress_signals'")
    if moved.get("vbz_compress") != len(reads) or \
            not moved.get("vbz_lz_sequences"):
        raise SystemExit(f"NativeSvbBackend own-tpu: calls {moved}")
    ran = {k: v for k, v in ran.items() if v}
    runs.append({"path": f"NativeSvbBackend own-tpu {OWN_OPTIONS}",
                 "launches": ran})
    print(f"  NativeSvbBackend batch API {OWN_OPTIONS}, own-tpu: "
          f"{len(reads)} reads, frames equal compress_signals'; {dt:.4f} s "
          f"host to host (one pass); launches {ran}; native calls {moved}")
    out["native_backend_own_tpu_s"] = dt

    # (e) the sized C ABI at (0,2,1,1): stock libzstd level 1.
    before = dict(nb.CALLS)
    t0 = time.perf_counter()
    sized = [nb.vbz_compress_sized(r, opts) for r in corpus64]
    t1 = time.perf_counter()
    for r, f in zip(corpus64, sized):
        if nb.vbz_decompress_sized(f, opts) != r.tobytes():
            raise SystemExit("native C ABI: a read does not round-trip")
    t2 = time.perf_counter()
    moved = _native_moved(port, before)
    print(f"  native C ABI {OWN_OPTIONS}: {len(corpus64)} reads, {raw64} "
          f"bytes -> {sum(map(len, sized))} framed, every read back; "
          f"compress {t1 - t0:.4f} s, decompress {t2 - t1:.4f} s host to "
          f"host (one pass); native calls {moved}")
    out["c_abi"] = {"options": list(OWN_OPTIONS), "bytes": raw64,
                    "frame_bytes": sum(map(len, sized)),
                    "enc_s": t1 - t0, "dec_s": t2 - t1}

    # (f) the fast5 reader.
    hdf5 = port.native_fast5._find_hdf5()
    try:
        port.native_fast5._load()
        reader = f"libhdf5 loaded ({hdf5 or 'a name the reader tries'})"
    except OSError as exc:
        reader = f"no libhdf5 (h5py's or find_library('hdf5'): {hdf5}): {exc}"
    print(f"  fast5 reader: built; {reader}; no fast5 file read (writing "
          "one takes h5py, which the card's machine lacks)")
    out["fast5_reader"] = reader
    out["runs"] = runs
    return out


# ---------------------------------------------------------------------------
# Phase 12: the main path at zstd level 1
# ---------------------------------------------------------------------------

FAST5_OPTIONS = (0, 2, 1, 1)  # the fast5 filter's default: E/D, then level 1
SINGLE_READS = 4              # reads of the corpus through the sized calls


def _level1(cd_values) -> tuple:
    return (*cd_values[:3], 1)


def zero_zstd_calls(port: Port) -> None:
    for key in port.libzstd.CALLS:
        port.libzstd.CALLS[key] = 0


def zstd_stage_route(port: Port) -> dict:
    """(a) The library the api's zstd stage calls: libzstd.so.1 through
    ctypes wherever the zstandard package cannot be imported. A missing
    library ends the run."""
    import importlib.util

    installed = importlib.util.find_spec("zstandard") is not None
    try:
        route = port.api.zstd_route()
    except OSError as exc:
        raise SystemExit(f"the api's zstd stage finds no libzstd: {exc}")
    ctypes_route = route.startswith("libzstd.so")
    print(f"  zstd route: {route}; zstandard "
          f"{'installed' if installed else 'not installed'}; the pool takes "
          f"up to {os.cpu_count()} threads")
    if not installed and not ctypes_route:
        raise SystemExit(f"zstandard is missing, yet the route is {route!r}")
    return {"route": route, "zstandard_installed": installed,
            "ctypes": ctypes_route, "pool_threads": os.cpu_count()}


def _require_zstd_calls(what: str, route: dict, calls: dict,
                        compressed: int) -> None:
    """On the ctypes route: one ZSTD_compress2 per frame and some
    ZSTD_decompress calls (a frame of content size 0 needs none)."""
    if route["ctypes"] and (calls.get("ZSTD_compress2") != compressed
                            or not calls.get("ZSTD_decompress")):
        raise SystemExit(f"{what}: libzstd calls {calls}, want "
                         f"{compressed} ZSTD_compress2 and some "
                         "ZSTD_decompress")


def level1_path(port: Port, route: dict, reads, cd_values,
                pair: str) -> tuple[dict, list]:
    """(b) One option set at level 1 through the batch API on the card:
    every frame the oracle backend's (the same route, on the CPU), every
    read round-tripped, the pair's kernels launched and libzstd called
    (counts set to 0 just before the path and read just after); times host
    to host, best of REPEATS. Returns (run, frames)."""
    api, torch = port.api, port.torch
    opts = port.pkg.CompressionOptions.from_cd_values(cd_values)
    torch.cuda.synchronize()
    port.zero_counts()
    zero_zstd_calls(port)
    frames = api.vbz_compress_sized_batch(reads, opts)
    back = api.vbz_decompress_sized_batch(frames, opts)
    launches = port.counts()
    calls = {k: v for k, v in port.libzstd.CALLS.items() if v}
    what = f"level-1 path {cd_values}"
    port.require_launched(what, launches, PAIRS[pair][0])
    _require_zstd_calls(what, route, calls, len(reads))
    if frames != api.vbz_compress_sized_batch(reads, opts,
                                              backend=port.pkg.oracle):
        raise SystemExit(f"{what}: frames differ from the oracle backend's")
    for i, (r, b) in enumerate(zip(reads, back)):
        if not np.array_equal(np.frombuffer(b, r.dtype), r):
            raise SystemExit(f"{what} read {i}: round trip differs")
    enc_s = dec_s = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        api.vbz_compress_sized_batch(reads, opts)
        t1 = time.perf_counter()
        api.vbz_decompress_sized_batch(frames, opts)
        t2 = time.perf_counter()
        enc_s, dec_s = min(enc_s, t1 - t0), min(dec_s, t2 - t1)
    raw = sum(r.nbytes for r in reads)
    run = {"path": what, "content": str(reads[0].dtype), "pair": pair,
           "reads": len(reads), "bytes": raw,
           "frame_bytes": sum(map(len, frames)),
           "launches": {k: v for k, v in launches.items() if v},
           "libzstd_calls": calls, "enc_s": enc_s, "dec_s": dec_s,
           "enc_gb_s": raw / enc_s / 1e9, "dec_gb_s": raw / dec_s / 1e9}
    print(f"  {cd_values} ({run['content']}): {len(reads)} reads, {raw} bytes "
          f"-> {run['frame_bytes']} framed; every frame equals the oracle "
          f"backend's, every read round-trips; launches {run['launches']}; "
          f"libzstd calls {calls}; host to host encode "
          f"{run['enc_gb_s']:.3f} GB/s, decode {run['dec_gb_s']:.3f} GB/s "
          f"(best of {REPEATS})")
    return run, frames


def native_decode(port: Port, reads, frames) -> dict:
    """The FAST5_OPTIONS frames through the native C ABI (libzstd in C, an
    independent reader of the tuned frames): every read back."""
    opts = port.pkg.CompressionOptions.from_cd_values(FAST5_OPTIONS)
    before = dict(port.native.CALLS)
    t0 = time.perf_counter()
    for i, (r, f) in enumerate(zip(reads, frames)):
        if port.native.vbz_decompress_sized(f, opts) != r.tobytes():
            raise SystemExit(f"native C ABI: level-1 frame {i} does not "
                             "decode to its read")
    secs = time.perf_counter() - t0
    moved = _native_moved(port, before)
    if moved.get("vbz_decompress_sized") != len(frames):
        raise SystemExit(f"native C ABI decode: calls {moved}")
    print(f"  {FAST5_OPTIONS} frames through the native C ABI: all "
          f"{len(frames)} decode to their reads; {secs:.4f} s host to host "
          "(one thread, one pass)")
    return {"frames": len(frames), "s": secs}


def stage_split(port: Port, reads, frames) -> dict:
    """(e) The batch API at FAST5_OPTIONS split into its stages, each
    direction, best of REPEATS, host to host: the StreamVByte stage (the
    CUDA backend's batch call: copies, E or D) and the zstd stage (content
    sizes and the pool), as the api runs them."""
    api = port.api
    opts = port.pkg.CompressionOptions.from_cd_values(FAST5_OPTIONS)
    backend = port.codec.TorchSvbBackend(DEVICE)
    args = (opts.integer_size, opts.perform_delta_zig_zag, opts.vbz_version)
    level = opts.zstd_compression_level
    raws = [r.tobytes() for r in reads]
    bodies = [f[4:] for f in frames]
    counts = [r.size for r in reads]
    best = dict.fromkeys(("svb_enc_s", "zstd_enc_s", "zstd_dec_s",
                          "svb_dec_s"), float("inf"))

    def unzstd(bodies):
        sizes = [api.zstd_frame_content_size(b) for b in bodies]
        return api._map_zstd(lambda bs: api.zstd_decompress(*bs),
                             list(zip(bodies, sizes)))

    for _ in range(REPEATS):
        port.torch.cuda.synchronize()
        t0 = time.perf_counter()
        payloads = [bytes(x) for x in backend.svb_compress_batch(raws,
                                                                 *args)]
        t1 = time.perf_counter()
        zstd = api._map_zstd(lambda x: api.zstd_compress(x, level), payloads)
        t2 = time.perf_counter()
        contents = unzstd(bodies)
        t3 = time.perf_counter()
        outs = backend.svb_decompress_batch(contents, counts, *args)
        t4 = time.perf_counter()
        for key, dt in (("svb_enc_s", t1 - t0), ("zstd_enc_s", t2 - t1),
                        ("zstd_dec_s", t3 - t2), ("svb_dec_s", t4 - t3)):
            best[key] = min(best[key], dt)
    if zstd != bodies or contents != payloads or any(
            np.ascontiguousarray(o).tobytes() != r
            for o, r in zip(outs, raws)):
        raise SystemExit("stage split: the stages do not give the batch "
                         "API's frames and reads")
    raw = sum(map(len, raws))
    out = dict(best, bytes=raw, payload_bytes=sum(map(len, payloads)),
               frame_bytes=sum(map(len, frames)))
    for key in best:
        out[key.replace("_s", "_gb_s")] = raw / best[key] / 1e9
    print(f"  {FAST5_OPTIONS} split, {len(reads)} reads, best of {REPEATS}: "
          f"encode StreamVByte {best['svb_enc_s']:.4f} s + zstd "
          f"{best['zstd_enc_s']:.4f} s; decode zstd {best['zstd_dec_s']:.4f} "
          f"s + StreamVByte {best['svb_dec_s']:.4f} s "
          f"({out['payload_bytes']} payload bytes)")
    return out


def level1_entry_points(port: Port, route: dict, by_dtype: dict, reads16,
                        frames16) -> dict:
    """(c) api.compress / decompress on default options (level 1, the
    dtype's flavor) for one read of each corpus dtype, each frame the
    oracle backend's; vbz_compress_sized / vbz_decompress_sized on single
    reads at FAST5_OPTIONS, each frame the batch API's."""
    api, torch, oracle = port.api, port.torch, port.pkg.oracle
    opts = port.pkg.CompressionOptions.from_cd_values(FAST5_OPTIONS)
    single = range(0, len(reads16), len(reads16) // SINGLE_READS)
    torch.cuda.synchronize()
    port.zero_counts()
    zero_zstd_calls(port)
    for name, r in by_dtype.items():
        f = api.compress(r)
        if not np.array_equal(api.decompress(f, r.dtype), r):
            raise SystemExit(f"api.compress/decompress ({name}): round trip "
                             "differs")
        if f.tobytes() != api.compress(r, backend=oracle).tobytes():
            raise SystemExit(f"api.compress ({name}): frame differs from the "
                             "oracle backend's")
    for i in single:
        f = api.vbz_compress_sized(reads16[i], opts)
        if f != frames16[i]:
            raise SystemExit(f"vbz_compress_sized read {i}: frame differs "
                             "from the batch API's")
        if api.vbz_decompress_sized(f, opts) != reads16[i].tobytes():
            raise SystemExit(f"vbz_decompress_sized read {i}: round trip "
                             "differs")
    launches = port.counts()
    calls = {k: v for k, v in port.libzstd.CALLS.items() if v}
    what = "api.compress and the sized calls at level 1"
    port.require_launched(what, launches, ("w2_encode", "w2_decode",
                                           "w4_encode", "w4_decode"))
    # Each api.compress runs twice (card, oracle), each sized call once.
    _require_zstd_calls(what, route, calls, 2 * len(by_dtype) + len(single))
    run = {"path": what, "dtypes": sorted(by_dtype),
           "single_reads": list(single),
           "launches": {k: v for k, v in launches.items() if v},
           "libzstd_calls": calls}
    print(f"  api.compress / decompress on default options, one read each of "
          f"{run['dtypes']}: frames the oracle backend's, arrays back; "
          f"vbz_compress_sized / vbz_decompress_sized at {FAST5_OPTIONS} on "
          f"reads {run['single_reads']}: the batch API's frames, reads back; "
          f"launches {run['launches']}; libzstd calls {calls}")
    return run


def corpus_level_times(port: Port, pseudo) -> dict:
    """(e) compress_signals on the pseudo-reads at (0,2,1,0) and at its
    defaults (level 1), in turns, best of REPEATS, host to host."""
    opts0 = port.pkg.CompressionOptions.from_cd_values((0, 2, 1, 0))
    best = {0: float("inf"), 1: float("inf")}
    for _ in range(REPEATS):
        for level, opts in ((0, opts0), (1, None)):
            port.torch.cuda.synchronize()
            t0 = time.perf_counter()
            port.multihost.compress_signals(pseudo, opts)
            best[level] = min(best[level], time.perf_counter() - t0)
    raw = sum(r.nbytes for r in pseudo)
    print(f"  compress_signals on {len(pseudo)} reads, in turns, best of "
          f"{REPEATS}: level 0 {best[0]:.4f} s ({raw / best[0] / 1e9:.3f} "
          f"GB/s), level 1 {best[1]:.4f} s ({raw / best[1] / 1e9:.3f} GB/s)")
    return {"bytes": raw, "level0_s": best[0], "level1_s": best[1]}


def pipeline_levels(port: Port, route: dict, clean, bench_lines) -> dict:
    """(e) The bench's pipeline line at level 1 and at level 0, from the
    bench's own function; phase 7's line must be level 1 on this route."""
    bench = port.bench
    first = bench_lines[0]
    if first["zstd_level"] != 1 or first["zstd_route"] != route["route"]:
        raise SystemExit(f"the bench's pipeline line ran at level "
                         f"{first['zstd_level']} through "
                         f"{first['zstd_route']}, not level 1 through "
                         f"{route['route']}")
    torch = port.torch
    torch.cuda.synchronize()
    port.zero_counts()
    lines = {level: bench.pipeline_line(bench.pipeline_gbps(
        clean, port.codec.TorchSvbBackend(DEVICE), level))
        for level in (1, 0)}
    launches = port.counts()
    port.require_launched("the bench's pipeline", launches,
                          ("w2_encode", "w2_decode"))
    for line in lines.values():
        print("  " + json.dumps(line))
    return {"path": "the bench's pipeline at levels 1 and 0",
            "launches": {k: v for k, v in launches.items() if v},
            "lines": list(lines.values())}


def main() -> int:
    import torch

    # Phase 1: device.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    t_phase = time.perf_counter()
    port = Port()
    sig = port.signals
    smi = port.profiling.card()
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    os.environ.pop("VBZ_BACKEND", None)  # the main path is the CUDA default
    seconds = {}

    def lap(phase: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        seconds[phase] = now - t_phase
        print(f"phase {phase}: {seconds[phase]:.1f} s")
        t_phase = now

    lap("1 device")

    # Phase 2: build.
    for name, (path, secs) in port.build.build_all().items():
        port.build.lib(name)
        print(f"build: {path.relative_to(port.build.BUILD_ROOT.parent.parent)}"
              f" in {secs:.1f} s")
    native_built = native_build(port)
    lap("2 build")

    # Phase 3: kernels against the plain versions.
    print("kernels against plain:")
    t0 = time.perf_counter()
    tier_rows = sig.tiers(B, N)
    print(f"  tiers {sorted(tier_rows)} at [{B}, {N}] generated on the host "
          f"in {time.perf_counter() - t0:.1f} s")
    tile = port.build.lib("w2").vbz_w2_tile()
    err = check_kernels(port, w2_cases(sig, tier_rows, tile)
                        + new_cases(port, sig))
    check_w2_lookback(port, tile, tier_rows["realistic"])
    w2_streams = check_w2_streams(port, tier_rows)
    check_w4_lookback(port, port.build.lib("w4").vbz_w4_decode_tile())
    check_v1_lookback(port, port.build.lib("v1").vbz_v1_decode_tile())
    lap("3 kernels")

    # Phase 4: the main paths.
    print("main paths:")
    reads16 = sig.corpus(CORPUS_READS, READ_MIN, READ_MAX)
    lengths = [r.size for r in reads16]
    runs = []
    for cd_values, content, pair in MAIN_PATHS:
        reads = reads16 if content == "int16" else sig.corpus_of(content,
                                                                 lengths)
        runs.append(main_path(port, reads, cd_values, pair))
        frames = runs[-1].pop("frames")
        if cd_values == NATIVE_OPTIONS:
            native_oracle_frames = frames
        del reads, frames
    lap("4 main paths")

    # Phase 5: times.
    print(f"times on {smi}, [{B}, {N}] per call, best of {REPEATS}:")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    inputs = {f"w2 zz16 {k}": v for k, v in tier_rows.items()}
    for flavor in ("zz32", "none32", "none16", "none8"):
        inputs[f"w4 {flavor} signal"] = port.times.w4_rows(flavor, "signal")
    inputs["w4 zz32 uniform"] = port.times.w4_rows("zz32", "uniform")
    walk8 = port.times.walk8()
    inputs["v1 zz8 signal"] = inputs["v1 none8 signal"] = walk8
    inputs["w2 zz8 signal"] = walk8
    inputs["v1 zz8 uniform"] = sig.uniform(np.random.default_rng(9), B * N,
                                           np.int8).reshape(B, N)
    # Rows 8-9 and 12 of PERF.md's kernel table: the short chunks that
    # pallas_codec3 took, as one batch, and codec2's input.
    inputs["w2 zz16 batch64x8192"] = sig.TIERS["realistic"](64, 8192)
    c2_sig, c2_zz = port.times.codec2_rows()
    inputs["w4 none32 codec2"] = c2_zz
    inputs["w2 zz16 codec2"] = c2_sig
    times = {label: time_pair(port, label, rows, flush)
             for label, rows in inputs.items()}
    del flush
    lap("5 times")

    # Phase 6: the copy and probe kernels against their plain versions.
    print("copy and probe kernels against plain:")
    aux = check_aux(port)
    lap("6 copy and probe kernels")

    # Phase 7: the bench path.
    print("bench path:")
    bench_launches, bench_lines = bench_path(port, tier_rows)
    runs.append({"path": "bench", "launches": bench_launches})
    lap("7 bench path")

    # Phase 8: the probe path.
    print("probe path:")
    probe_launches, probe_result = probe_path(port)
    runs.append({"path": "capability probe", "launches": probe_launches})
    lap("8 probe path")

    # Phase 9: the corpus paths.
    print("corpus paths (zstd level 0):")
    pseudo = sig.pseudo_reads()
    oracle_frames = {}
    for cd_values, pair in CORPUS_PATHS:
        run, oracle_frames[cd_values] = corpus_driver(port, pseudo, cd_values,
                                                      pair)
        runs.append(run)
    runs.append(plane_world1(port, pseudo))
    runs.append(two_process_run(port, len(pseudo),
                                oracle_frames[CORPUS_PATHS[0][0]]))
    lap("9 corpus paths")

    # Phase 10: the own-tpu zstd stage.
    print("own-tpu zstd stage:")
    clean_chunks = list(tier_rows["clean"])
    match, match_index = check_match(port, port.pkg.oracle.svb_compress(
        clean_chunks[0], 2, True, 0))
    own_runs, own_frames, own_corpus = own_tpu_paths(port, clean_chunks,
                                                     pseudo)
    runs += own_runs
    lap("10 own-tpu zstd stage")

    # Phase 11: the native host runtime.
    print("native host runtime:")
    native = native_runtime(port, native_built, clean_chunks, own_frames,
                            pseudo, own_corpus, reads16, native_oracle_frames)
    runs += native.pop("runs")
    lap("11 native host runtime")

    # Phase 12: the main path at zstd level 1.
    print("main path at zstd level 1:")
    route = zstd_stage_route(port)
    level1 = {"route": route}
    by_dtype = {}
    for cd_values, content, pair in MAIN_PATHS:
        reads = reads16 if content == "int16" else sig.corpus_of(content,
                                                                 lengths)
        run, frames = level1_path(port, route, reads, _level1(cd_values),
                                  pair)
        runs.append(run)
        by_dtype.setdefault(str(reads[0].dtype), reads[len(reads) // 2])
        if _level1(cd_values) == FAST5_OPTIONS:
            frames16 = frames
            level1["native_c_abi"] = native_decode(port, reads, frames)
            level1["split"] = stage_split(port, reads, frames)
        del reads, frames
    runs.append(level1_entry_points(port, route, by_dtype, reads16,
                                    frames16))
    run, want = corpus_driver(port, pseudo, FAST5_OPTIONS, "w2",
                              defaults=True)
    if route["ctypes"] and run["libzstd_compress_calls"] != len(pseudo):
        raise SystemExit(f"compress_signals at its defaults: "
                         f"{run['libzstd_compress_calls']} ZSTD_compress2 "
                         f"calls for {len(pseudo)} reads")
    runs.append(run)
    run = two_process_run(port, len(pseudo), want, level=1)
    if route["ctypes"] and (run["zstd_routes"] != [route["route"]]
                            or run["libzstd_compress_calls"] != len(pseudo)):
        raise SystemExit(f"two-process run at level 1: routes "
                         f"{run['zstd_routes']}, ZSTD_compress2 calls "
                         f"{run['libzstd_compress_calls']}")
    runs.append(run)
    level1["compress_signals"] = corpus_level_times(port, pseudo)
    pipe = pipeline_levels(port, route, tier_rows["clean"], bench_lines)
    level1["pipeline"] = pipe["lines"]
    runs.append(pipe)
    lap("12 main path at zstd level 1")
    for mod in ("jax", "vbz_compression_tpu"):
        if mod in sys.modules or any(m.startswith(mod + ".")
                                     for m in sys.modules):
            raise SystemExit(f"{mod} was imported")

    def launched(name):
        return sum(r["launches"].get(name, 0) for r in runs)

    kernels = []
    for pair, ((e_name, d_name), src, enc_sites, dec_sites) in PAIRS.items():
        flavor, content = HEADLINE[pair]
        head = times[f"{pair} {flavor} {content}"]
        for d, name, sites in (("enc", e_name, enc_sites),
                               ("dec", d_name, dec_sites)):
            kernels.append({
                "name": name, "route": "cuda",
                "source": "vbz_compression_tpu_torch/csrc/" + src,
                "replaces": sites[0], "also_replaces": sites[1:],
                "launches": launched(name),
                "max_abs_err": err[name],
                "ms": head[d + "_ms"], "plain_ms": head[d + "_plain_ms"],
                "bound_ms": head[d + "_bound_ms"], "bound_by": "bytes",
                "library_ms": None,
                "warm_ms": head[d + "_warm_ms"],
                "timed_on": f"{pair} {flavor} {content} [{B}, {N}], L2 "
                            "flushed before the call"})
    t = w2_streams
    kernels.append({
        "name": "w2_decode_streams", "route": "cuda",
        "source": "vbz_compression_tpu_torch/csrc/w2_codec.cu",
        "replaces": PLANE_DECODE, "also_replaces": [],
        "launches": launched("w2_decode_streams"),
        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "warm_ms": t["warm_ms"],
        "scratch_grown": t["scratch_grown"],
        "timed_on": f"the plane's v0 streams [{STREAM_B}, "
                    f"{STREAM_W // 4 + 2 * STREAM_W}] into [{STREAM_B}, "
                    f"{STREAM_W}] int16, L2 flushed before the call"})
    for name, (src, site) in AUX.items():
        t = aux[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": site,
            "launches": launched(t["counts_in"]),
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "warm_ms": t["warm_ms"],
            "timed_on": f"{t['timed_on']}, L2 flushed before the call"})
    for name, t in (("match_scan", match), ("match_index", match_index)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "vbz_compression_tpu_torch/csrc/match_scan.cu",
            "replaces": MATCH, "launches": launched(name),
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "warm_ms": t["warm_ms"],
            "timed_on": f"the clean tier's first chunk's payload [{t['n']}] "
                        "uint8, L2 flushed before the call"})
    print(json.dumps({"times": times, "w2_streams": w2_streams,
                      "main_paths": runs, "aux": aux,
                      "match": match, "match_index": match_index,
                      "native": native, "level1": level1,
                      "bench": bench_lines,
                      "probe_device_ops": probe_result["device_ops"],
                      "card": smi, "seconds": seconds}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
