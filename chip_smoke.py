#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure:
  1. device: a CUDA card must be visible; prints nvidia-smi's name and
     power limit;
  2. build: compiles the W2 kernels from vbz_compression_tpu_torch/csrc;
  3. kernels against their plain PyTorch versions on the card, bit for bit:
     the four signal tiers (B=4 rows of 4M int16), the int16 wrap extremes,
     zz8 rows, ragged row lengths and a batch of unlike rows;
  4. main path: a 64-read corpus through vbz_compress_sized_batch /
     vbz_decompress_sized_batch (options (0,2,1,0)), every frame identical to
     the NumPy oracle's and every read round-tripped, with the kernel launch
     counts of that run;
  5. times: kernel and plain per tier and direction (CUDA events, best of 3),
     and the batch API host to host.
The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches, errors and times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

B, N = 4, 4 << 20          # the tiers: 4 rows of 4M int16 (8 MiB each)
CORPUS_READS = 64
READ_MIN, READ_MAX = 2_000, 4_000_000
REPEATS = 3
CALLS = 10                 # launches per timed run
DEVICE = "cuda"


def kernel_cases(tier_rows: dict) -> list:
    """(name, rows [B, N], lens [B], flavor) for the kernel-vs-plain phase."""
    rng = np.random.default_rng(5)
    cases = [(f"tier {k}", v, np.full(B, N, np.int32), "zz16")
             for k, v in tier_rows.items()]
    wrap = np.tile(np.array([-32768, 32767], np.int16), (2, 32768))
    cases.append(("wrap extremes", wrap, np.full(2, wrap.shape[1], np.int32),
                  "zz16"))
    n8 = 1 << 20
    zz8 = np.stack([
        np.clip(np.cumsum(rng.normal(0, 3, n8)), -100, 100).astype(np.int8),
        rng.integers(-128, 128, n8).astype(np.int8),
        np.full(n8, -7, np.int8)])
    cases.append(("zz8", zz8, np.array([n8, n8 - 3, 4097], np.int32), "zz8"))
    ragged_lens = np.array([1, 3, 4, 5, 4095, 4097, 16383, 16385], np.int32)
    ragged = rng.integers(-32768, 32767, (ragged_lens.size, 16388),
                          dtype=np.int16)  # tails are garbage: masked by lens
    ragged[::2] = np.cumsum(rng.integers(-300, 300, (4, 16388)),
                            axis=1).astype(np.int16)
    cases.append(("ragged", ragged, ragged_lens, "zz16"))
    n = min(1 << 20, N)
    unlike = np.stack([tier_rows["pure"][0, :n], tier_rows["hard"][0, :n],
                       np.full(n, 1234, np.int16), tier_rows["mixed"][-1, :n],
                       wrap[0, :n // 16].repeat(16),
                       tier_rows["realistic"][-1, :n]])
    cases.append(("unlike rows", unlike,
                  np.array([n, n - 1, n // 2, 3, 0, n - 4093], np.int32), "zz16"))
    return cases


def check_kernels(torch, svb_w2, oracle, cases) -> dict:
    """Kernels E and D against the plain versions on the same CUDA tensors;
    returns the largest absolute difference seen per kernel (must be 0)."""
    err = {"encode": 0, "decode": 0}
    for name, rows, lens, flavor in cases:
        x = torch.from_numpy(rows).to(DEVICE)
        n = torch.from_numpy(lens).to(DEVICE)
        k1, d1, l1 = svb_w2.encode_w2_rows(x, n, flavor)
        k0, d0, l0 = svb_w2.encode_w2_rows_plain(x, n, flavor)
        written = torch.arange(d0.shape[1], device=DEVICE)[None, :] < l0[:, None]
        enc_err = max(
            int((l1 - l0).abs().max()),
            int((k1.int() - k0.int()).abs().max()),
            int((torch.where(written, d1, 0).int()
                 - torch.where(written, d0, 0).int()).abs().max()))
        o1 = svb_w2.decode_w2_rows(k1, d1, n, flavor)
        o0 = svb_w2.decode_w2_rows_plain(k1, d1, n, flavor)
        valid = torch.arange(x.shape[1], device=DEVICE)[None, :] < n[:, None]
        want = torch.where(valid, x, 0)
        dec_err = max(int((o1.int() - o0.int()).abs().max()),
                      int((o1.int() - want.int()).abs().max()))
        torch.cuda.synchronize()
        # One row against the NumPy oracle: the plain version is not the
        # only reference.
        r = int(np.argmax(lens))
        cnt = int(lens[r])
        isz = rows.itemsize
        stream = (k1[r, :(cnt + 3) // 4].cpu().numpy().tobytes()
                  + d1[r, :int(l1[r])].cpu().numpy().tobytes())
        oracle_ok = stream == oracle.svb_compress(rows[r, :cnt], isz, True, 0)
        print(f"  {name:14s} [{rows.shape[0]}, {rows.shape[1]}] {flavor}: "
              f"encode err {enc_err}, decode err {dec_err}, "
              f"row {r} vs oracle {'ok' if oracle_ok else 'DIFFERS'}")
        if enc_err or dec_err or not oracle_ok:
            raise SystemExit(f"kernel mismatch in case {name!r}")
        err["encode"] = max(err["encode"], enc_err)
        err["decode"] = max(err["decode"], dec_err)
    return err


def cuda_ms(torch, fn) -> float:
    """ms per call: CALLS calls back to back between two CUDA events, best
    of REPEATS such runs, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / CALLS)
    return best


def time_tiers(torch, svb_w2, tier_rows) -> dict:
    out = {}
    lens = torch.full((B,), N, dtype=torch.int32, device=DEVICE)
    gb = B * N * 2 / 1e9
    for name, rows in tier_rows.items():
        x = torch.from_numpy(rows).to(DEVICE)
        keys, data, _ = svb_w2.encode_w2_rows(x, lens, "zz16")
        t = {
            "enc_ms": cuda_ms(torch, lambda: svb_w2.encode_w2_rows(
                x, lens, "zz16")),
            "enc_plain_ms": cuda_ms(torch, lambda: svb_w2.encode_w2_rows_plain(
                x, lens, "zz16")),
            "dec_ms": cuda_ms(torch, lambda: svb_w2.decode_w2_rows(
                keys, data, lens, "zz16")),
            "dec_plain_ms": cuda_ms(torch, lambda: svb_w2.decode_w2_rows_plain(
                keys, data, lens, "zz16")),
        }
        for k in ("enc", "enc_plain", "dec", "dec_plain"):
            t[k + "_gb_s"] = gb / (t[k + "_ms"] / 1e3)
        out[name] = t
        print(f"  {name:9s} encode {t['enc_gb_s']:8.2f} GB/s "
              f"(plain {t['enc_plain_gb_s']:7.2f})  decode "
              f"{t['dec_gb_s']:8.2f} GB/s (plain {t['dec_plain_gb_s']:7.2f})")
    return out


def main_path(torch, port, tapi, svb_w2, reads, cd_values) -> dict:
    opts = port.CompressionOptions.from_cd_values(cd_values)
    torch.cuda.synchronize()
    svb_w2.ENCODE_LAUNCHES = 0
    svb_w2.DECODE_LAUNCHES = 0
    frames = tapi.vbz_compress_sized_batch(reads, opts)
    back = tapi.vbz_decompress_sized_batch(frames, opts)
    launches = {"encode": svb_w2.ENCODE_LAUNCHES,
                "decode": svb_w2.DECODE_LAUNCHES}
    if not (launches["encode"] > 0 and launches["decode"] > 0):
        raise SystemExit(f"main path did not launch both kernels: {launches}")
    for i, (r, f, b) in enumerate(zip(reads, frames, back)):
        if f != tapi.vbz_compress_sized(r, opts, backend=port.oracle):
            raise SystemExit(f"read {i}: frame differs from the NumPy oracle")
        if not np.array_equal(np.frombuffer(b, np.int16), r):
            raise SystemExit(f"read {i}: round trip differs")
    enc_s = dec_s = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        tapi.vbz_compress_sized_batch(reads, opts)
        t1 = time.perf_counter()
        tapi.vbz_decompress_sized_batch(frames, opts)
        t2 = time.perf_counter()
        enc_s, dec_s = min(enc_s, t1 - t0), min(dec_s, t2 - t1)
    raw = sum(r.nbytes for r in reads)
    out = {"options": list(cd_values), "reads": len(reads), "bytes": raw,
           "frame_bytes": sum(len(f) for f in frames), "launches": launches,
           "enc_s": enc_s, "dec_s": dec_s,
           "enc_gb_s": raw / enc_s / 1e9, "dec_gb_s": raw / dec_s / 1e9}
    print(f"  options {cd_values}: {len(reads)} reads, {raw} bytes -> "
          f"{out['frame_bytes']} framed; every frame equals the oracle's, "
          f"every read round-trips; launches {launches}; host to host "
          f"encode {out['enc_gb_s']:.3f} GB/s, decode {out['dec_gb_s']:.3f} "
          "GB/s (best of 3)")
    return out


def main() -> int:
    import torch

    # Phase 1: device.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    import vbz_compression_tpu_torch as port
    from vbz_compression_tpu_torch import api as tapi
    from vbz_compression_tpu_torch import signals
    from vbz_compression_tpu_torch.ops import _build, svb_w2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    os.environ.pop("VBZ_BACKEND", None)  # the main path is the CUDA default

    # Phase 2: build.
    path, seconds = _build.build()
    _build.lib()
    print(f"build: {path.relative_to(_build.BUILD_ROOT.parent.parent)} "
          f"in {seconds:.1f} s")

    # Phase 3: kernels against the plain versions.
    print("kernels against plain:")
    tier_rows = signals.tiers(B, N)
    err = check_kernels(torch, svb_w2, port.oracle, kernel_cases(tier_rows))

    # Phase 4: the main path.
    print("main path:")
    reads = signals.corpus(CORPUS_READS, READ_MIN, READ_MAX)
    runs = [main_path(torch, port, tapi, svb_w2, reads,
                      (0, 2, 1, 0))]

    # Phase 5: times.
    print(f"times on {smi}, GB/s of int16 input, best of {REPEATS}:")
    times = time_tiers(torch, svb_w2, tier_rows)
    if "jax" in sys.modules:
        raise SystemExit("jax was imported")

    head = times["realistic"]
    where = "vbz_compression_tpu/ops/"
    kernels = [
        {"name": "w2_encode", "route": "cuda",
         "source": "vbz_compression_tpu_torch/csrc/w2_codec.cu",
         "replaces": where + "pallas_codec5.py:930",
         "also_replaces": [where + "pallas_codec5.py:495",
                           where + "pallas_dense.py:311",
                           where + "pallas_codec3.py:433"],
         "launches": runs[0]["launches"]["encode"],
         "max_abs_err": err["encode"],
         "ms": head["enc_ms"], "plain_ms": head["enc_plain_ms"],
         "timed_on": f"realistic tier [{B}, {N}] int16"},
        {"name": "w2_decode", "route": "cuda",
         "source": "vbz_compression_tpu_torch/csrc/w2_codec.cu",
         "replaces": where + "pallas_codec5.py:1039",
         "also_replaces": [where + "pallas_codec5.py:841",
                           where + "pallas_dense.py:522",
                           where + "pallas_codec3.py:632"],
         "launches": runs[0]["launches"]["decode"],
         "max_abs_err": err["decode"],
         "ms": head["dec_ms"], "plain_ms": head["dec_plain_ms"],
         "timed_on": f"realistic tier [{B}, {N}] int16"},
    ]
    print(json.dumps({"tiers": times, "main_path": runs, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
