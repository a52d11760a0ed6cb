"""The port's bench: codec throughput on the card on ``bench.py``'s tiers,
as shares of a measured copy bandwidth, and the pipeline host to host.

Run from the root of a checkout with one CUDA card visible:

    python -m vbz_compression_tpu_torch.bench [--out FILE] [--trace DIR]

A port of the root ``bench.py`` (its ``tpu_codec_gbps`` and
``pipeline_gbps``):

- codec: kernels E and D (``svb_w2.encode_w2_rows`` / ``decode_w2_rows``,
  the zz16 W2 path at full width) on the four tiers ``clean``, ``mixed``,
  ``pure`` and ``hard`` as [4, 4M] int16 (``signals.TIERS``; ``clean`` and
  ``mixed`` are the bytes ``native/gen_signal`` writes for ``bench.py``).
  Every row's round trip is checked on the device. Times come from CUDA
  events: ``CALLS`` calls back to back, best of three interleaved passes
  over the tiers, each pass's number kept; and one call with the L2
  flushed, since a 32 MiB tier fits the 50 MB L2;
- roofline: kernel CP's copy bandwidth (``utils.roofline.measure_copy_gbps``)
  and the data-sheet peak, each tier's bytes per second (the bytes a call
  must move, ``utils.roofline.codec_bytes``) as a share of both;
- pipeline: ``api.vbz_compress_sized_batch`` / ``vbz_decompress_sized_batch``
  on the clean tier as 4 chunks of 8 MiB, host bytes to host bytes through
  the CUDA backend, at zstd level 1 wherever the api's zstd stage runs
  (``zstandard`` or ``libzstd.so.1`` loads, :func:`..api.zstd_route`) and
  level 0 where neither does; the line names the level and the route;
- own encoder: the same pipeline with the from-scratch zstd encoder
  (``VBZ_ZSTD_ENCODER=own``, the root ``bench.py``'s
  ``int16_signal_pipeline_own_encoder``), decoded through the api's zstd
  stage; where that stage cannot run the line is not measured, and
  ``not_measured`` says why.

Prints the card's name and power limit, then JSON lines with ``bench.py``'s
metric names: the pipeline, the own encoder's where it is measured, what is
not measured and why, and the codec headline last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from . import CompressionOptions, api, signals
from .models.codec import TorchSvbBackend
from .ops import svb_w2
from .utils import profiling, roofline

B, N = 4, 4 << 20           # 4 rows x 8 MiB of int16: bench.py's shape
TIERS = ("clean", "mixed", "pure", "hard")
CALLS = 10                  # calls back to back per timed run
PIPELINE_CHUNKS = 4         # the clean tier as 4 x 8 MiB chunks
PIPELINE_REPS = 5
OWN_REPS = 3                # the own encoder's line, as bench.py
FLUSH_BYTES = 256 << 20     # zeroed before a cold call: over 5x the L2

OWN_LINE = "int16_signal_pipeline_own_encoder"
NOT_MEASURED = {
    OWN_LINE:
        "the own encoder's level-1 frames decode through the api's zstd "
        "stage, which found neither the zstandard package nor "
        "libzstd.so.1 here",
    "vs_baseline":
        "the reference codec's bench (native/ref_bench) builds from the "
        "reference's sources, which a checkout of this repository does not "
        "hold",
}


def _hm(enc: float, dec: float) -> float:
    return 2 * enc * dec / (enc + dec)


def _require_card(device: torch.device) -> None:
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the bench measures a CUDA card; {device} is "
                           "not one, or none is visible")


def tier_rows(B: int = B, N: int = N) -> dict:
    """The bench's tiers, each [B, N] int16."""
    return {t: signals.TIERS[t](B, N) for t in TIERS}


def round_trip(x: torch.Tensor):
    """Encode ``x`` [B, N] int16 (zz16), decode it, and check every row on
    ``x``'s device (one count per row comes back). Returns (lens, keys,
    data, data_len)."""
    lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                      device=x.device)
    keys, data, data_len = svb_w2.encode_w2_rows(x, lens, "zz16")
    back = svb_w2.decode_w2_rows(keys, data, lens, "zz16")
    wrong = (back != x).sum(dim=1).tolist()
    if any(wrong):
        raise RuntimeError(f"round trip differs: values wrong per row {wrong}")
    return lens, keys, data, data_len


def measure_tiers(rows: dict, passes: int = 3, device="cuda") -> dict:
    """Encode and decode GB/s of input per tier on the card (see the module
    docstring), with each tier's bytes per call."""
    device = torch.device(device)
    _require_card(device)
    ready, out = {}, {}
    for tier, host in rows.items():
        with profiling.annotate(f"round trip {tier}"):
            x = torch.from_numpy(host).to(device)
            lens, keys, data, data_len = round_trip(x)
        enc_bytes, dec_bytes = roofline.codec_bytes(x, keys, data_len)
        ready[tier] = (x, lens, keys, data)
        out[tier] = {"input_bytes": host.nbytes, "enc_bytes": enc_bytes,
                     "dec_bytes": dec_bytes, "enc_samples": [],
                     "dec_samples": []}

    def calls_of(tier):
        x, lens, keys, data = ready[tier]
        return (lambda: svb_w2.encode_w2_rows(x, lens, "zz16"),
                lambda: svb_w2.decode_w2_rows(keys, data, lens, "zz16"))

    def gb_s(tier, ms):
        return out[tier]["input_bytes"] / (ms / 1e3) / 1e9

    # Interleaved passes, as bench.py: each pass times every tier once.
    for _ in range(passes):
        for tier in rows:
            enc, dec = calls_of(tier)
            with profiling.annotate(f"time {tier}"):
                out[tier]["enc_samples"].append(
                    gb_s(tier, profiling.warm_ms(enc, CALLS, 1)))
                out[tier]["dec_samples"].append(
                    gb_s(tier, profiling.warm_ms(dec, CALLS, 1)))
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    for tier, rec in out.items():
        enc, dec = calls_of(tier)
        with profiling.annotate(f"time {tier} cold"):
            rec["enc_cold"] = gb_s(tier, profiling.cold_ms(enc, flush))
            rec["dec_cold"] = gb_s(tier, profiling.cold_ms(dec, flush))
        rec["enc"] = max(rec["enc_samples"])
        rec["dec"] = max(rec["dec_samples"])
        rec["combined"] = _hm(rec["enc"], rec["dec"])
    return out


def roofline_shares(tiers: dict, copy_gb_s: float) -> None:
    """Add each tier's bytes per second as a percentage of the copy
    bandwidth (``pct_of_roofline_*``) and of the data-sheet peak
    (``pct_of_peak_*``)."""
    for rec in tiers.values():
        for d in ("enc", "dec"):
            moved = rec[d] * rec[f"{d}_bytes"] / rec["input_bytes"]
            rec[f"pct_of_roofline_{d}"] = 100 * moved / copy_gb_s
            rec[f"pct_of_peak_{d}"] = 100 * moved / roofline.HBM_PEAK_GB_S


def zstd_level() -> int:
    """1 where the api's zstd stage runs (``zstandard`` or
    ``libzstd.so.1`` loads), else 0 (no zstd stage)."""
    try:
        api.zstd_route()
    except OSError:
        return 0
    return 1


@contextlib.contextmanager
def encoder_env(encoder: str | None):
    """``VBZ_ZSTD_ENCODER`` set to ``encoder`` for the block (the batch
    API's threaded zstd stage reads it), and put back after; None leaves it
    as it is."""
    if encoder is None:
        yield
        return
    prev = os.environ.get("VBZ_ZSTD_ENCODER")
    os.environ["VBZ_ZSTD_ENCODER"] = encoder
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("VBZ_ZSTD_ENCODER")
        else:
            os.environ["VBZ_ZSTD_ENCODER"] = prev


def pipeline_gbps(clean: np.ndarray, backend: TorchSvbBackend,
                  level: int, encoder: str | None = None,
                  reps: int = PIPELINE_REPS) -> dict:
    """Host-to-host GB/s of the batch API on ``clean`` as PIPELINE_CHUNKS
    chunks, best of ``reps``, round trip checked; ``encoder`` (a
    ``VBZ_ZSTD_ENCODER`` value) for the zstd stage where given."""
    _require_card(torch.device(backend.device))
    chunks = list(clean.reshape(PIPELINE_CHUNKS, -1))
    total = clean.nbytes
    opts = CompressionOptions(True, 2, level, 0)
    enc_s = dec_s = float("inf")
    with encoder_env(encoder):
        frames = api.vbz_compress_sized_batch(chunks, opts, backend=backend)
        for _ in range(reps):
            t0 = time.perf_counter()
            frames = api.vbz_compress_sized_batch(chunks, opts,
                                                  backend=backend)
            enc_s = min(enc_s, time.perf_counter() - t0)
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = api.vbz_decompress_sized_batch(frames, opts, backend=backend)
        dec_s = min(dec_s, time.perf_counter() - t0)
    for c, o in zip(chunks, outs):
        if c.tobytes() != o:
            raise RuntimeError("pipeline round trip differs")
    enc, dec = total / enc_s / 1e9, total / dec_s / 1e9
    return {"enc": enc, "dec": dec, "combined": _hm(enc, dec),
            "bytes": sum(map(len, frames)), "input_bytes": total,
            "zstd_level": level,
            "zstd_route": api.zstd_route() if level else None}


def pipeline_line(pipe: dict) -> dict:
    return {"metric": "int16_signal_pipeline_encdec_throughput",
            "value": pipe["combined"], "unit": "GB/s",
            "zstd_level": pipe["zstd_level"],
            "zstd_route": pipe["zstd_route"],
            "encode_gb_s": pipe["enc"], "decode_gb_s": pipe["dec"],
            "ratio": pipe["bytes"] / pipe["input_bytes"]}


def own_line(own: dict, pipe: dict) -> dict:
    """The own encoder's pipeline line, its frames' size against the
    libzstd pipeline's (``pipe``, the same level)."""
    return {"metric": OWN_LINE, "value": own["combined"], "unit": "GB/s",
            "zstd_level": own["zstd_level"], "encoder": "own",
            "encode_gb_s": own["enc"], "decode_gb_s": own["dec"],
            "size_vs_libzstd": own["bytes"] / pipe["bytes"]}


def not_measured(level: int) -> dict:
    """What the run leaves out and why: NOT_MEASURED, less the own
    encoder's line at level 1, where the api's zstd stage decodes its
    frames."""
    return {k: v for k, v in NOT_MEASURED.items()
            if not (level and k == OWN_LINE)}


def codec_line(tiers: dict, copy_gb_s: float, device_name: str) -> dict:
    """The headline: clean's combined GB/s, the other tiers beside it, the
    per-pass samples, the cold numbers and the roofline shares."""
    clean = tiers["clean"]
    line = {"metric": "int16_signal_codec_encdec_throughput",
            "value": clean["combined"], "unit": "GB/s",
            "encode_gb_s": clean["enc"], "decode_gb_s": clean["dec"]}
    for t, rec in tiers.items():
        if t != "clean":
            line[f"{t}_gb_s"] = rec["combined"]
            line[f"{t}_encode_gb_s"] = rec["enc"]
            line[f"{t}_decode_gb_s"] = rec["dec"]
    for t, rec in tiers.items():
        line[f"{t}_enc_samples"] = rec["enc_samples"]
        line[f"{t}_dec_samples"] = rec["dec_samples"]
        line[f"{t}_encode_cold_gb_s"] = rec["enc_cold"]
        line[f"{t}_decode_cold_gb_s"] = rec["dec_cold"]
    line["hbm_copy_gb_s"] = copy_gb_s
    line["hbm_peak_gb_s"] = roofline.HBM_PEAK_GB_S
    for d in ("enc", "dec"):
        factor = clean[f"{d}_bytes"] / clean["input_bytes"]
        line[f"sol_{d}_gb_s"] = copy_gb_s / factor
    for t, rec in tiers.items():
        for d in ("enc", "dec"):
            line[f"{t}_pct_of_roofline_{d}"] = rec[f"pct_of_roofline_{d}"]
            line[f"{t}_pct_of_peak_{d}"] = rec[f"pct_of_peak_{d}"]
    line["device"] = device_name
    return line


def run(rows: dict | None = None, passes: int = 3) -> list[dict]:
    """The bench's JSON lines, headline last. ``rows``: the tiers (default
    :func:`tier_rows`)."""
    device = torch.device("cuda")
    _require_card(device)
    rows = tier_rows() if rows is None else rows
    level = zstd_level()
    lines = []
    with profiling.annotate("pipeline"):
        pipe = pipeline_gbps(rows["clean"], TorchSvbBackend(device), level)
    lines.append(pipeline_line(pipe))
    if level:
        with profiling.annotate("pipeline, own encoder"):
            own = pipeline_gbps(rows["clean"], TorchSvbBackend(device), level,
                                "own", OWN_REPS)
        lines.append(own_line(own, pipe))
    with profiling.annotate("codec tiers"):
        tiers = measure_tiers(rows, passes)
    with profiling.annotate("copy bandwidth"):
        copy_gb_s = roofline.measure_copy_gbps()
    roofline_shares(tiers, copy_gb_s)
    line = codec_line(tiers, copy_gb_s, torch.cuda.get_device_name(0))
    return [*lines, {"not_measured": not_measured(level)}, line]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--trace", metavar="DIR",
                    help="profile the run into DIR/trace.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device is visible", file=sys.stderr)
        return 1
    print(profiling.card())
    with (profiling.trace(args.trace) if args.trace
          else contextlib.nullcontext()):
        lines = run()
    text = "\n".join(json.dumps(line) for line in lines)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
