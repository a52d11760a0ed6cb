"""What the card can do for the codec: the port's capability probe.

Run from the root of a checkout with one CUDA card visible:

    python -m vbz_compression_tpu_torch.tools.capability_probe [--out FILE]

One probe in place of the JAX package's seven TPU tools:

1. device operations (``tools/tpu_capability_probe.py:38-98``), timed with
   CUDA events: elementwise add (8 MiB int16), fma (32 MiB float32), a bf16
   2048^3 matmul, gathers of 8M indices from 64 KB and 16 MB tables, a
   monotone gather, cumsum at int32, uint16 and float32, and a sum; where
   PyTorch has no kernel for a dtype the line says so;
2. the Mosaic probes (``tools/probe_{dynroll,i8dma,keypack,widen,i16roll}.py``):
   each kernel of :mod:`..ops.probes` against its plain version on the
   probes' own inputs (and the prefix sum also on 4M values), OK or WRONG
   per case, with the kernel's time (GB/s
   for the widening fetches, us per stage for the butterfly);
3. kernel CP's copy bandwidth at 512-, 2048- and 8192-row tiles
   (``tools/probe_copybw.py``), beside ``dst.copy_(src)``'s on the same
   array;
4. kernel M (``ops/zstd_match.py``) at both widths, the int32 offsets of
   ``match_candidates`` and the uint8 index of ``match_index``, against
   their plain versions on every case of ``signals.match_cases``, OK or
   WRONG per case and width, timed on the JAX match tests' payload;
5. the versions (PyTorch, CUDA, nvcc, Triton) and the card's SM count and
   shared memory per block.

Prints the card's name and power limit first and one JSON object last;
exits 1 if any case is WRONG.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.metadata
import importlib.util
import json
import subprocess
import sys
from typing import Callable

import numpy as np
import torch

from .. import signals
from ..ops import probes, zstd_match
from ..utils import profiling, roofline

LANES = 128
I8_OFFSETS = (4096, 8192, 4097, 8195)   # the TPU's aligned ones, then not
SHIFTS = (0, 1, 127, 128, 129, 1023)
WIDEN_BLOCK, WIDEN_BLOCKS = 32768, 128  # probe_widen.py: 128 x 32768 values
WIDEN_SLACK = 8192                      # FW - BLOCK: data past the last block
BUTTERFLY_ROWS = 528                    # probe_i16roll.py's R
PSUM_ROWS = 32768                       # the large prefix sum: 4M int32
COPY_MIB = 256


@dataclasses.dataclass
class Case:
    """One probe case: the kernel's call, its plain version's and, where one
    PyTorch call computes the same function, that call."""

    name: str
    key: str                        # the probes.LAUNCHES entry it counts in
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    library: Callable[[], torch.Tensor] | None
    nbytes: int                     # input read once, output written once
    timed_as: str | None = None     # its own entry in a table of times


def cases(device) -> list[Case]:
    """Every probe case on ``device``, on the TPU probes' inputs."""
    rng = np.random.default_rng(0)
    out = []

    def on(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # dynroll: [16, 128] arange, rolls by 5, flat shifts, a [256, 128] psum.
    x = on(np.arange(16 * LANES, dtype=np.int32).reshape(16, LANES))
    nx = 2 * x.numel() * 4
    out.append(Case("dyn lane roll 5", "roll_lanes",
                    lambda: probes.roll_lanes(x, 5),
                    lambda: probes.roll_plain(x, 0, 5),
                    lambda: torch.roll(x, 5, 1), nx))
    out.append(Case("dyn sublane roll 5", "roll_rows",
                    lambda: probes.roll_rows(x, 5),
                    lambda: probes.roll_plain(x, 5, 0),
                    lambda: torch.roll(x, 5, 0), nx))
    for a in SHIFTS:
        out.append(Case(f"flat dyn shift {a}", "flat_shift_right",
                        lambda a=a: probes.flat_shift_right(x, a),
                        lambda a=a: probes.flat_shift_right_plain(x, a),
                        None, nx))
    # The probe's [256, 128], and 4M values: many tiles' look-back.
    for rows, timed_as in ((256, None), (PSUM_ROWS, "prefix_sum_4m")):
        bits = on(rng.integers(0, 2, (rows, LANES), dtype=np.int32))
        out.append(Case(f"prefix sum [{rows}, 128]", "prefix_sum",
                        lambda b=bits: probes.prefix_sum(b),
                        lambda b=bits: probes.prefix_sum_plain(b),
                        lambda b=bits: torch.cumsum(b.view(-1), 0,
                                                    dtype=torch.int32),
                        2 * bits.numel() * 4, timed_as))

    # i8dma: [64, 128] int32 stored as bytes into 64 KiB and read back.
    vals = on(rng.integers(-120, 120, (64, LANES), dtype=np.int32))
    data = on(rng.integers(-128, 128, 65536, dtype=np.int8))
    n = vals.numel()
    for off in I8_OFFSETS:
        buf_k = torch.zeros(65536, dtype=torch.int8, device=device)
        buf_p, buf_l = buf_k.clone(), buf_k.clone()
        out.append(Case(
            f"i8 write at {off}", "store_bytes",
            lambda off=off, b=buf_k: probes.store_bytes(vals, b, off),
            lambda off=off, b=buf_p: probes.store_bytes_plain(vals, b, off),
            lambda off=off, b=buf_l: b[off:off + n].copy_(vals.view(-1)),
            5 * n))
    for off in I8_OFFSETS:
        out.append(Case(
            f"i8 read at {off}", "load_bytes",
            lambda off=off: probes.load_bytes(data, off, (64, LANES)),
            lambda off=off: probes.load_bytes_plain(data, off, (64, LANES)),
            lambda off=off: torch.empty(64, LANES, dtype=torch.int32,
                                        device=device).copy_(
                data[off:off + n].view(64, LANES)),
            5 * n))

    # keypack: [256, 128] codes <-> [64, 128] key bytes.
    codes = on(rng.integers(0, 2, (256, LANES), dtype=np.int32))
    keys = on(rng.integers(0, 256, (64, LANES), dtype=np.uint8))
    out.append(Case("pack", "pack_keys", lambda: probes.pack_keys(codes),
                    lambda: probes.pack_keys_plain(codes), None,
                    codes.numel() * 4 + codes.numel() // 4))
    out.append(Case("unpack", "unpack_keys",
                    lambda: probes.unpack_keys(keys),
                    lambda: probes.unpack_keys_plain(keys), None,
                    keys.numel() * 17))

    # widen: 128 windows of 32768 values, int32 and int8.
    nw = WIDEN_BLOCK * WIDEN_BLOCKS
    d32 = on(rng.integers(0, 256, nw + WIDEN_SLACK, dtype=np.int32))
    d8 = on(rng.integers(-128, 128, nw + WIDEN_SLACK, dtype=np.int8))
    out.append(Case("i32 fetch", "fetch_i32", lambda: probes.fetch_i32(d32, nw),
                    lambda: probes.fetch_i32_plain(d32, nw),
                    lambda: torch.empty(nw // LANES, LANES, dtype=torch.int32,
                                        device=device).copy_(
                        d32[:nw].view(-1, LANES)),
                    8 * nw))
    out.append(Case("i8 fetch + widen", "fetch_i8_widen",
                    lambda: probes.fetch_i8_widen(d8, nw),
                    lambda: probes.fetch_i8_widen_plain(d8, nw),
                    lambda: torch.empty(nw // LANES, LANES, dtype=torch.int32,
                                        device=device).copy_(
                        d8[:nw].view(torch.uint8).view(-1, LANES)),
                    5 * nw))

    # i16roll: tokens (occupancy bit, displacement bits 1..10) of a sorted
    # draw, through the ten-stage butterfly at both widths.
    draw = np.sort(np.random.default_rng(0).integers(
        0, 600, BUTTERFLY_ROWS * LANES)).reshape(BUTTERFLY_ROWS, LANES)
    for dt, key in ((np.int16, "butterfly_i16"), (np.int32, "butterfly_i32")):
        t = on(((draw << 1) | 1).astype(dt))
        out.append(Case(f"butterfly {np.dtype(dt).name}", key,
                        lambda t=t: probes.butterfly(t),
                        lambda t=t: probes.butterfly_plain(t), None,
                        2 * t.numel() * t.element_size()))
    return out


def match_scan(device) -> list[dict]:
    """Kernel M at both widths against its plain versions on every case of
    ``signals.match_cases``: one record per case and width, timed on the
    first case (the JAX match tests' payload)."""
    from ..ops import _build

    lib = _build.lib("match")
    out = []
    for k, (name, buf, offsets) in enumerate(signals.match_cases(
            lib.vbz_match_tile(), lib.vbz_match_halo())):
        offsets = zstd_match.DEFAULT_OFFSETS if offsets is None else offsets
        x = torch.from_numpy(buf.copy()).to(device)
        for kernel, fn, plain in (
                ("match_scan", zstd_match.match_candidates,
                 zstd_match.match_candidates_plain),
                ("match_index", zstd_match.match_index,
                 zstd_match.match_index_plain)):
            err = max_abs_err(fn(x, offsets), plain(x, offsets))
            rec = {"case": f"{kernel} {name} [{buf.size}]", "kernel": kernel,
                   "ok": err == 0, "max_abs_err": err}
            if k == 0:
                rec["ms"] = profiling.warm_ms(lambda: fn(x, offsets))
            out.append(rec)
    return out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    if not a.numel():
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def device_ops(device) -> list[dict]:
    """The TPU capability probe's operations, device ms per call."""
    rng = np.random.default_rng(0)
    res = []

    def on(a):
        return torch.from_numpy(a).to(device)

    def add(op, fn, amount, unit):
        ms = profiling.warm_ms(fn)
        res.append({"op": op, "ms": ms, unit: amount / (ms / 1e3) / 1e9})

    x16 = on(rng.integers(-3000, 3000, 4 << 20, dtype=np.int16))
    add("elementwise add 8 MiB int16", lambda: x16 + 1, 2 * x16.nbytes,
        "gb_s")
    y = on(rng.normal(size=8 << 20).astype(np.float32))
    two = torch.tensor(2.0, device=device)
    add("elementwise fma 32 MiB f32", lambda: torch.add(two, y, alpha=1.5),
        2 * y.nbytes, "gb_s")
    a = on(rng.normal(size=(2048, 2048)).astype(np.float32)).bfloat16()
    b = on(rng.normal(size=(2048, 2048)).astype(np.float32)).bfloat16()
    res_mm = profiling.warm_ms(lambda: a @ b)
    res.append({"op": "matmul 2048^3 bf16", "ms": res_mm,
                "tflop_s": 2 * 2048 ** 3 / (res_mm / 1e3) / 1e12})
    for tab_n, tag in ((16384, "64 KB"), (4 << 20, "16 MB")):
        tab = on(rng.integers(0, 1000, tab_n, dtype=np.int32))
        idx = on(rng.integers(0, tab_n, 8 << 20, dtype=np.int64))
        add(f"gather 8M from {tag}", lambda t=tab, i=idx: t[i], 8 << 20,
            "g_per_s")
    tab = on(rng.integers(0, 1000, 4 << 20, dtype=np.int32))
    mono = on(np.minimum(np.arange(8 << 20) // 2, (4 << 20) - 1))
    add("monotone gather 8M from 16 MB", lambda: tab[mono], 8 << 20,
        "g_per_s")
    for dt, tag in ((np.int32, "i32"), (np.uint16, "u16"),
                    (np.float32, "f32")):
        z = on(rng.integers(0, 3, 4 << 20).astype(dt))
        op = f"cumsum 4M {tag}"
        try:
            torch.cumsum(z, 0, dtype=z.dtype)
        except (RuntimeError, NotImplementedError) as exc:
            res.append({"op": op, "ms": None,
                        "unsupported": f"torch {torch.__version__}: "
                                       f"{str(exc).splitlines()[0]}"})
            continue
        add(op, lambda z=z: torch.cumsum(z, 0, dtype=z.dtype), z.nbytes * 2,
            "gb_s")
    add("sum 32 MiB f32", lambda: y.sum(), y.nbytes, "gb_s")
    return res


def library_copy_gbps(mib: int = COPY_MIB) -> float:
    """GB/s (read and write) of ``dst.copy_(src)`` on a ``mib`` MiB int32
    array, timed as :func:`..utils.roofline.measure_copy_gbps` times CP."""
    src = torch.arange(mib * (1 << 20) // 4, dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)
    ms = profiling.warm_ms(lambda: dst.copy_(src),
                           roofline.COPY_LAUNCHES_TIMED, roofline.COPY_REPEATS)
    return 2 * src.nbytes / (ms / 1e3) / 1e9


def versions() -> dict:
    from ..ops import _build

    props = torch.cuda.get_device_properties(0)
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    triton = (importlib.metadata.version("triton")
              if importlib.util.find_spec("triton") else "not installed")
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc.strip().splitlines()[-1], "triton": triton,
            "device": torch.cuda.get_device_name(0),
            "sm_count": props.multi_processor_count,
            "shared_memory_per_block": getattr(
                props, "shared_memory_per_block", "not reported"),
            "shared_memory_per_block_optin": getattr(
                props, "shared_memory_per_block_optin", "not reported")}


def run(device="cuda") -> dict:
    """Every measurement and case of the probe on the card (see the module
    docstring); raises without one."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the capability probe measures a CUDA card, "
                           f"not {device}")
    result = {"device_ops": device_ops(device), "probes": []}
    butterflies = {}
    for case in cases(device):
        got = case.kernel()
        err = max_abs_err(got, case.plain())
        ms = profiling.warm_ms(case.kernel)
        rec = {"case": case.name, "kernel": case.key, "ok": err == 0,
               "max_abs_err": err, "ms": ms,
               "gb_s": case.nbytes / (ms / 1e3) / 1e9}
        if case.key.startswith("butterfly"):
            rec["us_per_stage"] = ms * 1e3 / probes.BUTTERFLY_STAGES
            butterflies[case.key] = got.to(torch.int32)
        result["probes"].append(rec)
    # probe_i16roll.py's question: does int16 give int32's result?
    result["butterfly_widths_match"] = torch.equal(
        butterflies["butterfly_i16"], butterflies["butterfly_i32"])
    result["match"] = match_scan(device)
    result["copy_gb_s"] = {rows: roofline.measure_copy_gbps(COPY_MIB, rows)
                           for rows in roofline.COPY_ROWS}
    result["copy_library_gb_s"] = library_copy_gbps()
    result["versions"] = versions()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("capability_probe: no CUDA device is visible", file=sys.stderr)
        return 1
    print(profiling.card())
    result = run()
    for r in result["device_ops"]:
        rate = {k: v for k, v in r.items() if k not in ("op", "ms")}
        print(f"{r['op']}: "
              + (f"{r['ms']:.4f} ms {rate}" if r["ms"] is not None
                 else f"not supported ({r['unsupported']})"))
    for r in result["probes"]:
        extra = (f", {r['us_per_stage']:.2f} us/stage"
                 if "us_per_stage" in r else "")
        print(f"{r['case']}: {'OK' if r['ok'] else 'WRONG'} "
              f"({r['ms']:.4f} ms, {r['gb_s']:.1f} GB/s moved{extra})")
    print("butterfly int16 result equals int32's: "
          f"{'OK' if result['butterfly_widths_match'] else 'WRONG'}")
    for r in result["match"]:
        extra = f" ({r['ms']:.4f} ms)" if "ms" in r else ""
        print(f"{r['case']}: {'OK' if r['ok'] else 'WRONG'}{extra}")
    for rows, gb_s in result["copy_gb_s"].items():
        print(f"copy {COPY_MIB} MiB, tiles of ({rows}, 128) int32: "
              f"{gb_s:.1f} GB/s read + write")
    print(f"copy {COPY_MIB} MiB, dst.copy_(src): "
          f"{result['copy_library_gb_s']:.1f} GB/s read + write")
    print(json.dumps(result["versions"]))
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if ok(result) else 1


def ok(result: dict) -> bool:
    """Every case of a :func:`run` result OK."""
    return (all(r["ok"] for r in result["probes"] + result["match"])
            and result["butterfly_widths_match"])


if __name__ == "__main__":
    raise SystemExit(main())
