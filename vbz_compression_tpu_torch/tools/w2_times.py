"""Kernels E and D (W2) timed on every W2 input, for comparing two trees.

Run with one CUDA card visible, from the root of a checkout:

    python -m vbz_compression_tpu_torch.tools.w2_times [--out FILE]

The script calls only what every version of the port has (``svb_w2``'s
wrappers, ``signals``, the timers of ``utils.profiling`` and the byte count
of ``utils.roofline``). Run by path, it imports the package that
``PYTHONPATH`` names, so from the root of another checkout
``PYTHONPATH=. python /path/to/w2_times.py`` times that checkout's kernels on
the same inputs; to compare two trees, run them in turns (A, B, B, A) on one
card, one after the other. ``chip_smoke.py`` phase 5 times the same inputs
but only with its own checkout's kernels, and a checkout from before the
one-pass E and D has no zz8 input there.

Inputs, made from seeds with numpy: the four bench tiers and realistic at
[4, 4M] int16 (zz16), four int8 walks [4, 4M] (zz8), and realistic at
[64, 8192] (short chunks). For each input and direction: one call with the
L2 flushed and ten back to back, each the best of three (``profiling``'s
``cold_ms`` and ``warm_ms``), and the bound (the bytes the call must move at
the data sheet's 3.35 TB/s). Prints the card's name and power limit, then
one JSON object.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vbz_compression_tpu_torch import signals
from vbz_compression_tpu_torch.ops import svb_w2
from vbz_compression_tpu_torch.utils import profiling, roofline

B, N = 4, 4 << 20
FLUSH_BYTES = 256 << 20


def inputs() -> dict:
    """label -> (flavor, [B, N] rows)."""
    out = {f"zz16 {k} [{B}, {N}]": ("zz16", v)
           for k, v in signals.tiers(B, N).items()}
    walk8 = np.stack([signals.int8_walk(np.random.default_rng(b), N)
                      for b in range(B)])
    out[f"zz8 int8 walk [{B}, {N}]"] = ("zz8", walk8)
    out["zz16 realistic [64, 8192]"] = ("zz16",
                                        signals.TIERS["realistic"](64, 8192))
    return out


def time_input(flavor: str, rows: np.ndarray, flush) -> dict:
    x = torch.from_numpy(rows).cuda()
    lens = torch.full((rows.shape[0],), rows.shape[1], dtype=torch.int32,
                      device=x.device)
    keys, data, data_len = svb_w2.encode_w2_rows(x, lens, flavor)
    if not torch.equal(svb_w2.decode_w2_rows(keys, data, lens, flavor), x):
        raise SystemExit(f"{flavor} {tuple(rows.shape)}: round trip differs")
    enc_bytes, dec_bytes = roofline.codec_bytes(x, keys, data_len)

    def enc():
        svb_w2.encode_w2_rows(x, lens, flavor)

    def dec():
        svb_w2.decode_w2_rows(keys, data, lens, flavor)

    out = {}
    for name, fn, nbytes in (("enc", enc, enc_bytes), ("dec", dec, dec_bytes)):
        out[name + "_ms"] = profiling.cold_ms(fn, flush)
        out[name + "_warm_ms"] = profiling.warm_ms(fn)
        out[name + "_bound_ms"] = roofline.bound_ms(nbytes)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("w2_times: no CUDA device is visible")
    smi = profiling.card()
    print(smi)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    times = {}
    for label, (flavor, rows) in inputs().items():
        times[label] = t = time_input(flavor, rows, flush)
        print(f"  {label:28s} E {t['enc_ms']:.4f} ms cold, "
              f"{t['enc_warm_ms']:.4f} warm, bound {t['enc_bound_ms']:.4f}; "
              f"D {t['dec_ms']:.4f} cold, {t['dec_warm_ms']:.4f} warm, "
              f"bound {t['dec_bound_ms']:.4f}")
    text = json.dumps({"card": smi, "times": times})
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
