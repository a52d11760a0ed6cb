"""Run a cell's check on the program, on the control, or on the program
with a planted fault, for several seeds in one process.

    python3 benchmark/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] --mode program|control|<fault> [...]

Prints one JSON line a run: mode, seed, ``correct``, the checks with their
limits, calls and window. The benchmark's own runs never run this: it is
how the limits were read (``PERF.md``). Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--mode", nargs="+", default=["program"])
    args = parser.parse_args(argv)

    import contextlib

    import torch

    from benchmark.harness import cell as cell_mod, controls, faults, runner

    if not torch.cuda.is_available():
        print("no CUDA card visible", file=sys.stderr)
        return 2
    device = "cuda"
    for mode in args.mode:
        for seed in args.seeds:
            program, planted = None, contextlib.nullcontext()
            c = cell_mod.Cell.load(args.workload, seed, device)
            entry = c.traffic["entry"]
            if mode == "control":
                program = controls.for_entry(entry, c)
            elif mode in faults.FAULTS:
                planted = faults.planted(mode, entry)
            elif mode != "program":
                raise SystemExit(f"unknown mode {mode!r}")
            t0 = time.perf_counter()
            with planted:
                out = runner.run(args.workload, seed, args.seconds, False,
                                 device, program=program)
            print(json.dumps({
                "mode": mode, "seed": seed, "correct": out["correct"],
                "checks": out["checks"], "calls": out["calls"],
                "failed": out["failed"], "metrics": out["metrics"],
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
