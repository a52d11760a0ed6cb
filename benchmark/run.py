"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds the program
(``vbz_compression_tpu_torch``). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number the check compared, with its limit. The checks also end standard
error, one a line. Without a CUDA card the run fails and prints no result;
so does a run that has loaded JAX or the JAX package by the time its
window has closed.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# Top-level module names the measured process may not hold: the port is
# measured alone.
FORBIDDEN = {"flax", "jax", "jaxlib", "vbz_compression_tpu"}


def forbidden_loaded(modules) -> list[str]:
    """The names of ``FORBIDDEN`` that are the top-level name (compared
    whole) of one of ``modules``."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    imported = time.perf_counter()
    from benchmark.harness import runner

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA card(s); "
              "the benchmark measures the card and does not fall back to "
              "the CPU", file=sys.stderr)
        return 2
    result = runner.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", started=STARTED,
                        imported=imported)
    loaded = forbidden_loaded(list(sys.modules))
    if loaded:
        print(f"the run loaded {', '.join(loaded)}; the benchmark measures "
              "the port alone", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
