"""Check that the program's host spans and the device trace share a clock:
each ``Memcpy HtoD`` and ``Memcpy DtoH`` op of the trace should lie inside
a ``backend.h2d``, ``backend.d2h`` or ``backend.wait`` span of the program,
once the spans are moved onto the trace's clock with the one offset that
``harness/devtrace.py`` reads.

    python3 benchmark/clock_check.py --workload <name> --seed <n> \\
        --seconds <s> [--slack-us 20]

Runs the cell's calls for ``--seconds`` under the device trace with the
program's recorder on, and prints one JSON line a copy direction: the ops,
their device seconds, the share of those seconds in ops that lie in a span
to within the slack, the largest and the 99th-percentile distance (us) by
which an op leaves its nearest span, and the device seconds of the ops
that leave it by more, by the innermost program span (own time) their
start falls in. Where the direction's ops and its spans (``backend.h2d``
or ``backend.d2h``) are as many, each op is paired with its span in order,
and the line gives the misalignment: the quantiles of the op's start less
its span's start (us, trace clock), and their drift over the window (us a
second, least squares). ``wall_less_perf_drift_us`` is how far the wall
clock moved against ``time.perf_counter_ns`` over the window: the trace's
clock is the wall clock, and the offset is read once. The benchmark's own
runs never run this. Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

COPY_SPANS = ("backend.h2d", "backend.d2h", "backend.wait")
DIRECTIONS = {"Memcpy HtoD": "backend.h2d", "Memcpy DtoH": "backend.d2h"}


def offsets(ops, spans, slack_us: float) -> list:
    """For each op ``(name, start, end)`` (us), the distance (us) by which
    it leaves the nearest of ``spans`` (sorted ``(start, end)`` pairs, us),
    0 inside one."""
    starts = [s for s, _ in spans]
    out = []
    for _, a, b in ops:
        i = bisect.bisect_right(starts, a + slack_us)
        best = float("inf")
        for s, e in spans[max(i - 2, 0):i + 1]:
            best = min(best, max(s - a, b - e, 0.0))
        out.append(best)
    return out


def summary(ops, spans, pieces, slack_us: float) -> dict:
    """The numbers of one direction; ``pieces`` are the program's own-time
    ``(name, start, end)`` pieces (us), sorted by start."""
    off = offsets(ops, spans, slack_us)
    total = sum(b - a for _, a, b in ops)
    inside = sum(b - a for (_, a, b), o in zip(ops, off) if o <= slack_us)
    outside: dict[str, float] = {}
    starts = [p[1] for p in pieces]
    for (_, a, b), o in zip(ops, off):
        if o <= slack_us:
            continue
        j = bisect.bisect_right(starts, a) - 1
        name = pieces[j][0] if j >= 0 and pieces[j][2] > a else "no span"
        outside[name] = outside.get(name, 0.0) + (b - a) / 1e6
    ranked = sorted(off)
    return {
        "ops": len(ops), "device_s": total / 1e6,
        "in_span_pct": 100.0 * inside / total if total else None,
        "largest_offset_us": ranked[-1] if ranked else None,
        "p99_offset_us": ranked[int(0.99 * (len(ranked) - 1))]
        if ranked else None,
        "outside_s_by_span": outside}


def misalignment(ops, spans) -> dict:
    """Each op paired in order with its span (as many of each, sorted by
    start, us): quantiles of op start less span start, the drift of that
    difference over time (us/s), and the spans' median length (us)."""
    if not ops or len(ops) != len(spans):
        return {"paired": False, "ops": len(ops), "spans": len(spans)}
    t = [s for s, _ in spans]
    d = [op[1] - s for op, s in zip(ops, t)]
    q = sorted(d)
    n = len(q)
    mt, md = sum(t) / n, sum(d) / n
    var = sum((x - mt) ** 2 for x in t)
    drift = sum((x - mt) * (y - md) for x, y in zip(t, d)) / var * 1e6 \
        if var else 0.0
    lengths = sorted(e - s for s, e in spans)
    return {"paired": True,
            "start_less_span_start_us": {
                "p1": q[n // 100], "p50": q[n // 2], "p99": q[99 * n // 100],
                "min": q[0], "max": q[-1]},
            "drift_us_per_s": drift, "span_p50_us": lengths[n // 2]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--slack-us", type=float, default=20.0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card visible", file=sys.stderr)
        return 2
    from benchmark.harness import cell as cell_mod, devtrace, program, runner
    from benchmark.harness import spans as spans_mod

    cell = cell_mod.Cell.load(args.workload, args.seed, "cuda")
    entry = cell_mod.load_module(
        cell_mod.BENCH / "entries" / f"{cell.traffic['entry']}.py").Entry(
            cell)
    entry.warm_up()
    torch.cuda.synchronize()
    recorder = devtrace.Recorder()
    calls = 0
    with recorder.window():
        wall_at_lo = time.time_ns() - time.perf_counter_ns()
        lo = time.perf_counter_ns()
        while calls == 0 or time.perf_counter_ns() - lo < args.seconds * 1e9:
            entry.call(calls, cell.batch(calls))
            calls += 1
        entry.drain()
        hi = time.perf_counter_ns()
        wall_at_hi = time.time_ns() - time.perf_counter_ns()
    trace = recorder.trace
    run = runner.Run(lo_ns=lo, hi_ns=hi, raw_bytes=0, counts={},
                     calls=calls, spans=spans_mod.Spans(), trace=trace)
    records = program.window(run) or []
    spans = sorted((trace.to_us(r.start), trace.to_us(r.end))
                   for r in records if r.name in COPY_SPANS)
    pieces = sorted(((name, trace.to_us(a), trace.to_us(b))
                     for name, a, b, _ in run.spans.records),
                    key=lambda p: p[1])
    lo_us, hi_us = run.trace_window_us
    for direction, label in DIRECTIONS.items():
        every = [op for op in trace.ops if op[0].startswith(direction)]
        ops = [op for op in every if lo_us <= op[1] < hi_us]
        own = sorted((trace.to_us(r.start), trace.to_us(r.end))
                     for r in records if r.name == label)
        print(json.dumps({"workload": args.workload, "seed": args.seed,
                          "direction": direction, "calls": calls,
                          "slack_us": args.slack_us,
                          "wall_less_perf_drift_us":
                              (wall_at_hi - wall_at_lo) / 1e3,
                          **summary(ops, spans, pieces, args.slack_us),
                          "misalignment": misalignment(every, own)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
