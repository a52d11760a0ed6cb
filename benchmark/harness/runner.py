"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result's line.

The window is whole calls: from the first call's start to the end of the
last, which for an entry that leaves work on the device is a synchronize.
No call starts once ``seconds`` have passed. Rates are all the bytes of the
window's calls over all of its time. With ``trace`` the window also runs
under the device trace and the metrics' host spans, and the run reports
the per-layer metrics instead of the end-to-end ones; a traffic mix whose
calls are short may bound that window by its number of calls
(``traced_calls``), so that the trace stays small enough to read back.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback

import torch

from . import cell as cell_mod
from . import devtrace, spans as spans_mod


@dataclasses.dataclass
class Call:
    """What one call of an entry did: the raw int16 bytes it handed back
    or took in, and counts for the metrics (such as a kernel's bytes)."""

    raw_bytes: int
    counts: dict


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    lo_ns: int
    hi_ns: int
    raw_bytes: int
    counts: dict
    calls: int
    spans: spans_mod.Spans | None
    trace: devtrace.DeviceTrace | None
    call_ns: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.hi_ns - self.lo_ns) / 1e9

    @property
    def trace_window_us(self) -> tuple[float, float]:
        return self.trace.to_us(self.lo_ns), self.trace.to_us(self.hi_ns)

    def rate_gb_s(self) -> float | None:
        """Raw bytes of all the window's calls over all its time (GB/s)."""
        return self.raw_bytes / self.window_s / 1e9 if self.calls else None

    def idle_pct(self) -> float | None:
        """Share (%) of the window with nothing running on the device."""
        busy = self.busy_s()
        if busy is None:
            return None
        return 100.0 * max(self.window_s - busy, 0.0) / self.window_s

    def span_pct(self, label: str) -> float | None:
        if self.spans is None:
            return None
        share = self.spans.share(label, self.lo_ns, self.hi_ns)
        return None if share is None else 100.0 * share

    def busy_s(self) -> float | None:
        if self.trace is None or not self.trace.ops:
            return None
        return self.trace.busy_s(*self.trace_window_us)


def _pace(lo: int, hi: int, ends: list, call_ns: list) -> dict:
    """How steady the window ran: each quarter's rate of raw bytes (GB/s)
    and the quartiles of the calls' host times (ms, enqueue only where the
    entry leaves work on the device)."""
    if len(call_ns) < 4:
        return {}
    quarters, at, done = [], lo, 0
    for q in range(1, 5):
        edge = lo + (hi - lo) * q // 4
        inside = [r for t, r in ends if t <= edge]
        upto = inside[-1] if inside else done
        quarters.append((upto - done) / max(edge - at, 1))
        at, done = edge, upto
    return {"quarter_gb_s": quarters,
            "call_ms_quartiles": [x / 1e6 for x in
                                  statistics.quantiles(call_ns, n=4)]}


def _lap(t: float) -> tuple[float, float]:
    now = time.perf_counter()
    return now - t, now


def metric_specs(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false; ``setup_s`` apart)
    or its per-layer ones."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if m["name"] != "setup_s"
            and workload in m.get("workloads", [workload])]


def _overlap(intervals: list, starts: list, a: float, b: float) -> float:
    """Length of [a, b] that sorted disjoint ``intervals`` cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(intervals) and intervals[i][0] < b:
        total += max(0.0, min(b, intervals[i][1]) - max(a, intervals[i][0]))
        i += 1
    return total


def _gaps(run: Run) -> list:
    """Idle seconds of the window under each host span's label (spans of
    two labels may overlap) and under none ("no span"); the most idle
    first."""
    if run.trace is None:
        return []
    lo_us, hi_us = run.trace_window_us
    labels = sorted({r[0] for r in run.spans.records}) if run.spans else []
    unions = {}
    for name in labels:
        union = [(run.trace.to_us(a), run.trace.to_us(b)) for a, b in
                 run.spans.intervals(name, run.lo_ns, run.hi_ns)]
        unions[name] = (union, [u[0] for u in union])
    merged: list = []
    for a, b in sorted(iv for union, _ in unions.values() for iv in union):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    any_span = (merged, [m[0] for m in merged])
    idle = {name: 0.0 for name in [*labels, "no span"]}
    for a, b in run.trace.gaps(lo_us, hi_us):
        for name, (union, starts) in unions.items():
            idle[name] += _overlap(union, starts, a, b)
        idle["no span"] += b - a - _overlap(*any_span, a, b)
    return sorted(([k, v / 1e6] for k, v in idle.items() if v > 0),
                  key=lambda e: -e[1])[:10]


def card_info() -> dict:
    """Name, count and power limit of the card the run uses."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def run(workload: str, seed: int, seconds: float, trace: bool, device, *,
        started: float | None = None, imported: float | None = None,
        program=None,
        config_override: dict | None = None,
        traffic_override: dict | None = None) -> dict:
    """Run ``workload`` once; returns the result's line as a dict.
    ``program`` replaces the program's entry call (the control);
    ``started`` is when the process started and ``imported`` when it had
    imported torch, for ``setup_s`` and its parts."""
    started = time.perf_counter() if started is None else started
    bench = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
    cell = cell_mod.Cell.load(workload, seed, device,
                              config_override=config_override,
                              traffic_override=traffic_override)
    on_card = cell.device.type == "cuda"
    specs = metric_specs(bench, workload, trace)
    readers = {m["name"]: cell_mod.load_module(
        cell_mod.reader_path(m["name"])) for m in specs}
    targets = {}
    for reader in readers.values():
        targets.update(getattr(reader, "SPANS", {}))
    entry_mod = cell_mod.load_module(
        cell_mod.BENCH / "entries" / f"{cell.traffic['entry']}.py")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    parts = {"import_s": (imported or started) - started}
    t = time.perf_counter()
    torch.zeros(1, device=cell.device)
    sync()
    parts["card_s"], t = _lap(t)
    cell.reads
    sync()
    parts["read_set_s"], t = _lap(t)
    entry = entry_mod.Entry(cell, program=program)
    # The calls' reads repeat after ``period`` calls: made here, not in the
    # window.
    batches = [cell.batch(k) for k in range(cell.period)]
    sync()
    parts["inputs_s"], t = _lap(t)
    if on_card:
        # The peak is the program's (with the inputs it is handed), not the
        # reference's that made them.
        torch.cuda.reset_peak_memory_stats()
    entry.warm_up()
    sync()
    parts["warm_up_s"], t = _lap(t)
    setup_s = t - started

    spans = spans_mod.Spans() if trace else None
    recorder = devtrace.Recorder()
    attempted = failed = raw = calls = 0
    counts: dict = {}
    ends: list = []    # (end of each completed call, raw bytes so far)
    call_ns: list = []
    first_error = None
    last = cell.traffic.get("traced_calls") if trace else None
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(spans_mod.installed(spans, targets))
            if on_card:
                stack.enter_context(recorder.window())
        lo = time.perf_counter_ns()
        k = 0
        while k == 0 or (k != last and
                         time.perf_counter_ns() - lo < seconds * 1e9):
            idx = batches[k % len(batches)]
            attempted += len(idx)
            t_call = time.perf_counter_ns()
            try:
                call = entry.call(k, idx)
            except Exception:  # a failed call counts; the window goes on
                failed += len(idx)
                first_error = first_error or traceback.format_exc()
            else:
                raw += call.raw_bytes
                calls += 1
                for key, value in call.counts.items():
                    counts[key] = counts.get(key, 0) + value
                ends.append((time.perf_counter_ns(), raw))
                call_ns.append(ends[-1][0] - t_call)
            k += 1
        entry.drain()
        hi = time.perf_counter_ns()
    if first_error:
        print(first_error, file=sys.stderr)

    device_info = card_info() if on_card else {
        "platform": "cpu", "kind": "cpu", "count": 0}
    device_info["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated() if on_card else 0)
    result = Run(lo_ns=lo, hi_ns=hi, raw_bytes=raw, counts=counts,
                 calls=calls, spans=spans, trace=recorder.trace,
                 call_ns=call_ns)
    metrics = {}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    for m in specs:
        value = readers[m["name"]].read(result)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info}
    if trace:
        busy = result.busy_s()
        device_info["busy_s"] = busy if busy is not None else 0.0
        device_info["window_s"] = result.window_s
        if result.trace is not None:
            out["breakdown"] = {
                "device_ops": result.trace.by_name(),
                "idle_gaps": _gaps(result)}
    out["calls"] = calls
    out["window_s"] = result.window_s
    out["setup_parts"] = parts
    out["pace"] = _pace(lo, hi, ends, call_ns)

    del recorder, result
    checks = entry.check()
    correct = failed == 0 and calls > 0 and all(
        v <= limit for v, limit in checks.values())
    out["correct"] = correct
    out["checks"] = {name: {"value": v, "limit": limit}
                     for name, (v, limit) in checks.items()}
    return out

