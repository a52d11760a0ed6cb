"""The device trace of a run: ``torch.profiler`` with CUDA activity only,
exported as a chrome trace to a temporary directory, read back, and
reduced to device ops by name, the device's busy time, and its idle gaps.

Only CUDA activity is traced: tracing every host op would itself take host
time in cells the host bounds. The trace's timestamps are microseconds
after its ``baseTimeNanoseconds``, on the wall clock; host spans are taken
on ``time.perf_counter_ns`` and moved onto that clock with one offset read
when tracing starts.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    """Device ops as (name, start_us, end_us) on the trace's clock, and the
    offset that moves a ``perf_counter_ns`` reading onto it."""

    def __init__(self, ops: list, offset_ns: int):
        self.ops = sorted(ops, key=lambda op: op[1])
        self.offset_ns = offset_ns

    def to_us(self, perf_ns: int) -> float:
        return (perf_ns + self.offset_ns) / 1e3

    def busy(self, lo_us: float, hi_us: float) -> list:
        """Disjoint (start, end) intervals in which some op ran, clipped to
        [lo_us, hi_us]."""
        merged: list[list[float]] = []
        for _, a, b in self.ops:
            a, b = max(a, lo_us), min(b, hi_us)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [tuple(m) for m in merged]

    def busy_s(self, lo_us: float, hi_us: float) -> float:
        return sum(b - a for a, b in self.busy(lo_us, hi_us)) / 1e6

    def seconds_of(self, names) -> float:
        """Seconds of the ops whose name holds one of ``names``."""
        return sum(b - a for n, a, b in self.ops
                   if any(k in n for k in names)) / 1e6

    def total_s(self) -> float:
        return sum(b - a for _, a, b in self.ops) / 1e6

    def by_name(self, top: int = 10) -> list:
        totals: dict[str, float] = {}
        for n, a, b in self.ops:
            totals[n] = totals.get(n, 0.0) + (b - a) / 1e6
        return sorted(([n[:160], s] for n, s in totals.items()),
                      key=lambda e: -e[1])[:top]

    def gaps(self, lo_us: float, hi_us: float) -> list:
        """The idle intervals of [lo_us, hi_us]."""
        out, at = [], lo_us
        for a, b in self.busy(lo_us, hi_us):
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if hi_us > at:
            out.append((at, hi_us))
        return out


def load(path: str, offset_ns: int) -> DeviceTrace:
    with open(path) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    ops = [(e.get("name", "?"), float(e["ts"]) + base_us,
            float(e["ts"]) + base_us + float(e.get("dur", 0)))
           for e in trace.get("traceEvents", ())
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    return DeviceTrace(ops, offset_ns)


class Recorder:
    """Traces the device for the body of :meth:`window`; ``trace`` holds
    the result after it."""

    def __init__(self):
        self.trace: DeviceTrace | None = None

    @contextlib.contextmanager
    def window(self):
        activities = [torch.profiler.ProfilerActivity.CUDA]
        with tempfile.TemporaryDirectory() as tmp:
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            offset_ns = time.time_ns() - time.perf_counter_ns()
            try:
                yield self
            finally:
                torch.cuda.synchronize()
                prof.stop()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            self.trace = load(path, offset_ns)
