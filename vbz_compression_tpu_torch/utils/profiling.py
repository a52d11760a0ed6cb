"""Profiling and debug instrumentation.

The port's counterpart of ``vbz_compression_tpu/utils/profiling.py``:

- :func:`trace`: context manager around ``torch.profiler`` (CPU, and CUDA
  when a card is visible) that writes a chrome trace into ``log_dir`` when
  one is given;
- :func:`annotate`: a named range, seen by ``torch.profiler``
  (``record_function``) and, on a card, by NVTX tools;
- :func:`debug_checksums`: ``VBZ_DEBUG``-gated XOR checksums of buffers, in
  the native plugin's format, so host and device paths can be diffed;
- :func:`warm_ms` and :func:`cold_ms`: a call's device time from CUDA
  events, back to back or with the L2 flushed before it; :func:`card`: the
  card's name and power limit, which every number measured on it carries.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import numpy as np
import torch


def debug_enabled() -> bool:
    v = os.environ.get("VBZ_DEBUG", "")
    return bool(v) and v != "0"


def xor_checksum(buf) -> int:
    """Same rolling XOR as the native plugin's debug output."""
    arr = np.frombuffer(bytes(buf), dtype=np.uint8)
    pad = (-arr.size) % 4
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, np.uint8)])
    words = (arr.reshape(-1, 4).astype(np.uint32)
             << (np.arange(4, dtype=np.uint32) * 8)).sum(axis=1,
                                                         dtype=np.uint32)
    return int(np.bitwise_xor.reduce(words)) if words.size else 0


def debug_checksums(tag: str, **buffers) -> None:
    if not debug_enabled():
        return
    parts = [f"{k} size={len(bytes(v))} checksum={xor_checksum(v):08x}"
             for k, v in buffers.items()]
    print(f"vbz debug: {tag}: " + " | ".join(parts), file=sys.stderr)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed region; on exit write ``log_dir/trace.json``
    (chrome://tracing or Perfetto) if ``log_dir`` is given. Yields the
    profiler, whose ``key_averages()`` give time per kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region annotation inside a trace."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


# About 100 us at the H100's clocks: more than the host takes to enqueue
# one wrapper call.
_SLEEP_CYCLES_PER_CALL = 200_000


def card() -> str:
    """``nvidia-smi``'s name and power limit of the visible card(s)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def warm_ms(fn, calls: int = 10, repeats: int = 3) -> float:
    """Device ms per call of ``fn``: ``calls`` calls back to back between
    two CUDA events, best of ``repeats`` such runs, after one warm-up call.
    The device sleeps while the host enqueues the calls, so that a call
    whose host side outlasts its kernel is timed by its kernel."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda._sleep(_SLEEP_CYCLES_PER_CALL * calls)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def cold_ms(fn, flush: torch.Tensor, repeats: int = 3) -> float:
    """Device ms of one call of ``fn`` with the L2 flushed just before it
    (``flush``, a buffer larger than the L2, zeroed), the device kept busy
    while the host enqueues so that launch gaps stay out; best of
    ``repeats``."""
    best = float("inf")
    for _ in range(repeats):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best
