"""Profiling instrumentation.

The port's counterpart of ``vbz_compression_tpu/utils/profiling.py``:

- :func:`trace`: context manager around ``torch.profiler`` (CPU, and CUDA
  when a card is visible) that writes a chrome trace into ``log_dir`` when
  one is given;
- :func:`annotate`: a named range, seen by ``torch.profiler``
  (``record_function``) and, on a card, by NVTX tools;
- :func:`span` and :func:`call`: the program's own host spans, off by
  default; :func:`recording` (or :func:`start` / :func:`stop`) turns them
  on and :func:`spans` hands out the records;
- :func:`warm_ms` and :func:`cold_ms`: a call's device time from CUDA
  events, back to back or with the L2 flushed before it; :func:`card`: the
  card's name and power limit, which every number measured on it carries.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import subprocess
import threading
import time
from typing import NamedTuple

import torch


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


# ---------------------------------------------------------------------------
# The program's own spans
#
# Each host layer opens a span where its work happens, named by layer:
# ``api.*`` (the public calls), ``zstd.*`` (the api's zstd stage),
# ``backend.*`` (``TorchSvbBackend``) and ``plane.*`` (the wire-format
# plane). A public call opens the root of its spans; every span under it,
# on its thread or on a zstd pool thread, carries the root's id as its call.
# The recorder is off by default: then :func:`span` and :func:`call` check
# one flag and hand back one shared inert context.
# ---------------------------------------------------------------------------


class Span(NamedTuple):
    """One span: ``start`` and ``end`` on ``time.perf_counter_ns``; the
    thread's ident; its own id, the id of the span it lies in (0 for none)
    and of its public call's root (0 outside any call); the bytes it moved
    or checked (0 where it counts none)."""

    name: str
    start: int
    end: int
    thread: int
    id: int
    parent: int
    call: int
    nbytes: int


class _Off:
    """The span of a recorder that is off: counts nothing and tests
    false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def add(self, nbytes: int) -> None:
        pass


_OFF = _Off()
_on = False
# A Span's fields a record; list.append and list.copy hold the interpreter
# lock, so threads need no other.
_records: list[tuple] = []
_ids = itertools.count(1)
_local = threading.local()  # .stack: (id, call) of each open span


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Live:
    __slots__ = ("name", "nbytes", "root", "stack", "start", "id", "parent",
                 "call")

    def __init__(self, name: str, nbytes: int, root: bool):
        self.name, self.nbytes, self.root = name, nbytes, root

    def __enter__(self):
        stack = self.stack = _stack()
        self.parent, self.call = stack[-1] if stack else (0, 0)
        self.id = next(_ids)
        if self.root:
            self.call = self.id
        stack.append((self.id, self.call))
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        if _on:
            _records.append((self.name, self.start, end,
                             threading.get_ident(), self.id, self.parent,
                             self.call, self.nbytes))
        return False

    def add(self, nbytes: int) -> None:
        """Count ``nbytes`` more on this span."""
        self.nbytes += nbytes


def span(name: str, nbytes: int = 0):
    """A span of ``name`` for a ``with`` block, counting ``nbytes`` (more
    with ``.add``); an inert, false context while the recorder is off."""
    if not _on:
        return _OFF
    return _Live(name, nbytes, False)


def call(name: str):
    """The root span of a public call: a new call where this thread has no
    open span, else inert, so that a public function called by another
    opens nothing."""
    if not _on or _stack():
        return _OFF
    return _Live(name, 0, True)


def carry(fn):
    """``fn`` for a pool thread: its spans lie under the calling thread's
    open span and carry its call. ``fn`` itself when nothing is open."""
    if not _on or not _stack():
        return fn
    top = _stack()[-1]

    def carried(*args, **kwargs):
        saved = _stack()
        _local.stack = [top]
        try:
            return fn(*args, **kwargs)
        finally:
            _local.stack = saved
    return carried


def start() -> None:
    """Turn the recorder on, with no records."""
    global _on
    _records.clear()
    _on = True


def stop() -> None:
    """Turn the recorder off; the records stay until the next start."""
    global _on
    _on = False


@contextlib.contextmanager
def recording():
    """The recorder on for the body of the block; :func:`spans` after it
    reads what the block recorded."""
    start()
    try:
        yield
    finally:
        stop()


def spans() -> list[Span]:
    """The records so far, in the order the spans ended."""
    return [Span._make(r) for r in _records.copy()]


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
