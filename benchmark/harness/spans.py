"""Host spans taken around the program's functions, from outside the
program.

In a traced run the harness replaces named functions of the program with
wrappers that record (label, start, end, thread) in memory and call the
original; nothing is written to disk and no program file changes. A label's
share of the window is the union of its spans' intervals over the window's
length, so overlapping calls from a thread pool count once.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import threading
import time


class Spans:
    def __init__(self):
        self.records: list[tuple[str, int, int, int]] = []
        self._lock = threading.Lock()

    def wrap(self, label: str, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter_ns()
                with self._lock:
                    self.records.append((label, t0, t1,
                                         threading.get_ident()))
        return wrapper

    def intervals(self, label: str, lo: int, hi: int) -> list:
        """The union of ``label``'s spans, clipped to [lo, hi] (ns), as
        sorted disjoint (start, end) pairs."""
        spans = sorted((max(a, lo), min(b, hi)) for name, a, b, _ in
                       self.records if name == label and b > lo and a < hi)
        merged: list[list[int]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [tuple(m) for m in merged]

    def share(self, label: str, lo: int, hi: int) -> float | None:
        """Union of ``label``'s spans over [lo, hi] as a share of it; None
        where the label has no span there."""
        union = self.intervals(label, lo, hi)
        if not union or hi <= lo:
            return None
        return sum(b - a for a, b in union) / (hi - lo)


def _resolve(target: str):
    """``"package.module:Class.attr"`` -> (owner object, attribute name)."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for name in parents:
        owner = getattr(owner, name)
    return owner, attr


@contextlib.contextmanager
def installed(spans: Spans, targets: dict):
    """Wrap each ``targets[label]`` (``"module:qualname"``) for the body of
    the block, and put the originals back after it."""
    saved = []
    try:
        for label, target in targets.items():
            owner, attr = _resolve(target)
            original = owner.__dict__[attr] if isinstance(owner, type) \
                else getattr(owner, attr)
            saved.append((owner, attr, original))
            setattr(owner, attr, spans.wrap(label, getattr(owner, attr)))
        yield spans
    finally:
        for owner, attr, original in reversed(saved):
            setattr(owner, attr, original)
