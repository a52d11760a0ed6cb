"""The program's own spans in a traced run.

The program records its host spans in memory while its recorder is on
(``vbz_compression_tpu_torch.utils.profiling``: a name by layer, start and
end on ``time.perf_counter_ns``, thread, parent, public call, bytes).
Importing this module turns the recorder on. Only a traced run loads the
per-layer readers that import it, and it loads them before its warm-up, so
runs without ``--trace`` keep the recorder off.

On a run's first read, :func:`window` takes the records inside the run's
window and merges each span's own time (its interval less its children's,
on any thread) into ``run.spans.records`` as ``(label, start, end,
thread)``: the runner's breakdown of the device's idle gaps then puts each
gap under the innermost span the host was in. No program label is a label
of the harness's wrappers, so what the other readers read does not change.
A program without the recorder gives no records, and every reader of them
reads nothing.
"""

from __future__ import annotations

from vbz_compression_tpu_torch.utils import profiling

if hasattr(profiling, "start"):
    profiling.start()


def window(run) -> list | None:
    """The program's records inside ``run``'s window (None where the run
    has no spans, or the program recorded none there). ``run.spans.program``,
    where a test sets it, stands for the recorder's records."""
    sp = run.spans
    if sp is None:
        return None
    if not getattr(sp, "program_merged", False):
        given = getattr(sp, "program", None)
        if given is None:
            given = profiling.spans() if hasattr(profiling, "spans") else []
        sp.program = [r for r in given
                      if r.end > run.lo_ns and r.start < run.hi_ns]
        sp.records += own_time(sp.program)
        sp.program_merged = True
    return sp.program or None


def union(intervals) -> list:
    """Sorted disjoint [start, end] pairs covering ``intervals``."""
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def own_time(records) -> list:
    """Each record's interval less the union of its children's, as
    ``(name, start, end, thread)`` pieces."""
    children: dict[int, list] = {}
    for r in records:
        children.setdefault(r.parent, []).append((r.start, r.end))
    out = []
    for r in records:
        at = r.start
        for a, b in union(children.get(r.id, ())):
            if a > at:
                out.append((r.name, at, min(a, r.end), r.thread))
            at = max(at, b)
            if at >= r.end:
                break
        if at < r.end:
            out.append((r.name, at, r.end, r.thread))
    return out


def share_pct(run, names) -> float | None:
    """Share (%) of the window that the union of the named spans' own time
    covers, on any thread; 0 where the program recorded spans in the window
    but none of these; None where it recorded none."""
    if window(run) is None:
        return None
    pieces = [(max(a, run.lo_ns), min(b, run.hi_ns))
              for name, a, b, _ in run.spans.records
              if name in names and b > run.lo_ns and a < run.hi_ns]
    covered = sum(b - a for a, b in union(pieces))
    return 100.0 * covered / (run.hi_ns - run.lo_ns)


def rate_gb_s(run, names) -> float | None:
    """Bytes counted on the named spans over their summed durations (GB/s);
    None where they took no time or the program recorded nothing."""
    records = window(run)
    if records is None:
        return None
    chosen = [r for r in records if r.name in names]
    ns = sum(r.end - r.start for r in chosen)
    return sum(r.nbytes for r in chosen) / ns if ns else None
