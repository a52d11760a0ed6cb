"""idle_unexplained_pct.<part>: share (%) of the device's idle time in the
window during which the host was in no span of the program, on any thread:
the idle gaps of the device trace less their overlap with the union of the
program's spans, moved onto the trace's clock. What is left is the harness's
loop between calls and whatever the program does outside its spans. One
reader for every part."""

from benchmark.harness import program, runner


def read(run):
    records = program.window(run)
    if records is None or run.trace is None or not run.trace.ops:
        return None
    gaps = run.trace.gaps(*run.trace_window_us)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    covered = program.union([(run.trace.to_us(r.start),
                              run.trace.to_us(r.end)) for r in records])
    starts = [a for a, _ in covered]
    explained = sum(runner._overlap(covered, starts, a, b) for a, b in gaps)
    return 100.0 * (idle - explained) / idle
