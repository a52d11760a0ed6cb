"""call_p95_ms.<part>: the 95th percentile (ms) of one call's host time over
every call of the traced window, the calls as the entry makes them (one
read a call in the per-read cells): the tail of per-call overhead. Each
call is timed on the host clock, to well under a microsecond, but the
traced run's spans and device trace add their own cost to each call. None
with fewer than 20 calls. One reader for every part."""

import statistics


def read(run):
    if len(run.call_ns) < 20:
        return None
    return statistics.quantiles(run.call_ns, n=20)[18] / 1e6
