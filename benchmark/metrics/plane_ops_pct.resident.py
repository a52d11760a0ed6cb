"""plane_ops_pct.resident: share (%) of the card's busy time spent in ops other
than kernel D. The wire-format plane decodes its W2 stream rows in place
with D, so what it runs besides is the fill of D's look-back words (a
``cudaMemsetAsync`` before each call's D); any copy, fill or tensor op that a
change adds to the plane's path shows here."""

KERNELS = ("decode_w2",)


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    total = run.trace.total_s()
    return 100.0 * (total - run.trace.seconds_of(KERNELS)) / total
