"""plane_ops_pct.resident: share (%) of the card's busy time spent in ops other
than kernel D: the wire-format plane's own tensor ops (the padded key slice,
the gather of the data section, the key counts behind ``ok``), its copies
and fills."""

KERNELS = ("decode_w2",)


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    total = run.trace.total_s()
    return 100.0 * (total - run.trace.seconds_of(KERNELS)) / total
