"""resident_decode_gb_s: raw int16 bytes decoded on the card, streams in and
values out on the card, per second of the window (GB/s, 1e9 bytes), over all
the window's calls and all its time."""


def read(run):
    return run.rate_gb_s()
