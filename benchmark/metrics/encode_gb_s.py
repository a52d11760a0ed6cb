"""encode_gb_s: raw int16 bytes the entry took in as host arrays and returned
as sized frames in host memory, per second of the window (GB/s, 1e9 bytes),
over all the window's calls and all its time."""


def read(run):
    return run.rate_gb_s()
