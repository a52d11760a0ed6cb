"""device_wait_pct.<part>: share (%) of the window in which the host was
blocked on the card: the union of the program's ``backend.wait`` spans (a
synchronize of the stream, made only while the recorder is on, just before
the first read that would have waited as long). One reader for every
part."""

from benchmark.harness import program

WAITS = ("backend.wait",)


def read(run):
    return program.share_pct(run, WAITS)
