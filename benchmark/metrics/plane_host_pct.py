"""plane_host_pct.<part>: share (%) of the window in which the host was
enqueueing the wire-format plane's work: the union of the program's
``plane.decode`` span and its children (``plane.layout``, ``plane.launch``,
``plane.ok``). Host time only; the card's time is ``plane_ops_pct``. One
reader for every part."""

from benchmark.harness import program

PLANE = ("plane.decode", "plane.layout", "plane.launch", "plane.ok")


def read(run):
    return program.share_pct(run, PLANE)
