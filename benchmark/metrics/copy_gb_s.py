"""copy_gb_s.<part>: the bytes the backend copied to and from the card
(counted on the program's spans ``backend.h2d`` and ``backend.d2h``) over
the host time of those spans, summed (GB/s, 1e9 bytes): the rate of the
pageable copies as the host sees them. One reader for every part."""

from benchmark.harness import program

COPIES = ("backend.h2d", "backend.d2h")


def read(run):
    return program.rate_gb_s(run, COPIES)
