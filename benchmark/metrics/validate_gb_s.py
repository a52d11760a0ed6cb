"""validate_gb_s.<part>: the stream bytes the backend validated on the host
(counted on the program's ``backend.validate`` spans, one a batch call)
over those spans' summed host time (GB/s, 1e9 bytes): the rate of
validation where it runs. One reader for every part."""

from benchmark.harness import program

VALIDATION = ("backend.validate",)


def read(run):
    return program.rate_gb_s(run, VALIDATION)
