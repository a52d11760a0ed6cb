"""e_roofline.<part>: share (%) of the HBM peak (3,350 GB/s, the H100 SXM data
sheet's, at 700 W) that kernel E (``csrc/w2_codec.cu``) reaches: the bytes
its calls of the window must move, counted on live values
(``harness/counting.py``), over its device time in the trace (ops whose name
holds ``encode_w2``). One reader for every part."""

from benchmark.harness import counting

KERNELS = ("encode_w2",)


def read(run):
    if run.trace is None:
        return None
    return counting.roofline_pct(run.counts.get("e_bytes", 0),
                                 run.trace.seconds_of(KERNELS))
