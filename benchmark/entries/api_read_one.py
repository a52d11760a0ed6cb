"""Entry: ``api.decompress(frame, numpy.int16)``, pyvbz's call and the HDF5
filter's pattern, one sized frame a call in the set's order, host bytes in
and a host array out.

The check compares the reads of a sample of the window's calls (a
reservoir of ``sample_calls``, drawn from the seed) with the set, and sends
each malformed frame of ``harness/malformed.py`` through the same call, to
be refused with the reference's code."""

from __future__ import annotations

import numpy as np

from benchmark.harness import counting, malformed, sample
from benchmark.harness.runner import Call


class Entry:
    def __init__(self, cell, program=None):
        from vbz_compression_tpu_torch import api

        self.cell = cell
        self.program = program or api.decompress
        self.frames = cell.frames
        self.stream_lens = cell.streams.lengths
        self.outputs = sample.Reservoir(cell.traffic["sample_calls"],
                                         cell.seed)

    def warm_up(self):
        for k in range(self.cell.traffic["warmup_calls"]):
            for i in self.cell.batch(k):
                self.program(self.frames[i], np.int16)

    def call(self, k, idx) -> Call:
        outs = [self.program(self.frames[i], np.int16) for i in idx]
        self.outputs.add((idx, outs))
        n = self.cell.reads.lengths[idx]
        return Call(raw_bytes=2 * int(n.sum()), counts={
            "d_bytes": counting.decode_bytes(n, self.stream_lens[idx])})

    def drain(self):
        pass

    def check(self) -> dict:
        truth = self.cell.host_reads
        differing = 0
        for idx, outs in self.outputs.items:
            differing += sum(
                not (o.dtype == np.int16 and np.array_equal(o, truth[i]))
                for i, o in zip(idx, outs))
        wrong = malformed.refused_wrong(
            lambda frame: self.program(frame, np.int16), self.cell)
        return {"reads_differing": (differing, 0),
                "malformed_not_refused": (wrong, 0)}
