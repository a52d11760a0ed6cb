"""Entry: ``api.compress(read, options)``, pyvbz's call and the HDF5
filter's pattern on write, one host int16 read a call in the set's order,
returning its sized frame in host memory.

The check compares the frames of a sample of the window's calls (a
reservoir of ``sample_calls``, drawn from the seed), byte for byte, with
the reference's frame of the same read at the configuration's options and
zstd parameters."""

from __future__ import annotations

from benchmark.harness import counting, sample
from benchmark.harness.runner import Call


class Entry:
    def __init__(self, cell, program=None):
        from vbz_compression_tpu_torch import api
        from vbz_compression_tpu_torch.options import CompressionOptions

        self.cell = cell
        self.options = CompressionOptions.from_cd_values(
            tuple(cell.config["options"]))
        self.program = program or api.compress
        self.reads = cell.host_reads
        self.stream_lens = cell.streams.lengths
        self.outputs = sample.Reservoir(cell.traffic["sample_calls"],
                                         cell.seed)

    def warm_up(self):
        for k in range(self.cell.traffic["warmup_calls"]):
            for i in self.cell.batch(k):
                self.program(self.reads[i], self.options)

    def call(self, k, idx) -> Call:
        outs = [self.program(self.reads[i], self.options) for i in idx]
        self.outputs.add((idx, outs))
        n = self.cell.reads.lengths[idx]
        return Call(raw_bytes=2 * int(n.sum()), counts={
            "e_bytes": counting.encode_bytes(n, self.stream_lens[idx])})

    def drain(self):
        pass

    def check(self) -> dict:
        truth = self.cell.frames
        differing = 0
        for idx, outs in self.outputs.items:
            differing += abs(len(idx) - len(outs))
            differing += sum(bytes(o) != truth[i] for i, o in zip(idx, outs))
        return {"frames_differing": (differing, 0)}
