"""Entry: ``api.vbz_decompress_sized_batch``, the batch API's decode, on
``reads_per_call`` sized frames a call, host bytes in and host bytes out.

The frames are the reference's, made in set-up. The check compares the
reads of a sample of the window's calls (a reservoir of ``sample_calls``,
drawn from the seed) with the set, and sends the malformed frames of
``harness/malformed.py`` through the same call, one in a batch of the
window's size, each to be refused with the reference's code."""

from __future__ import annotations

from benchmark.harness import counting, malformed, sample
from benchmark.harness.runner import Call


class Entry:
    def __init__(self, cell, program=None):
        from vbz_compression_tpu_torch import api
        from vbz_compression_tpu_torch.options import CompressionOptions

        self.cell = cell
        self.options = CompressionOptions.from_cd_values(
            tuple(cell.config["options"]))
        self.program = program or api.vbz_decompress_sized_batch
        self.frames = cell.frames
        self.stream_lens = cell.streams.lengths
        self.outputs = sample.Reservoir(cell.traffic["sample_calls"],
                                         cell.seed)

    def _decode(self, idx):
        return self.program([self.frames[i] for i in idx], self.options)

    def warm_up(self):
        for k in range(self.cell.traffic["warmup_calls"]):
            self._decode(self.cell.batch(k))

    def call(self, k, idx) -> Call:
        self.outputs.add((idx, self._decode(idx)))
        n = self.cell.reads.lengths[idx]
        return Call(raw_bytes=2 * int(n.sum()), counts={
            "d_bytes": counting.decode_bytes(n, self.stream_lens[idx])})

    def drain(self):
        pass

    def check(self) -> dict:
        truth = [r.tobytes() for r in self.cell.host_reads]
        differing = 0
        for idx, outs in self.outputs.items:
            differing += abs(len(idx) - len(outs))
            differing += sum(bytes(o) != truth[i] for i, o in zip(idx, outs))
        wrong = malformed.refused_wrong(
            lambda batch: self.program(batch, self.options), self.cell,
            batched=True)
        return {"reads_differing": (differing, 0),
                "malformed_not_refused": (wrong, 0)}
