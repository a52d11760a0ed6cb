"""Entry: ``stand_in_ragged_plane.decode``, ``reads_per_call`` v0 streams a
call in one flat buffer with row offsets, values out in one flat buffer.

Set-up lays the reference's streams end to end in the set's order, then
the first ``reads_per_call - 1`` again, so that every call's rows are one
contiguous slice. The check requires ``ok`` for every row of the window,
compares the values of a sample of calls (a reservoir of
``sample_calls``, drawn from the seed) with the set, and compares ``ok``
with the reference's on call 0's rows with every fourth stream one byte
longer or shorter."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import counting, reference, sample
from benchmark.harness.runner import Call


def well_formed(stream: torch.Tensor, count: int) -> bool:
    """Whether the reference decoder takes the stream."""
    try:
        reference.validate(stream, count)
    except reference.Refused:
        return False
    return True


class Entry:
    def __init__(self, cell, program=None):
        import stand_in_ragged_plane

        self.cell = cell
        self.program = program or stand_in_ragged_plane.decode
        st = cell.streams
        self.b = cell.traffic["reads_per_call"]
        order = np.concatenate([np.arange(cell.reads.count),
                                np.arange(self.b - 1)])
        self.counts = torch.from_numpy(cell.reads.lengths[order])
        self.offsets = torch.from_numpy(
            np.concatenate([[0], np.cumsum(st.lengths[order])]))
        wrap = int(st.starts[self.b - 1]) if self.b > 1 else 0
        self.flat = torch.cat([st.flat, st.flat[:wrap]])
        self.sample = sample.Reservoir(cell.traffic["sample_calls"],
                                       cell.seed)
        self.oks: list = []

    def _rows(self, k):
        s = (k * self.b) % self.cell.reads.count
        off = self.offsets[s:s + self.b + 1]
        return (self.flat[int(off[0]):int(off[-1])], off - off[0],
                self.counts[s:s + self.b])

    def warm_up(self):
        for k in range(self.cell.traffic["warmup_calls"]):
            self.program(*self._rows(k))

    def call(self, k, idx) -> Call:
        values, ok = self.program(*self._rows(k))
        self.oks.append(ok)
        self.sample.add((idx, values))
        n = self.cell.reads.lengths[idx]
        return Call(raw_bytes=2 * int(n.sum()), counts={
            "d_bytes": counting.decode_bytes(
                n, self.cell.streams.lengths[idx])})

    def drain(self):
        pass

    def check(self) -> dict:
        rs = self.cell.reads
        differing = 0
        for idx, values in self.sample.items:
            at = 0
            for i in idx:
                s, n = int(rs.starts[i]), int(rs.lengths[i])
                differing += not torch.equal(values[at:at + n],
                                             rs.values[s:s + n])
                at += n
            differing += at != values.numel()
        flat, off, counts = self._rows(0)
        streams = [flat[a:b] for a, b in
                   zip(off[:-1].tolist(), off[1:].tolist())]
        for j in range(0, len(streams), 4):
            s = streams[j]
            streams[j] = torch.cat([s, s[-1:]]) if j % 8 == 0 else s[:-1]
        moved = torch.tensor([0] + [len(s) for s in streams]).cumsum(0)
        _, ok = self.program(torch.cat(streams), moved, counts)
        expect = [well_formed(s, n)
                  for s, n in zip(streams, counts.tolist())]
        return {"rows_not_ok": (int((~torch.cat(self.oks)).sum()), 0),
                "sampled_rows_differing": (differing, 0),
                "ok_differing_on_moved_lengths": (sum(
                    bool(a) != b for a, b in zip(ok.tolist(), expect)), 0)}
