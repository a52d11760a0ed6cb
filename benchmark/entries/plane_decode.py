"""Entry: ``parallel.sharded.batch_decode_sharded`` with ``group=None``,
the port's wire-format plane, on ``reads_per_call`` v0 streams a call that
live on the card from set-up on; the values stay on the card.

Set-up lays the reference's streams out as the plane takes them: one row a
read, key bytes, then data bytes, then zeros to ``M = W/4 + 2W`` for
``W``, the longest read rounded up to 4; the first ``reads_per_call - 1``
rows again at the end, so that every call's rows are one contiguous slice.
The calls are enqueued without a wait; the window ends at a synchronize.
Set-up also builds a slot for each start row that the calls visit, the
calls cycling through the set in its order: that call's three row slices
and its counts. A call in the window is then the program's call on a slot's
slices and the keeping of its answer, and no bookkeeping of the harness's.

The check requires ``ok`` for every row of the window, compares the values
of a sample of calls (a reservoir of ``sample_calls``, drawn from the seed)
with the set, and compares ``ok`` with the reference's on call 0's rows with
some of their stream lengths moved off by one."""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.harness import counting, reference, sample
from benchmark.harness.runner import Call


def layout(cell):
    """(streams [R + b - 1, M] u8, lengths, stream lengths (int32), W) on
    the set's device."""
    rs, st = cell.reads, cell.streams
    b = cell.traffic["reads_per_call"]
    W = -(-int(rs.lengths.max()) // 4) * 4
    M = W // 4 + 2 * W
    order = np.concatenate([np.arange(rs.count), np.arange(b - 1)])
    rows = len(order)
    dev = rs.values.device
    slen = torch.from_numpy(st.lengths[order]).to(dev)
    row_of = torch.repeat_interleave(torch.arange(rows, device=dev), slen)
    first = torch.cumsum(slen, 0) - slen
    col = torch.arange(int(slen.sum()), device=dev) - first[row_of]
    src = torch.from_numpy(st.starts[order]).to(dev)[row_of] + col
    streams = torch.zeros(rows, M, dtype=torch.uint8, device=dev)
    streams[row_of, col] = st.flat[src]
    lengths = torch.from_numpy(rs.lengths[order].astype(np.int32)).to(dev)
    return streams, lengths, slen.to(torch.int32), W


class Entry:
    def __init__(self, cell, program=None):
        from vbz_compression_tpu_torch.parallel import sharded

        self.cell = cell
        self.streams, self.lengths, self.stream_lens, self.W = layout(cell)
        self.b = cell.traffic["reads_per_call"]
        self.program = functools.partial(
            program or sharded.batch_decode_sharded, group=None,
            integer_size=2, use_zigzag=True, out_n=self.W)
        self.slots = [self._slot(k) for k in range(cell.period)]
        self.sample = sample.Reservoir(cell.traffic["sample_calls"],
                                       cell.seed)
        self.oks: list = []

    def _slot(self, k) -> tuple:
        """Call ``k``'s rows, as the layout's slices, and its counts."""
        s = (k * self.b) % self.cell.reads.count
        rows = tuple(t[s:s + self.b] for t in
                     (self.streams, self.lengths, self.stream_lens))
        idx = self.cell.batch(k)
        n = self.cell.reads.lengths[idx]
        return rows, Call(raw_bytes=2 * int(n.sum()), counts={
            "d_bytes": counting.decode_bytes(
                n, self.cell.streams.lengths[idx])})

    def warm_up(self):
        for k in range(self.cell.traffic["warmup_calls"]):
            self.program(*self.slots[k % len(self.slots)][0])

    def call(self, k, idx) -> Call:
        rows, done = self.slots[k % len(self.slots)]
        out, ok = self.program(*rows)
        self.oks.append(ok)
        self.sample.add((k, out))
        return done

    def drain(self):
        if self.streams.is_cuda:
            torch.cuda.synchronize()

    def _rows_differing(self, k, out) -> int:
        rs = self.cell.reads
        wrong = 0
        for j, i in enumerate(self.cell.batch(k)):
            s, n = int(rs.starts[i]), int(rs.lengths[i])
            good = torch.equal(out[j, :n], rs.values[s:s + n]) and not bool(
                out[j, n:].any())
            wrong += not good
        return wrong

    def _ok_reference(self, streams, lengths, stream_lens):
        """The reference's ``ok``: the data end that the keys of each row's
        first ``lengths`` values give is the row's stream length, and the
        keys fit in it."""
        out = []
        for row, n, sl in zip(streams, lengths.tolist(),
                              stream_lens.tolist()):
            kl = (n + 3) // 4
            codes = reference.key_codes(row[:kl])[:n]
            end = kl + n + int(codes.sum())
            out.append(end == sl and kl <= sl)
        return out

    def check(self) -> dict:
        ok_false = int((~torch.cat(self.oks).bool()).sum())
        differing = sum(self._rows_differing(k, out) for k, out in
                        self.sample.items)
        # Call 0's rows, every fourth stream length moved off by one.
        streams = self.streams[:self.b]
        lengths = self.lengths[:self.b]
        moved = self.stream_lens[:self.b].clone()
        moved[0::8] += 1
        moved[4::8] -= 1
        _, ok = self.program(streams, lengths, moved)
        expect = self._ok_reference(streams, lengths, moved)
        ok_differing = sum(bool(a) != b for a, b in zip(ok.tolist(), expect))
        return {"rows_not_ok": (ok_false, 0),
                "sampled_rows_differing": (differing, 0),
                "ok_differing_on_moved_lengths": (ok_differing, 0)}
