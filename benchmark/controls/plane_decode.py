"""Control of ``plane_decode``: the reference decoder with ``ok`` true for
every row."""

from __future__ import annotations

import torch

from benchmark.harness import reference


def control(cell):
    def decode(streams, lengths, stream_lens, *, out_n, **_):
        out = torch.zeros(streams.shape[0], out_n, dtype=torch.int16,
                          device=streams.device)
        for j, (n, sl) in enumerate(zip(lengths.tolist(),
                                        stream_lens.tolist())):
            out[j, :n] = reference.decode(streams[j, :sl], n)
        return out, torch.ones(streams.shape[0], dtype=torch.bool,
                               device=streams.device)
    return decode
