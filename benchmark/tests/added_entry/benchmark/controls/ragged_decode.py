"""Control of ``ragged_decode``: the reference decoder with ``ok`` true for
every row."""

from __future__ import annotations

import torch

from benchmark.harness import reference


def control(cell):
    def decode(flat, offsets, lengths):
        values = torch.cat([
            reference.decode(flat[a:b], n) for a, b, n in
            zip(offsets[:-1].tolist(), offsets[1:].tolist(),
                lengths.tolist())])
        return values, torch.ones(len(lengths), dtype=torch.bool)
    return decode
