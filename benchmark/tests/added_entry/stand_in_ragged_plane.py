"""A stand-in for a ragged decode plane, in the program's place for the
benchmark's tests: the v0 streams of a call's rows end to end in one flat
uint8 buffer, row ``j`` at ``flat[offsets[j]:offsets[j + 1]]``, decoded by
the reference decoder into one flat int16 buffer of every row's values in
turn, with each row's ``ok``. ``rows``, looked up on every call, is where
it produces its answer."""

from __future__ import annotations

import torch

from benchmark.harness import reference


def rows(flat, offsets, lengths):
    values, ok = [], []
    for a, b, n in zip(offsets[:-1].tolist(), offsets[1:].tolist(),
                       lengths.tolist()):
        stream = flat[a:b]
        values.append(reference.decode(stream, n))
        # The plane's ok: the data end that the keys give is the stream's.
        kl = (n + 3) // 4
        codes = reference.key_codes(stream[:kl])[:n]
        ok.append(kl <= b - a and kl + n + int(codes.sum()) == b - a)
    return torch.cat(values), torch.tensor(ok)


def decode(flat, offsets, lengths):
    """(values, ok) of the rows of ``flat`` at ``offsets``."""
    return rows(flat, offsets, lengths)
