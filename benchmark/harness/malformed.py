"""Frames the configuration's guarantees say must be refused, each with the
reference's error code, made from one read of the set drawn from the seed.

- ``short_data``: the stream's last data byte left out;
- ``code_above_1``: the first value's code set to 2, which no int16 stream
  holds;
- ``key_bits_past_end``: a key bit set past the last value (a read whose
  length is not a multiple of 4);
- ``odd_size``: a sized header of an odd byte count;
- ``zstd_cut`` (zstd configurations): the frame's last byte left out.
"""

from __future__ import annotations

import sys

import numpy as np

from . import reference


def cases(cell) -> list[tuple[str, bytes, int]]:
    rng = np.random.default_rng(cell.seed)
    lengths = cell.reads.lengths
    streams = cell.streams.host()
    i = int(rng.integers(len(lengths)))
    n, stream = int(lengths[i]), bytearray(streams[i])
    head = (2 * n).to_bytes(4, "little")
    out = []

    def add(name, header, body, code):
        out.append((name, header + cell.zstd_stage(bytes(body)), code))

    add("short_data", head, stream[:-1],
        reference.VBZ_STREAMVBYTE_STREAM_ERROR)
    bad = bytearray(stream)
    bad[0] = (bad[0] & 0xFC) | 2
    add("code_above_1", head, bad, reference.VBZ_STREAMVBYTE_STREAM_ERROR)
    odd = [j for j in rng.permutation(len(lengths)) if lengths[j] % 4]
    if odd:
        j = int(odd[0])
        m, tail = int(lengths[j]), bytearray(streams[j])
        key_len = (m + 3) // 4
        tail[key_len - 1] |= 0xC0  # the last key byte's top code
        add("key_bits_past_end", (2 * m).to_bytes(4, "little"), tail,
            reference.VBZ_STREAMVBYTE_STREAM_ERROR)
    add("odd_size", (2 * n + 1).to_bytes(4, "little"), stream,
        reference.VBZ_DESTINATION_SIZE_ERROR)
    if cell.zstd_params is not None:
        whole = head + cell.zstd_stage(bytes(stream))
        out.append(("zstd_cut", whole[:-1], reference.VBZ_ZSTD_ERROR))
    return out


def refused_wrong(decode, cell) -> int:
    """How many cases ``decode`` fails to refuse with the reference's code,
    each frame alone (their names go to standard error)."""
    wrong = []
    for name, frame, code in cases(cell):
        try:
            decode(frame)
        except Exception as exc:  # the program's VbzError, or the control's
            if getattr(exc, "code", None) == code:
                continue
        wrong.append(name)
    if wrong:
        print(f"malformed frames not refused as the reference refuses them: "
              f"{', '.join(wrong)}", file=sys.stderr)
    return len(wrong)
