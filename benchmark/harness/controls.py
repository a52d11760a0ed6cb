"""The controls: the reference put in the program's place with one of the
configuration's guarantees broken, the step a later change might be
tempted to take. Each check must read the control as not correct.

- the read entry: the reference decoder without the stream validation
  that takes most of the backend's decode;
- the write entry: the reference encoder at libzstd's stock level 1 in place
  of the stated parameters (a cheaper setting that changes the frames);
- the plane: the reference decoder with ``ok`` true for every row.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

STOCK_LEVEL_1 = {"compressionLevel": 1, "contentSizeFlag": 1,
                 "checksumFlag": 0}


def api_read_one(cell):
    level = cell.config["options"][3]

    def decode(frame, dtype):
        return reference.decode_frame(frame, level, cell.device,
                                      validating=False).view(dtype)
    return decode


def api_write_one(cell):
    def encode(read, options):
        lengths = np.array([read.size], np.int64)
        flat = torch.from_numpy(read).to(cell.device)
        stream = reference.encode(flat, np.array([0]), lengths).host()
        return np.frombuffer(
            reference.frames(stream, lengths, STOCK_LEVEL_1)[0], np.uint8)
    return encode


def plane_decode(cell):
    def decode(streams, lengths, stream_lens, *, out_n, **_):
        out = torch.zeros(streams.shape[0], out_n, dtype=torch.int16,
                          device=streams.device)
        for j, (n, sl) in enumerate(zip(lengths.tolist(),
                                        stream_lens.tolist())):
            out[j, :n] = reference.decode(streams[j, :sl], n)
        return out, torch.ones(streams.shape[0], dtype=torch.bool,
                               device=streams.device)
    return decode


def for_entry(entry: str, cell):
    return globals()[entry](cell)
