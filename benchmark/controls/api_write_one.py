"""Control of ``api_write_one``: the reference encoder at libzstd's stock
level 1 in place of the stated parameters (a cheaper setting that changes
the frames)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import reference

STOCK_LEVEL_1 = {"compressionLevel": 1, "contentSizeFlag": 1,
                 "checksumFlag": 0}


def control(cell):
    def encode(read, options):
        lengths = np.array([read.size], np.int64)
        flat = torch.from_numpy(read).to(cell.device)
        stream = reference.encode(flat, np.array([0]), lengths).host()
        return np.frombuffer(
            reference.frames(stream, lengths, STOCK_LEVEL_1)[0], np.uint8)
    return encode
