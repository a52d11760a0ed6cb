"""What a codec kernel's calls must move, counted on live values, and the
peak it is held against.

A copy of the idea of the program's ``utils/roofline.codec_bytes`` with
one repair: that function counts ``x.numel()`` and ``keys.numel()``, the
padded ``[B, N]`` sizes, so on a ragged batch it counts padding as work.
Here each read counts its own values: each input byte read once, each
output byte written once.
"""

from __future__ import annotations

import numpy as np

# H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s (at the 700 W limit).
HBM_PEAK_BYTES_S = 3350e9


def encode_bytes(counts: np.ndarray, stream_lens: np.ndarray) -> int:
    """Bytes kernel E must move for int16 rows of ``counts`` values whose
    v0 streams are ``stream_lens`` bytes: the values and each row's int32
    length read, the key and data bytes and each row's int32 data length
    written."""
    counts = np.asarray(counts, np.int64)
    return int(2 * counts.sum() + 4 * counts.size
               + np.asarray(stream_lens, np.int64).sum() + 4 * counts.size)


def decode_bytes(counts: np.ndarray, stream_lens: np.ndarray) -> int:
    """Bytes kernel D must move for the same rows: the key and data bytes
    and each row's int32 count read, the values written."""
    counts = np.asarray(counts, np.int64)
    return int(np.asarray(stream_lens, np.int64).sum() + 4 * counts.size
               + 2 * counts.sum())


def roofline_pct(nbytes: int, seconds: float) -> float | None:
    """Share (%) of the HBM peak that moving ``nbytes`` in ``seconds`` of
    kernel time reaches; None where no kernel time was seen."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / seconds / HBM_PEAK_BYTES_S
