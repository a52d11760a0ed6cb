"""Speed-of-light accounting for the port's kernels, and the copy kernel
that measures the bandwidth it is reckoned against.

The port's counterpart of ``vbz_compression_tpu/utils/roofline.py``. Two
denominators: ``HBM_PEAK_GB_S``, the H100 SXM data sheet's 3.35 TB/s, and
:func:`measure_copy_gbps`, the bandwidth that kernel CP (:func:`copy_blocked`,
``csrc/copy.cu``) reaches on the card at hand. A kernel's bound is the bytes
it must move over the data-sheet rate (:func:`bound_ms`); a codec call's
bytes are those :func:`codec_bytes` counts, and its share of either
denominator is those bytes per second over it.

``copy_blocked`` launches CP for a CUDA tensor (counted in
``COPY_LAUNCHES``) and runs :func:`copy_blocked_plain` for a CPU one.
"""

from __future__ import annotations

import torch

from ..ops import _rows
from . import profiling

# H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s.
HBM_PEAK_GB_S = 3350.0
LANES = 128
COPY_ROWS = (512, 2048, 8192)  # the capability probe's tile heights
COPY_LAUNCHES_TIMED, COPY_REPEATS = 20, 5

# Launches of kernel CP, one per copy_blocked call that reached the card.
COPY_LAUNCHES = 0


def bound_ms(nbytes: int) -> float:
    """The least time (ms) the card could take to move ``nbytes``."""
    return nbytes / (HBM_PEAK_GB_S * 1e9) * 1e3


def codec_bytes(x: torch.Tensor, keys: torch.Tensor,
                data_len: torch.Tensor) -> tuple[int, int]:
    """(encode, decode) bytes one StreamVByte row call must move, for any
    flavor: each input byte read once, each output byte written once.

    Encode reads ``x`` [B, N] and the [B] int32 lengths, and writes the key
    bytes, the data bytes it actually wrote (``data_len``, bytes in every
    flavor) and the [B] int32 data lengths. Decode reads the keys, those
    data bytes and the [B] int32 counts, and writes ``x``'s bytes.
    """
    B = x.shape[0]
    raw = x.numel() * x.element_size()
    stream = keys.numel() + int(data_len.sum())
    return raw + 4 * B + stream + 4 * B, stream + 4 * B + raw


def _check_copy_args(x: torch.Tensor, rows: int) -> int:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"want [R, {LANES}] int32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if rows <= 0:
        raise ValueError(f"rows {rows} out of range")
    R = x.shape[0]
    if R % rows:
        # The TPU kernel's grid of R // rows blocks left the last R % rows
        # rows unwritten; the port refuses the shape instead.
        raise ValueError(f"{R} rows are not a multiple of the block's "
                         f"{rows}")
    return R // rows


def copy_blocked_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`copy_blocked`."""
    return x.clone()


def copy_blocked(x: torch.Tensor, rows: int = 8192) -> torch.Tensor:
    """Copy a contiguous [R, 128] int32 tensor in tiles of (rows, 128); R
    must be a multiple of ``rows``. Kernel CP on CUDA, the plain version on
    the CPU."""
    tiles = _check_copy_args(x, rows)
    if _rows.on_cpu(x, "blocked copy"):
        return copy_blocked_plain(x)
    if not x.is_contiguous():
        raise ValueError("copy_blocked wants a contiguous tensor")
    out = torch.empty_like(x)
    if tiles == 0:
        return out
    from ..ops import _build

    _rows.launch(_build.lib("copy").vbz_copy_blocked, "blocked copy", x, out,
                 tiles, rows)
    global COPY_LAUNCHES
    COPY_LAUNCHES += 1
    return out


def measure_copy_gbps(mib: int = 256, rows: int = 8192) -> float:
    """Bandwidth (GB/s, read and write both counted) that kernel CP reaches
    on the card: COPY_LAUNCHES_TIMED copies of a ``mib`` MiB array between
    two CUDA events, best of COPY_REPEATS such runs, after one checked
    copy.

    256 MiB is more than 5x the H100's 50 MB L2, so the copy streams from
    and to device memory rather than the cache. Raises without a card: the
    number is a device metric.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("measure_copy_gbps needs a CUDA card")
    n = mib * (1 << 20) // 4
    x = torch.arange(n, dtype=torch.int32, device="cuda").view(-1, LANES)
    if not torch.equal(copy_blocked(x, rows), x):
        raise RuntimeError("kernel CP's copy differs from its input")
    ms = profiling.warm_ms(lambda: copy_blocked(x, rows), COPY_LAUNCHES_TIMED,
                           COPY_REPEATS)
    return 2 * x.numel() * 4 / (ms / 1e3) / 1e9
