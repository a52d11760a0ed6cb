"""Bounded-offset LZ77 candidate scan for the from-scratch zstd encoder.

The counterpart of ``vbz_compression_tpu.ops.zstd_match_tpu``, whose
``match_candidates`` (:37) is a jitted ``jnp`` function of shifted compares
on the TPU. The match finder is recast as compare-at-bounded-offsets: for a
fixed offset list O, ``match4_o[i] = buf[i..i+4) == buf[i-o..i-o+4)``, with
no hash tables. The host's greedy assembler
(:func:`.zstd_seq.find_sequences`) extends every accepted candidate to its
true length from the buffer, so the scan only certifies that a 4-byte match
exists at offset o.

On a CUDA tensor :func:`match_candidates` launches kernel M
(``csrc/match_scan.cu``) and adds one to ``LAUNCHES``; on a CPU tensor it
runs :func:`match_candidates_plain`, which mirrors the JAX function op for
op; any other device raises. What bounds M is bytes: N read and 4N written
(the int32 map), which the host then copies back.

The input is uint8 only, where the JAX function also takes int32 (whose
values the TPU scan compares whole, not as bytes); every caller hands it
a byte buffer.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import _rows

MIN_MATCH = 4

# Offsets probed, in preference order (nearest first). Dense short range
# plus a geometric tail; svb payloads of periodic signal match mostly short.
DEFAULT_OFFSETS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 20, 24, 32, 48, 64,
                   96, 128, 192, 256, 384, 512, 768, 1024)
MAX_OFFSETS = 256  # offsets one launch of M takes (csrc/match_scan.cu)

# Kernel launches, one per wrapper call that reached the card.
LAUNCHES = 0
_LOCK = threading.Lock()  # the pipeline launches from a thread pool


def _check(buf: torch.Tensor, offsets) -> tuple:
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError(f"buf: want 1-D uint8, got {buf.dim()}-D "
                         f"{buf.dtype}")
    offsets = tuple(int(o) for o in offsets)
    if any(o < 1 for o in offsets):
        raise ValueError(f"offsets must be >= 1, got {offsets}")
    return offsets


def _probed(offsets: tuple, n: int) -> tuple:
    """The offsets the scan probes: the list up to its first ``o`` with
    ``o + MIN_MATCH > n``, as the JAX function's ``break``."""
    out = []
    for o in offsets:
        if o + MIN_MATCH > n:
            break
        out.append(o)
    return tuple(out)


def match_candidates_plain(buf: torch.Tensor,
                           offsets: tuple = DEFAULT_OFFSETS) -> torch.Tensor:
    """Plain PyTorch scan (any device); the JAX function's ops in its
    order. Returns ``off`` int32 [N]: the first offset of ``offsets`` such
    that ``buf[i:i+4] == buf[i-off:i-off+4]`` (0 when none; positions with
    i < off or i+4 > N never match)."""
    _check(buf, offsets)
    b = buf.to(torch.int32)
    N = b.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=buf.device)
    best = torch.zeros(N, dtype=torch.int32, device=buf.device)
    no = torch.zeros(2, dtype=torch.bool, device=buf.device)
    for o in _probed(tuple(offsets), N):
        # eq[i] = b[i] == b[i-o] (False for i < o)
        eq = torch.cat([torch.zeros(o, dtype=torch.bool, device=buf.device),
                        b[o:] == b[:-o]])
        # 4-byte run starting at i: eq[i] & eq[i+1] & eq[i+2] & eq[i+3]
        e2 = eq & torch.cat([eq[1:], no[:1]])
        m4 = e2 & torch.cat([e2[2:], no])
        m4 = m4 & (idx + MIN_MATCH <= N)
        best = torch.where((best == 0) & m4, o, best)
    return best


def match_candidates(buf: torch.Tensor,
                     offsets: tuple = DEFAULT_OFFSETS) -> torch.Tensor:
    """The scan of :func:`match_candidates_plain`: kernel M on a CUDA
    tensor (on the calling thread's current stream), the plain version on a
    CPU tensor. At most ``MAX_OFFSETS`` offsets are probed, on either."""
    offsets = _check(buf, offsets)
    n = buf.shape[0]
    probed = _probed(offsets, n)
    if len(probed) > MAX_OFFSETS:
        raise ValueError(f"{len(probed)} offsets: kernel M takes at most "
                         f"{MAX_OFFSETS}")
    if _rows.on_cpu(buf, "match scan"):
        return match_candidates_plain(buf, offsets)
    off = torch.empty(n, dtype=torch.int32, device=buf.device)
    if n == 0:
        return off
    if not buf.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    host = np.array(probed, dtype=np.int32)
    from . import _build

    _rows.launch(_build.lib("match").vbz_match_candidates, "match scan",
                 buf, off, n, host.ctypes.data, host.size)
    global LAUNCHES
    with _LOCK:
        LAUNCHES += 1
    return off


def build_match_index_device(buf: np.ndarray,
                             offsets: tuple = DEFAULT_OFFSETS,
                             device="cuda"):
    """The counterpart of ``build_match_index_tpu``, a drop-in for
    :func:`.zstd_seq.build_match_index`: the candidate scan on ``device``
    (kernel M on a CUDA device, the plain version on the CPU). Returns
    ``(prev, v4)``: ``prev[i]`` the nearest bounded-offset source (-1 when
    none) and ``v4`` the 4-byte windows the host greedy verifies with."""
    n = buf.size
    if n < MIN_MATCH:
        return np.zeros(0, np.int64), np.zeros(0, np.uint32)
    # A copy: the payload comes from np.frombuffer(bytes), which is
    # read-only, at any offset.
    src = torch.from_numpy(np.array(buf, dtype=np.uint8))
    off = match_candidates(src.to(device), offsets).cpu().numpy()
    off = off[: n - 3].astype(np.int64)
    pos = np.arange(n - 3, dtype=np.int64)
    prev = np.where(off > 0, pos - off, -1)
    b = buf.astype(np.uint32)
    v4 = b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)
    return prev, v4


def preload(device) -> None:
    """Build and load kernel M before threads launch it, where ``device``
    is a CUDA device; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        from . import _build

        _build.lib("match")
