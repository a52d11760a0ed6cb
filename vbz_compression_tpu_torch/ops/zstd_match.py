"""Bounded-offset LZ77 candidate scan for the from-scratch zstd encoder.

The counterpart of ``vbz_compression_tpu.ops.zstd_match_tpu``, whose
``match_candidates`` (:37) is a jitted ``jnp`` function of shifted compares
on the TPU. The match finder is recast as compare-at-bounded-offsets: for a
fixed offset list O, ``match4_o[i] = buf[i..i+4) == buf[i-o..i-o+4)``, with
no hash tables. The host's greedy assembler
(:func:`.zstd_seq.find_sequences`) extends every accepted candidate to its
true length from the buffer, so the scan only certifies that a 4-byte match
exists at offset o.

Kernel M (``csrc/match_scan.cu``) computes the scan in two widths, one
wrapper each, with a plain version beside each:

- :func:`match_candidates`: int32, the offset (the JAX function's result);
  N bytes read and 4N written;
- :func:`match_index`: uint8, the offset's place in the list plus one (0
  for none); N read and N written. :func:`build_match_index_device`, the
  zstd stage's scan, takes this one and copies N bytes back, not 4N.

On a CUDA tensor a wrapper launches M and adds one to its ``LAUNCHES``
entry; on a CPU tensor it runs its plain version; any other device raises.

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
MAX_OFFSETS = 255  # offsets one launch of M takes (csrc/match_scan.cu)

# Kernel launches of each width, one per wrapper call that reached the card.
LAUNCHES = {"match_scan": 0, "match_index": 0}
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


def match_index_plain(buf: torch.Tensor,
                      offsets: tuple = DEFAULT_OFFSETS) -> torch.Tensor:
    """Plain PyTorch index scan (any device): uint8 [N], the place in
    ``offsets`` (plus one) of the offset :func:`match_candidates_plain`
    gives, the first place where the list repeats it; 0 where that is 0."""
    probed = _probed(_check(buf, offsets), buf.shape[0])
    if len(probed) > MAX_OFFSETS:
        raise ValueError(f"{len(probed)} offsets: a uint8 index holds at "
                         f"most {MAX_OFFSETS}")
    off = match_candidates_plain(buf, offsets)
    place = torch.zeros(max(probed, default=0) + 1, dtype=torch.uint8,
                        device=buf.device)
    for k in range(len(probed) - 1, -1, -1):
        place[probed[k]] = k + 1
    return place[off.long()]


def _scan(buf: torch.Tensor, offsets, dtype: torch.dtype, entry: str,
          key: str, plain) -> torch.Tensor:
    """Kernel M through ``entry`` on a CUDA tensor (on the calling thread's
    current stream), ``plain`` on a CPU tensor."""
    offsets = _check(buf, offsets)
    n = buf.shape[0]
    probed = _probed(offsets, n)
    if len(probed) > MAX_OFFSETS:
        raise ValueError(f"{len(probed)} offsets: kernel M takes at most "
                         f"{MAX_OFFSETS}")
    if _rows.on_cpu(buf, "match scan"):
        return plain(buf, offsets)
    out = torch.empty(n, dtype=dtype, device=buf.device)
    if n == 0:
        return out
    if not buf.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    host = np.array(probed, dtype=np.int32)
    from . import _build

    _rows.launch(getattr(_build.lib("match"), entry), "match scan", buf, out,
                 n, host.ctypes.data, host.size)
    with _LOCK:
        LAUNCHES[key] += 1
    return out


def match_candidates(buf: torch.Tensor,
                     offsets: tuple = DEFAULT_OFFSETS) -> torch.Tensor:
    """The scan of :func:`match_candidates_plain`, int32 offsets: kernel M
    on a CUDA tensor, the plain version on a CPU tensor. At most
    ``MAX_OFFSETS`` offsets are probed, on either."""
    return _scan(buf, offsets, torch.int32, "vbz_match_candidates",
                 "match_scan", match_candidates_plain)


def match_index(buf: torch.Tensor,
                offsets: tuple = DEFAULT_OFFSETS) -> torch.Tensor:
    """The scan of :func:`match_index_plain`, uint8 places in the list:
    kernel M on a CUDA tensor, the plain version on a CPU tensor. At most
    ``MAX_OFFSETS`` offsets are probed, on either."""
    return _scan(buf, offsets, torch.uint8, "vbz_match_index", "match_index",
                 match_index_plain)


def build_match_index_device(buf: np.ndarray,
                             offsets: tuple = DEFAULT_OFFSETS,
                             device="cuda"):
    """The counterpart of ``build_match_index_tpu``, a drop-in for
    :func:`.zstd_seq.build_match_index`: the index scan on ``device``
    (kernel M on a CUDA device, the plain version on the CPU), whose uint8
    places map back to offsets on the host. Returns ``(prev, v4)``:
    ``prev[i]`` the nearest bounded-offset source (-1 when none) and ``v4``
    the 4-byte windows the host greedy verifies with."""
    n = buf.size
    if n < MIN_MATCH:
        return np.zeros(0, np.int64), np.zeros(0, np.uint32)
    # A copy: the payload comes from np.frombuffer(bytes), which is
    # read-only, at any offset.
    src = torch.from_numpy(np.array(buf, dtype=np.uint8))
    probed = _probed(tuple(int(o) for o in offsets), n)
    index = match_index(src.to(device), offsets).cpu().numpy()
    off = np.array((0,) + probed, dtype=np.int64)[index[: n - 3]]
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
