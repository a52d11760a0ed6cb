"""W4 StreamVByte rows: the v0 flavors with 1-4 bytes per value, batched.

The counterpart of the TPU kernels ``vbz_compression_tpu.ops.pallas_codec3``
``encode_w4`` / ``decode_w4`` (chunks under 16384 values) and
``pallas_w4.encode_w4_dense`` / ``decode_w4_dense`` with
``byte_offsets_from_keys_w4`` (longer chunks). The TPU needed two kernel
pairs because of block-size limits and a deletion-compaction network (Mosaic
has no scatter or gather). On Hopper one encode kernel (E4) and one decode
kernel (D4), ``csrc/w4_codec.cu``, cover every length and every content.

Flavors (input dtype; what the stream stores):
    zz32    int32; 32-bit wrapped delta, then zig-zag
    none32  int32; the value as it is
    none16  int16; the value SIGN-EXTENDED to 32 bits (negative: 4 bytes)
    none8   int8;  the value SIGN-EXTENDED to 32 bits (negative: 4 bytes)
Each value v takes code ``(v>0xFF)+(v>0xFFFF)+(v>0xFFFFFF)``, four per key
byte LSB first, and its low ``code+1`` bytes, little-endian, in the data
section at the exclusive prefix sum of ``code+1``. Decode gathers them, then
un-zig-zags and runs a 32-bit wrapping sum per row (zz32) or truncates to the
output width (the none flavors).

What bounds the kernels is bytes: 1-4 read per input value, 0.25 key bytes
plus 1-4 data bytes written, the reverse on decode; there is no arithmetic
to speak of. So each is one launch in which every byte crosses device
memory once, as kernels E and D of ``svb_w2`` are: a block owns a tile of
4096 values (16 per thread: one 32-bit key word), takes it from an atomic
ticket, gets the row's byte offset (and, in D4 for zz32, the un-delta sum)
of the tiles before it by a decoupled look-back (``csrc/lookback.cuh``),
and moves the tile's data span between device memory and shared memory
with 16-byte vectors. E4 reads its input once, packs each thread's data
bytes into aligned words in registers and stages them; D4 stages the span
and writes its output once. The wrapper zeroes the look-back state (one
fill) before each launch.

Layouts (B rows, N values per row, N % 4 == 0):
    encode_w4_rows(x [B,N] i32|i16|i8, lens [B] i32)
        -> keys [B, N/4] u8, data [B, 4N] u8, data_len [B] i32
    decode_w4_rows(keys [B, N/4] u8, data [B, D] u8, counts [B] i32,
                   out=None) -> [B, N] of the flavor's dtype (``out`` when
                   given: a contiguous tensor of that shape and dtype, at
                   any storage offset)
Values at or past a row's length take code 0 and no data bytes, and decode
to 0. ``data[b, data_len[b]:]`` is unspecified. Decode never reads past
``data``'s row, whatever the keys say.

On a CUDA tensor each function launches its kernel (and counts the launch in
``ENCODE_LAUNCHES`` / ``DECODE_LAUNCHES``); on a CPU tensor it runs the plain
PyTorch version in this module. Any other device raises.
"""

from __future__ import annotations

import torch

from . import _rows

FLAVOR_DTYPES = {"zz32": torch.int32, "none32": torch.int32,
                 "none16": torch.int16, "none8": torch.int8}

# Kernel launches, one per wrapper call that reached the card.
ENCODE_LAUNCHES = 0
DECODE_LAUNCHES = 0

_MAX_N = 1 << 28   # keeps every in-row byte offset (< 4N) in an int32
_MASK32 = 0xFFFFFFFF


def _dtype(flavor: str) -> torch.dtype:
    if flavor not in FLAVOR_DTYPES:
        raise ValueError(f"flavor {flavor!r} is not a W4 flavor "
                         f"{tuple(FLAVOR_DTYPES)}")
    return FLAVOR_DTYPES[flavor]


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def encode_w4_rows_plain(x: torch.Tensor, lens: torch.Tensor, flavor: str):
    """Plain PyTorch encode (any device); same contract as the kernel."""
    B, N = x.shape
    xi = x.to(torch.int64)
    if flavor == "zz32":
        d = torch.diff(xi, dim=1, prepend=torch.zeros_like(xi[:, :1]))
        d = d & _MASK32                      # 32-bit wrapped delta
        v = ((d << 1) & _MASK32) ^ ((d >> 31) * _MASK32)
    else:
        v = xi & _MASK32                     # sign-extended to 32 bits
    valid = _rows.valid_mask(lens, N)
    code = ((v > 0xFF).to(torch.int32) + (v > 0xFFFF) + (v > 0xFFFFFF)) * valid
    off, data_len = _rows.row_ends((1 + code) * valid)
    spill = 4 * N  # scatter target of masked-out bytes, dropped below
    data = torch.zeros(B, 4 * N + 1, dtype=torch.uint8, device=x.device)
    for k in range(4):
        data.scatter_(1, torch.where(valid & (code >= k), off + k, spill),
                      ((v >> (8 * k)) & 0xFF).to(torch.uint8))
    return (_rows.pack_keys(code), data[:, :spill].contiguous(),
            data_len.to(torch.int32))


def encode_w4_rows(x: torch.Tensor, lens: torch.Tensor, flavor: str):
    """W4 encode of each row's first ``lens[b]`` values; see the module
    docstring for the layouts. Kernel E4 on CUDA, the plain version on
    CPU."""
    B, N = _rows.check_encode_args(x, _dtype(flavor), lens)
    if _rows.on_cpu(x, "W4 encode"):
        return encode_w4_rows_plain(x, lens, flavor)
    _rows.check_kernel_args(B, N, _MAX_N, x, lens)
    keys = torch.empty(B, N // 4, dtype=torch.uint8, device=x.device)
    data = torch.empty(B, 4 * N, dtype=torch.uint8, device=x.device)
    if B == 0 or N == 0:
        return keys, data, torch.zeros(B, dtype=torch.int32, device=x.device)
    data_len = torch.empty(B, dtype=torch.int32, device=x.device)
    from . import _build

    lib = _build.lib("w4")
    scratch = _rows.lookback_scratch(lib.vbz_w4_encode_tile(), B, N, 1,
                                     x.device)
    _rows.launch(lib.vbz_w4_encode, "W4 encode", x, lens, keys, data,
                 data_len, scratch, B, N, x.element_size(),
                 int(flavor == "zz32"))
    global ENCODE_LAUNCHES
    ENCODE_LAUNCHES += 1
    return keys, data, data_len


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_w4_rows_plain(keys: torch.Tensor, data: torch.Tensor,
                         counts: torch.Tensor, flavor: str) -> torch.Tensor:
    """Plain PyTorch decode (any device); same contract as the kernel."""
    code = _rows.unpack_keys(keys)
    N = code.shape[1]
    D = data.shape[1]
    valid = _rows.valid_mask(counts, N)
    off, _ = _rows.row_ends((1 + code) * valid)
    padded = torch.nn.functional.pad(data, (0, 1))  # column D reads as 0
    v = torch.zeros(code.shape, dtype=torch.int64, device=keys.device)
    for k in range(4):
        pos = off + k
        idx = torch.where(valid & (code >= k) & (pos < D), pos, D)
        v |= torch.gather(padded, 1, idx).to(torch.int64) << (8 * k)
    if flavor == "zz32":
        v = torch.cumsum((v >> 1) ^ -(v & 1), dim=1)  # un-zig-zag, un-delta
    bits = torch.iinfo(FLAVOR_DTYPES[flavor]).bits
    half = 1 << (bits - 1)
    out = ((v & ((1 << bits) - 1)) ^ half) - half
    return torch.where(valid, out, 0).to(FLAVOR_DTYPES[flavor])


def decode_w4_rows(keys: torch.Tensor, data: torch.Tensor,
                   counts: torch.Tensor, flavor: str,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """W4 decode of each row's first ``counts[b]`` values, into ``out`` when
    given; see the module docstring for the layouts. Kernel D4 on CUDA, the
    plain version on CPU."""
    dtype = _dtype(flavor)
    B = _rows.check_decode_args(keys, data, counts)
    N, D = 4 * keys.shape[1], data.shape[1]
    if out is not None and (out.dtype != dtype or tuple(out.shape) != (B, N)
                            or out.device != keys.device
                            or not out.is_contiguous()):
        raise ValueError(f"out: want contiguous {dtype} [{B}, {N}] on "
                         f"{keys.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    if _rows.on_cpu(keys, "W4 decode"):
        got = decode_w4_rows_plain(keys, data, counts, flavor)
        return got if out is None else out.copy_(got)
    _rows.check_kernel_args(B, N, _MAX_N, keys, data, counts)
    if D >= 1 << 31:
        raise ValueError(f"data row of {D} bytes exceeds the kernel's int32")
    if out is None:
        out = torch.empty(B, N, dtype=dtype, device=keys.device)
    if B == 0 or N == 0:
        return out
    from . import _build

    lib = _build.lib("w4")
    zigzag = flavor == "zz32"
    scratch = _rows.lookback_scratch(lib.vbz_w4_decode_tile(), B, N,
                                     1 + zigzag, keys.device)
    _rows.launch(lib.vbz_w4_decode, "W4 decode", keys, data, counts, out,
                 scratch, B, N, D, out.element_size(), int(zigzag))
    global DECODE_LAUNCHES
    DECODE_LAUNCHES += 1
    return out
