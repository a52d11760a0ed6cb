"""v1 half-byte StreamVByte rows for int8 (zz8 and none8), batched.

The counterpart of the TPU kernels ``vbz_compression_tpu.ops.pallas_v1``
``encode_v1`` / ``decode_v1`` with ``nib_offsets_from_keys``: a
deletion-compaction network on the TPU (Mosaic has no scatter or gather),
run there only for chunks of at least 16384 values. On Hopper one encode
kernel (V1E) and one decode kernel (V1D), ``csrc/v1_codec.cu``, cover every
length.

Flavors: ``zz8`` (32-bit delta, then zig-zag: values <= 510) and ``none8``
(the value sign-extended to 32 bits). Each value v takes code 0 when
``v == 0``, 1 when ``v < 16``, 2 when ``v < 256`` and 3 otherwise, stored as
0, 1, 2 or 4 nibbles (code 3 keeps the low 16 bits), four codes per key byte
LSB first. The data section is the nibble stream packed low nibble first;
its byte length is ``(nibbles + 1) // 2``, an odd last nibble padded with 0.

What bounds the kernels is bytes: 1 read per input value, 0.25 key bytes
plus 0-2 data bytes written, the reverse on decode. So each is one launch
with the design of E4 and D4 (``svb_w4``): a block owns a tile of 4096
values (16 per thread: one 32-bit key word), takes it from an atomic ticket,
gets the row's nibble offset (and, in V1D for zz8, the un-delta sum) of the
tiles before it by a decoupled look-back (``csrc/lookback.cuh``), and moves
the tile's data span between device memory and shared memory with 16-byte
vectors. Neighbouring values can share a data byte (one's last nibble, the
next one's first, across threads and tiles): V1E carries the row's last
nibble through the look-back beside the offset, so each byte is written
whole by the tile that holds its high nibble, with no atomics in device
memory. The wrapper zeroes the look-back state (one fill) before each
launch.

Layouts (B rows, N values per row, N % 4 == 0):
    encode_v1_rows(x [B,N] i8, lens [B] i32)
        -> keys [B, N/4] u8, data [B, 2N] u8, data_len [B] i32 (bytes)
    decode_v1_rows(keys [B, N/4] u8, data [B, D] u8, counts [B] i32)
        -> [B, N] i8
Values at or past a row's length take code 0 and decode to 0.
``data[b, data_len[b]:]`` is unspecified. Decode never reads past
``data``'s row, whatever the keys say.

On a CUDA tensor each function launches its kernel (and counts the launch in
``ENCODE_LAUNCHES`` / ``DECODE_LAUNCHES``); on a CPU tensor it runs the plain
PyTorch version in this module. Any other device raises.
"""

from __future__ import annotations

import torch

from . import _rows

FLAVORS = ("zz8", "none8")

# Kernel launches, one per wrapper call that reached the card.
ENCODE_LAUNCHES = 0
DECODE_LAUNCHES = 0

_MAX_N = 1 << 29   # keeps every in-row nibble offset (< 4N) below 2^31


def _check_flavor(flavor: str) -> None:
    if flavor not in FLAVORS:
        raise ValueError(f"flavor {flavor!r} is not a v1 flavor {FLAVORS}")


def _nibbles(code: torch.Tensor) -> torch.Tensor:
    """Nibbles of each code: 0, 1, 2, 4."""
    return (1 << code) >> 1


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def encode_v1_rows_plain(x: torch.Tensor, lens: torch.Tensor, flavor: str):
    """Plain PyTorch encode (any device); same contract as the kernel."""
    B, N = x.shape
    xi = x.to(torch.int64)
    if flavor == "zz8":
        d = torch.diff(xi, dim=1, prepend=torch.zeros_like(xi[:, :1]))
        v = (d << 1) ^ (d >> 63)             # 32-bit delta: v <= 510
    else:
        v = xi & 0xFFFFFFFF                  # sign-extended to 32 bits
    valid = _rows.valid_mask(lens, N)
    code = torch.where(v == 0, 0, torch.where(
        v < 16, 1, torch.where(v < 256, 2, 3))) * valid
    nib = _nibbles(code)
    off, total = _rows.row_ends(nib)
    spill = 4 * N  # scatter target of masked-out nibbles, dropped below
    nibs = torch.zeros(B, 4 * N + 1, dtype=torch.uint8, device=x.device)
    for k in range(4):
        nibs.scatter_(1, torch.where(nib > k, off + k, spill),
                      ((v >> (4 * k)) & 0xF).to(torch.uint8))
    data = nibs[:, 0:spill:2] | (nibs[:, 1:spill:2] << 4)
    return (_rows.pack_keys(code), data.contiguous(),
            ((total + 1) // 2).to(torch.int32))


def encode_v1_rows(x: torch.Tensor, lens: torch.Tensor, flavor: str):
    """v1 encode of each row's first ``lens[b]`` values; see the module
    docstring for the layouts. Kernel V1E on CUDA, the plain version on
    CPU."""
    _check_flavor(flavor)
    B, N = _rows.check_encode_args(x, torch.int8, lens)
    if _rows.on_cpu(x, "v1 encode"):
        return encode_v1_rows_plain(x, lens, flavor)
    _rows.check_kernel_args(B, N, _MAX_N, x, lens)
    keys = torch.empty(B, N // 4, dtype=torch.uint8, device=x.device)
    data = torch.empty(B, 2 * N, dtype=torch.uint8, device=x.device)
    if B == 0 or N == 0:
        return keys, data, torch.zeros(B, dtype=torch.int32, device=x.device)
    data_len = torch.empty(B, dtype=torch.int32, device=x.device)
    from . import _build

    lib = _build.lib("v1")
    scratch = _rows.lookback_scratch(lib.vbz_v1_encode_tile(), B, N, 1,
                                     x.device)
    _rows.launch(lib.vbz_v1_encode, "v1 encode", x, lens, keys, data,
                 data_len, scratch, B, N, int(flavor == "zz8"))
    global ENCODE_LAUNCHES
    ENCODE_LAUNCHES += 1
    return keys, data, data_len


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_v1_rows_plain(keys: torch.Tensor, data: torch.Tensor,
                         counts: torch.Tensor, flavor: str) -> torch.Tensor:
    """Plain PyTorch decode (any device); same contract as the kernel."""
    code = _rows.unpack_keys(keys)
    B, N = code.shape
    D = data.shape[1]
    valid = _rows.valid_mask(counts, N)
    nib = _nibbles(code) * valid
    off, _ = _rows.row_ends(nib)
    # The nibble stream, low nibble first, with one 0 past its end.
    stream = torch.stack([data & 0xF, data >> 4], dim=2).view(B, 2 * D)
    padded = torch.nn.functional.pad(stream, (0, 1))
    v = torch.zeros(code.shape, dtype=torch.int64, device=keys.device)
    for k in range(4):
        pos = off + k
        idx = torch.where((nib > k) & (pos < 2 * D), pos, 2 * D)
        v |= torch.gather(padded, 1, idx).to(torch.int64) << (4 * k)
    if flavor == "zz8":
        v = torch.cumsum((v >> 1) ^ -(v & 1), dim=1)  # un-zig-zag, un-delta
    out = ((v & 0xFF) ^ 0x80) - 0x80
    return torch.where(valid, out, 0).to(torch.int8)


def decode_v1_rows(keys: torch.Tensor, data: torch.Tensor,
                   counts: torch.Tensor, flavor: str) -> torch.Tensor:
    """v1 decode of each row's first ``counts[b]`` values; see the module
    docstring for the layouts. Kernel V1D on CUDA, the plain version on
    CPU."""
    _check_flavor(flavor)
    B = _rows.check_decode_args(keys, data, counts)
    if _rows.on_cpu(keys, "v1 decode"):
        return decode_v1_rows_plain(keys, data, counts, flavor)
    N, D = 4 * keys.shape[1], data.shape[1]
    _rows.check_kernel_args(B, N, _MAX_N, keys, data, counts)
    if D >= 1 << 31:
        raise ValueError(f"data row of {D} bytes exceeds the kernel's int32")
    out = torch.empty(B, N, dtype=torch.int8, device=keys.device)
    if B == 0 or N == 0:
        return out
    from . import _build

    lib = _build.lib("v1")
    zigzag = flavor == "zz8"
    scratch = _rows.lookback_scratch(lib.vbz_v1_decode_tile(), B, N,
                                     1 + zigzag, keys.device)
    _rows.launch(lib.vbz_v1_decode, "v1 decode", keys, data, counts, out,
                 scratch, B, N, D, int(zigzag))
    global DECODE_LAUNCHES
    DECODE_LAUNCHES += 1
    return out
