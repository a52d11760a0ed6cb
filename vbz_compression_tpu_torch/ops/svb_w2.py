"""W2 StreamVByte rows: delta + zig-zag + 1-2 byte packing, batched.

The counterpart of the TPU kernels that carry the zz16/zz8 W2 flavors
(``vbz_compression_tpu.ops.pallas_codec5`` encode/decode ``_w2``,
``_w2_general`` and ``_w2_rows_flat``; ``pallas_dense`` ``encode_w2_dense`` /
``decode_w2_dense``; the W2 half of ``pallas_codec3``). The TPU needed six
kernels for two functions because Mosaic has no gather or scatter: byte
compaction became a routing network whose depth depended on the content, so
compact, dense and small-chunk regimes each got a kernel. On Hopper one
encode kernel (E) and one decode kernel (D), ``csrc/w2_codec.cu``, cover
every content regime and every row length.

What bounds them is bytes: 2 read per int16 value, and 0.25 key bytes plus
1-2 data bytes written (about 1.25-2.25 per value; zz8 reads 1), or the
reverse for decode. There is no arithmetic to speak of. So each is one
launch in which every byte crosses device memory once: a block owns a tile
of 4096 values (16 per thread: one 32-bit key word and two 16-byte vectors
of int16), takes it from an atomic ticket, and gets the row's byte offset
(and, in decode, the un-delta sum) of the tiles before it by a decoupled
look-back over per-tile status words (``csrc/lookback.cuh``), where the TPU
kernels carried both from one grid step to the next in SMEM. The tile's data
span is staged in shared memory and moves as 16-byte vectors, and tiles past
a row's length do no work beyond zero keys or zero output. The tile size
gives each thread whole words of keys and output, keeps the staged span
under 8 KB so that eight blocks share an SM, and pays one look-back per 8 KB
of int16. The wrapper zeroes the look-back state (one fill) before each
launch; for the stream decoder the C entry point does (below). On the H100
the kernels reach a fraction of the byte bound: each tile's steps depend on
one another, so its loads are in flight for only part of its life
(``PERF.md``).

Layouts (B rows, N values per row, N % 4 == 0):
    encode_w2_rows(x [B,N] i16|i8, lens [B] i32)
        -> keys [B, N/4] u8, data [B, 2N] u8, data_len [B] i32
    decode_w2_rows(keys [B, N/4] u8, data [B, D] u8, counts [B] i32)
        -> [B, N] i16|i8
    decode_w2_streams(streams [B,M] u8, counts [B] i32, stream_lens [B],
                      out_n) -> [B, out_n] i16|i8, ok [B] bool
Values at or past a row's length take code 0 and no data bytes, and decode
to 0. ``data[b, data_len[b]:]`` is unspecified. Decode never reads past
``data``'s row, whatever the keys say.

``decode_w2_streams`` takes the wire plane's layout, v0 streams of key bytes
and then data bytes a row (``parallel.sharded``), and gives what the row
decode gives on the sections that :func:`._rows.stream_sections` cuts from
them, with each row's ``ok`` (:func:`._rows.stream_ok`). On the card D reads
each row where it lies, and sums each row's code + 1 for ``ok``, so the call
is two allocations (values and ``ok``) and one C call, which zeroes the
look-back state and launches D on the same stream. That state is one buffer
a device and stream (:func:`stream_scratch`), kept between calls, grown
when a call needs more and counted in ``STREAM_SCRATCH_GROWN``.

On a CUDA tensor each function launches its kernel (and counts the launch in
``ENCODE_LAUNCHES`` / ``DECODE_LAUNCHES`` / ``DECODE_STREAM_LAUNCHES``); on a
CPU tensor it runs the plain PyTorch version in this module. Any other device
raises.
"""

from __future__ import annotations

import functools
import threading

import torch

from . import _build, _rows

FLAVOR_DTYPES = {"zz16": torch.int16, "zz8": torch.int8}

# Kernel launches, one per wrapper call that reached the card.
ENCODE_LAUNCHES = 0
DECODE_LAUNCHES = 0
DECODE_STREAM_LAUNCHES = 0

# Look-back buffers of the stream decoder allocated or grown.
STREAM_SCRATCH_GROWN = 0

_MAX_N = 1 << 29   # keeps every in-row byte offset (< 2N) in an int32
# keeps a stream row's data end (key length + 4 out_n) below 2^31 - 1
_MAX_STREAM_N = 1 << 28

# (device index, raw stream) -> the stream decoder's look-back buffer.
_STREAM_SCRATCH: dict = {}
_STREAM_SCRATCH_LOCK = threading.Lock()


def _dtype(flavor: str) -> torch.dtype:
    if flavor not in FLAVOR_DTYPES:
        raise ValueError(f"flavor {flavor!r} is not a W2 flavor "
                         f"{tuple(FLAVOR_DTYPES)}")
    return FLAVOR_DTYPES[flavor]


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def encode_w2_rows_plain(x: torch.Tensor, lens: torch.Tensor, flavor: str):
    """Plain PyTorch encode (any device); same contract as the kernel."""
    B, N = x.shape
    xi = x.to(torch.int32)
    d = torch.diff(xi, dim=1, prepend=torch.zeros_like(xi[:, :1]))
    if flavor == "zz16":
        d = d & 0xFFFF                       # 16-bit wrapped delta
        v = ((d << 1) & 0xFFFF) ^ ((d >> 15) * 0xFFFF)
    else:
        v = (d << 1) ^ (d >> 31)             # 32-bit delta: v <= 510
    valid = _rows.valid_mask(lens, N)
    code = ((v > 0xFF) & valid).to(torch.int32)
    off, data_len = _rows.row_ends((1 + code) * valid)
    spill = 2 * N  # scatter target of masked-out bytes, dropped below
    data = torch.zeros(B, 2 * N + 1, dtype=torch.uint8, device=x.device)
    data.scatter_(1, torch.where(valid, off, spill),
                  (v & 0xFF).to(torch.uint8))
    data.scatter_(1, torch.where(code.bool(), off + 1, spill),
                  (v >> 8).to(torch.uint8))
    return (_rows.pack_keys(code), data[:, :spill].contiguous(),
            data_len.to(torch.int32))


def encode_w2_rows(x: torch.Tensor, lens: torch.Tensor, flavor: str):
    """W2 encode of each row's first ``lens[b]`` values; see the module
    docstring for the layouts. Kernel E on CUDA, the plain version on CPU."""
    B, N = _rows.check_encode_args(x, _dtype(flavor), lens)
    if _rows.on_cpu(x, "W2 encode"):
        return encode_w2_rows_plain(x, lens, flavor)
    _rows.check_kernel_args(B, N, _MAX_N, x, lens)
    keys = torch.empty(B, N // 4, dtype=torch.uint8, device=x.device)
    data = torch.empty(B, 2 * N, dtype=torch.uint8, device=x.device)
    if B == 0 or N == 0:
        return keys, data, torch.zeros(B, dtype=torch.int32, device=x.device)
    data_len = torch.empty(B, dtype=torch.int32, device=x.device)
    lib = _build.lib("w2")
    scratch = _rows.lookback_scratch(lib.vbz_w2_tile(), B, N, 1,
                                     x.device)
    _rows.launch(lib.vbz_w2_encode, "W2 encode", x, lens, keys, data,
                 data_len, scratch, B, N, x.element_size())
    global ENCODE_LAUNCHES
    ENCODE_LAUNCHES += 1
    return keys, data, data_len


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_w2_rows_plain(keys: torch.Tensor, data: torch.Tensor,
                         counts: torch.Tensor, flavor: str) -> torch.Tensor:
    """Plain PyTorch decode (any device); same contract as the kernel."""
    code = _rows.unpack_keys(keys)
    N = code.shape[1]
    D = data.shape[1]
    valid = _rows.valid_mask(counts, N)
    two = (code != 0) & valid
    off, _ = _rows.row_ends(valid.to(torch.int32) + two)
    padded = torch.nn.functional.pad(data, (0, 1))  # column D reads as 0

    def byte_at(pos, want):
        idx = torch.where(want & (pos < D), pos, D)
        return torch.gather(padded, 1, idx).to(torch.int32)

    v = byte_at(off, valid) | (byte_at(off + 1, two) << 8)
    total = torch.cumsum((v >> 1) ^ -(v & 1), dim=1)  # un-zig-zag, un-delta
    bits = 16 if flavor == "zz16" else 8
    half = 1 << (bits - 1)
    out = ((total & ((1 << bits) - 1)) ^ half) - half
    return torch.where(valid, out, 0).to(FLAVOR_DTYPES[flavor])


def decode_w2_rows(keys: torch.Tensor, data: torch.Tensor,
                   counts: torch.Tensor, flavor: str) -> torch.Tensor:
    """W2 decode of each row's first ``counts[b]`` values; see the module
    docstring for the layouts. Kernel D on CUDA, the plain version on CPU."""
    dtype = _dtype(flavor)
    B = _rows.check_decode_args(keys, data, counts)
    if _rows.on_cpu(keys, "W2 decode"):
        return decode_w2_rows_plain(keys, data, counts, flavor)
    N, D = 4 * keys.shape[1], data.shape[1]
    _rows.check_kernel_args(B, N, _MAX_N, keys, data, counts)
    if D >= 1 << 31:
        raise ValueError(f"data row of {D} bytes exceeds the kernel's int32")
    out = torch.empty(B, N, dtype=dtype, device=keys.device)
    if B == 0 or N == 0:
        return out
    lib = _build.lib("w2")
    scratch = _rows.lookback_scratch(lib.vbz_w2_tile(), B, N, 2,
                                     keys.device)
    _rows.launch(lib.vbz_w2_decode, "W2 decode", keys, data, counts, out,
                 scratch, B, N, D, out.element_size())
    global DECODE_LAUNCHES
    DECODE_LAUNCHES += 1
    return out


def decode_w2_streams_plain(streams: torch.Tensor, counts: torch.Tensor,
                            stream_lens: torch.Tensor, out_n: int,
                            flavor: str):
    """Plain PyTorch decode of v0 stream rows (any device): the sections,
    the plain row decode, and ``ok``; same contract as the kernel."""
    keys, data, kl = _rows.stream_sections(streams, counts, out_n)
    return (decode_w2_rows_plain(keys, data, counts, flavor),
            _rows.stream_ok(keys, counts, kl, stream_lens))


@functools.cache
def _tile() -> int:
    return _build.lib("w2").vbz_w2_tile()


def stream_scratch(key, words: int, device) -> torch.Tensor:
    """The stream decoder's look-back buffer for ``key`` (a device index and
    a raw stream): int64, at least ``words`` long, in any state. The one
    held for the key while it is large enough; else a new one of the next
    power of two, held from then on and counted in ``STREAM_SCRATCH_GROWN``.
    Each launch zeroes the words it uses on the key's stream before it
    starts, so stream order keeps one call's state from the next."""
    buf = _STREAM_SCRATCH.get(key)
    if buf is not None and buf.numel() >= words:
        return buf
    global STREAM_SCRATCH_GROWN
    with _STREAM_SCRATCH_LOCK:
        buf = _STREAM_SCRATCH.get(key)
        if buf is None or buf.numel() < words:
            buf = torch.empty(1 << (words - 1).bit_length(),
                              dtype=torch.int64, device=device)
            _STREAM_SCRATCH[key] = buf
            STREAM_SCRATCH_GROWN += 1
    return buf


def decode_w2_streams(streams: torch.Tensor, counts: torch.Tensor,
                      stream_lens: torch.Tensor, out_n: int, flavor: str):
    """W2 decode of v0 stream rows [B, M], ``counts[b]`` values each into
    [B, out_n], and each row's ``ok``; see the module docstring. Kernel D
    on the rows in place on CUDA, the plain version on CPU."""
    # The plane's enqueue: every tensor's metadata is read once.
    dtype = _dtype(flavor)
    if streams.dtype != torch.uint8 or streams.dim() != 2:
        raise ValueError(f"streams: want 2-D {torch.uint8}, got "
                         f"{streams.dim()}-D {streams.dtype}")
    B, M = streams.shape
    device = streams.device
    if counts.dtype != torch.int32 or counts.shape != (B,):
        raise ValueError(f"counts: want int32 [{B}], got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if counts.device != device:
        raise ValueError(f"counts is on {counts.device}, data on {device}")
    if stream_lens.shape != (B,) or stream_lens.device != device:
        raise ValueError(f"stream_lens {tuple(stream_lens.shape)} on "
                         f"{stream_lens.device} does not match streams "
                         f"{(B, M)} on {device}")
    if out_n % 4:
        raise ValueError(f"out_n={out_n} is not a multiple of 4")
    if device.type == "cpu":
        return decode_w2_streams_plain(streams, counts, stream_lens, out_n,
                                       flavor)
    if device.type != "cuda":
        raise ValueError(f"no W2 stream decode for device {device}")
    if out_n > _MAX_STREAM_N or B > _rows.MAX_B:
        raise ValueError(f"batch [{B}, {out_n}] exceeds the kernel's "
                         f"[{_rows.MAX_B}, {_MAX_STREAM_N}]")
    if not (streams.is_contiguous() and counts.is_contiguous()):
        raise ValueError("kernel arguments must be contiguous")
    if M >= 1 << 31:
        raise ValueError(f"stream row of {M} bytes exceeds the kernel's "
                         "int32")
    out = torch.empty(B, out_n, dtype=dtype, device=device)
    if B == 0 or out_n == 0:
        # No tile to launch: the keys hold no live value, so each row's data
        # end is its key length.
        kl = ((counts + 3) // 4).to(torch.int64)
        return out, (kl == stream_lens) & (kl <= stream_lens)
    if stream_lens.dtype != torch.int32:
        # A data end stays below 2^31 - 1 (out_n <= _MAX_STREAM_N), so a
        # length outside int32 is ok nowhere, as its clamped one.
        stream_lens = stream_lens.clamp(-1, (1 << 31) - 1).to(torch.int32)
    ok = torch.empty(B, dtype=torch.bool, device=device)
    index = device.index
    scratch = stream_scratch(
        (index, torch._C._cuda_getCurrentRawStream(index)),
        1 + (2 * -(-out_n // _tile()) + 1) * B, device)
    _rows.launch(_build.lib("w2").vbz_w2_decode_streams, "W2 stream decode",
                 streams, counts, stream_lens.contiguous(), out, ok, scratch,
                 scratch.numel(), B, out_n, M, out.element_size())
    global DECODE_STREAM_LAUNCHES
    DECODE_STREAM_LAUNCHES += 1
    return out, ok
