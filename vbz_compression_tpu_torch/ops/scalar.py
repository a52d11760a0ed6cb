"""NumPy oracle for the VBZ wire formats (v0 + v1).

This module is the *semantic model* of the reference codec: a slow-but-obvious,
fully vectorized NumPy implementation of both StreamVByte wire formats. It is
the port's own copy of ``vbz_compression_tpu.ops.scalar`` (kept identical, so
the port needs nothing of the JAX package) and the oracle its CUDA kernels
are checked against; the original is validated against the reference's
golden byte vectors (``vbz/test/streamvbyte_test.cpp:203-239``,
``vbz/test/vbz_test.cpp:176-244``) and the checked-in fast5 corpora.

Wire format v0 (classic StreamVByte; reference ``vbz/v0/``):
  * key section: ``(count+3)//4`` bytes, 2 bits per value, little-endian within
    each byte; code ``c`` means the value occupies ``c+1`` data bytes.
  * data section: for each value in order, the low ``c+1`` little-endian bytes.

Wire format v1 ("half byte + zero byte"; reference ``vbz/v1/vbz_streamvbyte_impl.h``):
  * key section identical in shape; code semantics differ:
    0 → value 0, no data; 1 → one nibble (v < 16); 2 → two nibbles (v < 256);
    3 → four nibbles (low 16 bits of v).
  * data section is a nibble stream packed low-nibble-first within each byte.
  * v1 applies only to ``integer_size == 1``; widths 2 and 4 delegate to v0
    (reference: ``vbz/v1/vbz_streamvbyte.cpp:46-61,91-109``).

Delta/zig-zag width semantics (the key landmine, see SURVEY.md §7):
  * ``integer_size == 2``: deltas and zig-zag are computed with 16-bit
    wraparound, matching the x86 SSSE3 kernel that produced all shipped fast5
    bytes (reference: ``vbz/v0/vbz_streamvbyte_impl_sse3.h:434-440``). Encoded
    values therefore always fit in 2 bytes.
  * ``integer_size == 1``: inputs are sign-extended to int32 first and deltas
    taken in 32-bit, matching the generic scalar path (reference:
    ``vbz/v0/vbz_streamvbyte_impl.h:32-34``) — there is no SSE specialization
    for int8.
  * ``integer_size == 4``: 32-bit wraparound deltas (generic path).

Decode for ``integer_size == 2`` truncates each decoded uint32 to 16 bits
*before* un-zig-zag, matching the SIMD body of the reference SSE decoder
(``vbz_streamvbyte_impl_sse3.h:510-521``); well-formed streams never hit the
case where this differs from the 32-bit generic decoder.
"""

from __future__ import annotations

import numpy as np

from ..errors import (
    VBZ_DESTINATION_SIZE_ERROR,
    VBZ_INPUT_SIZE_ERROR,
    VBZ_INTEGER_SIZE_ERROR,
    VBZ_STREAMVBYTE_STREAM_ERROR,
    VbzError,
)

_SIGNED_FOR_SIZE = {1: np.int8, 2: np.int16, 4: np.int32}

# ---------------------------------------------------------------------------
# Transforms: delta + zig-zag (width-exact), widening casts
# ---------------------------------------------------------------------------


def zigzag_delta_encode(data: np.ndarray, integer_size: int) -> np.ndarray:
    """Signed input array (width = integer_size) → uint32 zig-zag delta values."""
    x = np.ascontiguousarray(data).view(_SIGNED_FOR_SIZE[integer_size])
    if integer_size == 2:
        # 16-bit wraparound deltas + 16-bit zig-zag (SSE kernel semantics).
        prev = np.empty_like(x)
        if x.size:
            prev[0] = 0
            prev[1:] = x[:-1]
        with np.errstate(over="ignore"):
            delta = (x - prev).astype(np.int16)
            zz = ((delta.astype(np.uint16) << np.uint16(1))
                  ^ (delta >> np.int16(15)).astype(np.uint16))
        return zz.astype(np.uint32)
    # Generic path: widen to int32, 32-bit deltas.
    x32 = x.astype(np.int32)
    prev = np.empty_like(x32)
    if x32.size:
        prev[0] = 0
        prev[1:] = x32[:-1]
    with np.errstate(over="ignore"):
        delta = x32 - prev
        zz = ((delta.astype(np.uint32) << np.uint32(1))
              ^ (delta >> np.int32(31)).astype(np.uint32))
    return zz


def zigzag_delta_decode(values: np.ndarray, integer_size: int) -> np.ndarray:
    """uint32 zig-zag delta values → signed array of width integer_size."""
    v = values.astype(np.uint32)
    if integer_size == 2:
        v16 = v.astype(np.uint16)  # truncate-first (SSE decoder semantics)
        with np.errstate(over="ignore"):
            delta = ((v16 >> np.uint16(1)) ^ (-(v16 & np.uint16(1)).astype(np.int16))
                     .astype(np.uint16)).astype(np.int16)
            out = np.cumsum(delta.astype(np.uint16), dtype=np.uint16)
        return out.astype(np.int16)
    with np.errstate(over="ignore"):
        delta = ((v >> np.uint32(1))
                 ^ (-(v & np.uint32(1)).astype(np.int32)).astype(np.uint32))
        out = np.cumsum(delta, dtype=np.uint32).astype(np.int32)
    return out.astype(_SIGNED_FOR_SIZE[integer_size])


def widen_values(data: np.ndarray, integer_size: int) -> np.ndarray:
    """No-zig-zag path: sign-extend the signed view to 32 bits, reinterpret as
    uint32 (reference: ``StreamVByteWorkerV0::cast``, ``v0/impl.h:24,82-91``)."""
    x = np.ascontiguousarray(data).view(_SIGNED_FOR_SIZE[integer_size])
    return x.astype(np.int32).view(np.uint32).copy()


def narrow_values(values: np.ndarray, integer_size: int) -> np.ndarray:
    """uint32 values → signed output of the given width (modular narrowing)."""
    dt = _SIGNED_FOR_SIZE[integer_size]
    if integer_size == 1:
        return values.astype(np.uint8).view(dt).copy()
    if integer_size == 2:
        return values.astype(np.uint16).view(dt).copy()
    return values.astype(np.uint32).view(dt).copy()


# ---------------------------------------------------------------------------
# Key-byte packing shared by v0 and v1
# ---------------------------------------------------------------------------


def pack_keys(codes: np.ndarray) -> np.ndarray:
    """2-bit codes → key bytes, 4 codes per byte little-endian
    (reference layout: ``sse3.h:415,454-463``)."""
    n = codes.size
    key_len = (n + 3) // 4
    padded = np.zeros(key_len * 4, dtype=np.uint8)
    padded[:n] = codes
    padded = padded.reshape(key_len, 4)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    return ((padded << shifts).sum(axis=1, dtype=np.uint32)).astype(np.uint8)


def unpack_keys(keys: np.ndarray, count: int) -> np.ndarray:
    """Key bytes → per-value 2-bit codes."""
    expanded = np.repeat(keys.astype(np.uint8), 4)
    shifts = np.tile(np.array([0, 2, 4, 6], dtype=np.uint8), keys.size)
    return ((expanded >> shifts) & np.uint8(3))[:count]


# ---------------------------------------------------------------------------
# v0: classic StreamVByte byte packing
# ---------------------------------------------------------------------------


def svb0_encode(values: np.ndarray) -> bytes:
    """uint32 values → v0 StreamVByte stream (keys then data)."""
    v = values.astype(np.uint32)
    n = v.size
    if n == 0:
        return b""
    codes = ((v > 0xFF).astype(np.uint8)
             + (v > 0xFFFF).astype(np.uint8)
             + (v > 0xFFFFFF).astype(np.uint8))
    keys = pack_keys(codes)
    lengths = codes.astype(np.int64) + 1
    le_bytes = v.reshape(-1, 1).view(np.uint8).reshape(n, 4)  # little-endian cols
    mask = np.arange(4)[None, :] < lengths[:, None]
    data = le_bytes[mask]  # row-major boolean select = in-order compaction
    return keys.tobytes() + data.tobytes()


def svb0_decode(stream: bytes | np.ndarray, count: int) -> np.ndarray:
    """v0 StreamVByte stream → uint32 values; raises on malformed streams
    (validation mirrors ``streamvbyte_validate_stream`` + the consumed-bytes
    check at ``v0/impl.h:49-67``)."""
    buf = np.frombuffer(bytes(stream), dtype=np.uint8) if not isinstance(
        stream, np.ndarray) else stream.astype(np.uint8, copy=False)
    in_count = buf.size
    if in_count == 0 or count == 0:
        if in_count != count:
            raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "empty stream mismatch")
        return np.zeros(0, dtype=np.uint32)
    key_len = (count + 3) // 4
    if key_len > in_count:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "stream shorter than keys")
    codes = unpack_keys(buf[:key_len], count)
    lengths = codes.astype(np.int64) + 1
    if int(lengths.sum()) != in_count - key_len:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "data length mismatch")
    data = buf[key_len:]
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    idx = offsets[:, None] + np.arange(4)[None, :]
    idx = np.minimum(idx, data.size - 1)
    gathered = data[idx].astype(np.uint32)
    col_mask = np.arange(4)[None, :] < lengths[:, None]
    shifts = np.uint32(8) * np.arange(4, dtype=np.uint32)[None, :]
    return ((gathered << shifts) * col_mask).sum(axis=1, dtype=np.uint32)


# ---------------------------------------------------------------------------
# v1: half-byte StreamVByte (nibble stream)
# ---------------------------------------------------------------------------

_V1_NIBBLES_FOR_CODE = np.array([0, 1, 2, 4], dtype=np.int64)


def svb1_encode(values: np.ndarray) -> bytes:
    """uint32 values → v1 half-byte stream (keys then nibble-packed data).

    Codes (reference ``v1/impl.h:112-125``): 0 → value 0; 1 → v<16 (1 nibble);
    2 → v<256 (2 nibbles); 3 → everything else (4 nibbles, low 16 bits only).
    """
    v = values.astype(np.uint32)
    n = v.size
    if n == 0:
        return b""
    codes = np.where(
        v == 0, np.uint8(0),
        np.where(v < 16, np.uint8(1), np.where(v < 256, np.uint8(2), np.uint8(3))))
    keys = pack_keys(codes)
    ncounts = _V1_NIBBLES_FOR_CODE[codes]
    # Nibbles of each value, little-endian nibble order, masked to its count.
    nib_cols = np.arange(4, dtype=np.uint32)[None, :]
    nibs = ((v[:, None] >> (nib_cols * np.uint32(4))) & np.uint32(0xF)).astype(np.uint8)
    mask = nib_cols < ncounts[:, None]
    nib_stream = nibs[mask]
    total_nibbles = nib_stream.size
    if total_nibbles % 2:
        nib_stream = np.concatenate([nib_stream, np.zeros(1, dtype=np.uint8)])
    pairs = nib_stream.reshape(-1, 2)
    data = (pairs[:, 0] | (pairs[:, 1] << np.uint8(4))).astype(np.uint8)
    return keys.tobytes() + data.tobytes()


def svb1_decode(stream: bytes | np.ndarray, count: int) -> np.ndarray:
    """v1 half-byte stream → uint32 values; validation mirrors
    ``streamvbyte_validate_stream_half`` (``v1/impl.h:183-216``)."""
    buf = np.frombuffer(bytes(stream), dtype=np.uint8) if not isinstance(
        stream, np.ndarray) else stream.astype(np.uint8, copy=False)
    in_count = buf.size
    if in_count == 0 or count == 0:
        if in_count != count:
            raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "empty stream mismatch")
        return np.zeros(0, dtype=np.uint32)
    key_len = (count + 3) // 4
    if key_len > in_count:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "stream shorter than keys")
    codes = unpack_keys(buf[:key_len], count)
    ncounts = _V1_NIBBLES_FOR_CODE[codes]
    total_nibbles = int(ncounts.sum())
    if (total_nibbles + 1) // 2 != in_count - key_len:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "data length mismatch")
    data = buf[key_len:]
    # Expand the packed bytes to a nibble stream (low nibble first).
    nib_stream = np.empty(data.size * 2, dtype=np.uint32)
    nib_stream[0::2] = data & np.uint8(0xF)
    nib_stream[1::2] = data >> np.uint8(4)
    offsets = np.concatenate([[0], np.cumsum(ncounts)[:-1]])
    idx = offsets[:, None] + np.arange(4)[None, :]
    idx = np.minimum(idx, max(nib_stream.size - 1, 0))
    gathered = nib_stream[idx] if nib_stream.size else np.zeros((count, 4), np.uint32)
    col_mask = np.arange(4)[None, :] < ncounts[:, None]
    shifts = np.uint32(4) * np.arange(4, dtype=np.uint32)[None, :]
    return ((gathered << shifts) * col_mask).sum(axis=1, dtype=np.uint32)


# ---------------------------------------------------------------------------
# Dispatch layer: the 4 exported per-version functions of the reference
# (``vbz/v0/vbz_streamvbyte.h:16-54``, ``vbz/v1/vbz_streamvbyte.h:16-54``)
# ---------------------------------------------------------------------------


def svb_max_compressed_size(integer_size: int, source_size: int) -> int:
    """Upper bound on the StreamVByte stage output
    (reference: ``v0/vbz_streamvbyte.cpp:7-18``; both versions use the classic
    bound of key bytes + 4 data bytes per value)."""
    if integer_size not in (1, 2, 4):
        raise VbzError(VBZ_INTEGER_SIZE_ERROR, f"integer_size={integer_size}")
    if source_size % integer_size != 0:
        raise VbzError(VBZ_INPUT_SIZE_ERROR,
                       f"{source_size} % {integer_size} != 0")
    count = source_size // integer_size
    return (count + 3) // 4 + count * 4


def _values_from_input(data: bytes | np.ndarray, integer_size: int,
                       use_zigzag: bool) -> np.ndarray:
    raw = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data).view(np.uint8).ravel()
    if raw.size % integer_size != 0:
        raise VbzError(VBZ_INPUT_SIZE_ERROR,
                       f"{raw.size} % {integer_size} != 0")
    typed = raw.view(_SIGNED_FOR_SIZE[integer_size])
    if use_zigzag:
        return zigzag_delta_encode(typed, integer_size)
    return widen_values(typed, integer_size)


def svb_compress(data, integer_size: int, use_zigzag: bool, version: int) -> bytes:
    """Full StreamVByte stage: transform + pack. Mirrors
    ``vbz_delta_zig_zag_streamvbyte_compress_v{0,1}``."""
    if integer_size not in (1, 2, 4):
        raise VbzError(VBZ_INTEGER_SIZE_ERROR, f"integer_size={integer_size}")
    values = _values_from_input(data, integer_size, use_zigzag)
    if version == 1 and integer_size == 1:
        return svb1_encode(values)
    return svb0_encode(values)


def svb_decompress(stream, count: int, integer_size: int, use_zigzag: bool,
                   version: int) -> np.ndarray:
    """Inverse of :func:`svb_compress`; ``count`` is the number of output
    integers. Mirrors ``vbz_delta_zig_zag_streamvbyte_decompress_v{0,1}``."""
    if integer_size not in (1, 2, 4):
        raise VbzError(VBZ_INTEGER_SIZE_ERROR, f"integer_size={integer_size}")
    if version == 1 and integer_size == 1:
        values = svb1_decode(stream, count)
    else:
        values = svb0_decode(stream, count)
    if use_zigzag:
        return zigzag_delta_decode(values, integer_size)
    return narrow_values(values, integer_size)
