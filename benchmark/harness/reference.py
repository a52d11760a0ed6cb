"""The plain reference codec: VBZ v0 with int16 zig-zag deltas, StreamVByte
packing, and an optional zstd stage, in plain PyTorch and the benchmark's
own libzstd binding. It imports nothing of the program.

Layout of a v0 stream of ``n`` int16 values (``vbz/v0/``): 16-bit wrapped
deltas from 0, 16-bit zig-zag, then ``(n+3)//4`` key bytes (2-bit codes,
first value in the low bits; code c means c+1 data bytes), then the data
bytes, little-endian. A sized frame is the raw byte count as a little-endian
uint32, then the stream, zstd-compressed where the level is not 0.

A stream is refused as the reference decoder refuses it
(``streamvbyte_validate_stream``): codes above 1 in an int16 stream, set key
bits past the last value, or a length other than the keys give, each with
``VBZ_STREAMVBYTE_STREAM_ERROR``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import reads, zstd

# vbz/vbz.h: errors at the top of the uint32 range.
VBZ_ZSTD_ERROR = 2**32 - 1
VBZ_DESTINATION_SIZE_ERROR = 2**32 - 4
VBZ_STREAMVBYTE_STREAM_ERROR = 2**32 - 5


class Refused(Exception):
    """A stream the reference refuses, with its error code."""

    def __init__(self, code: int, detail: str):
        super().__init__(f"{code}: {detail}")
        self.code = code


@dataclasses.dataclass
class Streams:
    """Every read's v0 stream, end to end in ``flat`` (uint8, on the set's
    device): read ``i`` at ``flat[starts[i]:starts[i] + lengths[i]]``."""

    flat: torch.Tensor
    starts: np.ndarray
    lengths: np.ndarray

    def host(self) -> list[bytes]:
        buf = self.flat.cpu().numpy()
        return [buf[s:s + n].tobytes()
                for s, n in zip(self.starts, self.lengths)]


def zigzag16(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Zig-zag of the 16-bit wrapped deltas of int16 ``x`` (flat), each
    read starting from 0 at the flags ``first``; int32 in [0, 65535]."""
    xi = x.to(torch.int32)
    prev = torch.zeros_like(xi)
    prev[1:] = xi[:-1]
    prev[first] = 0
    d = (xi - prev) & 0xFFFF
    return ((d << 1) & 0xFFFF) ^ ((d >> 15) * 0xFFFF)


def _piece_codes(values: torch.Tensor, lens: torch.Tensor):
    """The zig-zag values and codes (1: two bytes) of reads laid end to end
    in ``values``, ``lens`` samples each; each value's read and its read's
    start in ``values``."""
    R = len(lens)
    read_of = torch.repeat_interleave(torch.arange(R, device=lens.device),
                                      lens)
    st = torch.cumsum(lens, 0) - lens
    first = torch.zeros(values.numel(), dtype=torch.bool, device=lens.device)
    first[st[lens > 0]] = True
    v = zigzag16(values, first)
    return v, (v > 0xFF).to(torch.int64), read_of, st


def encode(values: torch.Tensor, starts: np.ndarray, lengths: np.ndarray,
           piece: int = reads.PIECE) -> Streams:
    """The v0 zig-zag int16 stream of every read of a flat set (reads end
    to end in their order), worked out in pieces of whole reads of at most
    ``piece`` samples (a longer read alone) and written into one flat
    buffer: the same bytes, starts and lengths for any ``piece``."""
    device = values.device
    parts = [(r0, r1, int(starts[r0]), int(starts[r1 - 1] + lengths[r1 - 1]))
             for r0, r1 in reads.pieces(lengths, piece)]
    lens = torch.from_numpy(lengths).to(device)
    two = torch.zeros(len(lengths), dtype=torch.int64, device=device)
    for r0, r1, a, b in parts:
        _, code, read_of, _ = _piece_codes(values[a:b], lens[r0:r1])
        two[r0:r1].index_add_(0, read_of, code)
    key_lens = (lens + 3) // 4
    stream_lens = key_lens + lens + two
    s_start = torch.cumsum(stream_lens, 0) - stream_lens
    out = Streams(flat=torch.empty(int(stream_lens.sum()), dtype=torch.uint8,
                                   device=device),
                  starts=s_start.cpu().numpy(),
                  lengths=stream_lens.cpu().numpy())
    for r0, r1, a, b in parts:
        v, code, read_of, st = _piece_codes(values[a:b], lens[r0:r1])
        at = s_start[r0:r1] - s_start[r0]
        p = torch.arange(b - a, device=device) - st[read_of]
        s0 = int(out.starts[r0])
        s1 = int(out.starts[r1 - 1] + out.lengths[r1 - 1])
        buf = torch.zeros(s1 - s0, dtype=torch.int64, device=device)
        buf.index_add_(0, at[read_of] + p // 4, code << (2 * (p % 4)))
        sizes = 1 + code
        ends = torch.cumsum(sizes, 0)
        base = (ends - sizes)[st.clamp(max=max(b - a - 1, 0))]
        off = ends - sizes - base[read_of]
        dpos = at[read_of] + key_lens[r0:r1][read_of] + off
        buf[dpos] = (v & 0xFF).to(torch.int64)
        hi = code.bool()
        buf[dpos[hi] + 1] = (v[hi] >> 8).to(torch.int64)
        out.flat[s0:s1] = buf
    return out


def key_codes(keys: torch.Tensor) -> torch.Tensor:
    """Key bytes -> their 2-bit codes, first value in the low bits."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32,
                          device=keys.device)
    return ((keys.to(torch.int32)[:, None] >> shifts) & 3).reshape(-1)


def validate(stream: torch.Tensor, count: int) -> None:
    """Raise ``Refused`` where the reference decoder refuses the
    int16 v0 stream of ``count`` values."""
    size = stream.numel()
    if count == 0 or size == 0:
        if size != count:
            raise Refused(VBZ_STREAMVBYTE_STREAM_ERROR,
                                  "empty stream mismatch")
        return
    key_len = (count + 3) // 4
    if size < key_len:
        raise Refused(VBZ_STREAMVBYTE_STREAM_ERROR,
                              "stream too short")
    codes = key_codes(stream[:key_len])
    if bool((codes[:count] > 1).any()):
        raise Refused(VBZ_STREAMVBYTE_STREAM_ERROR,
                              "code above 1 in an int16 stream")
    if bool((codes[count:] != 0).any()):
        raise Refused(VBZ_STREAMVBYTE_STREAM_ERROR,
                              "key bits set past the last value")
    if key_len + count + int(codes[:count].sum()) != size:
        raise Refused(VBZ_STREAMVBYTE_STREAM_ERROR,
                              "length differs from the keys'")


def decode(stream: torch.Tensor, count: int) -> torch.Tensor:
    """The ``count`` int16 values of a v0 zig-zag stream (uint8 tensor),
    following its codes without validating them; bytes past the stream read
    as 0."""
    if count == 0:
        return torch.zeros(0, dtype=torch.int16, device=stream.device)
    key_len = (count + 3) // 4
    codes = key_codes(stream[:key_len])[:count].to(torch.int64)
    sizes = codes + 1
    off = key_len + torch.cumsum(sizes, 0) - sizes
    padded = torch.cat([stream.to(torch.int64),
                        torch.zeros(4, dtype=torch.int64,
                                    device=stream.device)])
    value = torch.zeros(count, dtype=torch.int64, device=stream.device)
    for k in range(4):
        at = (off + k).clamp(max=padded.numel() - 1)
        value |= torch.where(k < sizes, padded[at], 0) << (8 * k)
    v = value & 0xFFFF
    delta = (v >> 1) ^ -(v & 1)
    out = torch.cumsum(delta, 0) & 0xFFFF
    return ((out ^ 0x8000) - 0x8000).to(torch.int16)


def frames(streams: list[bytes], counts: np.ndarray, zstd_params: dict | None,
           pool=None) -> list[bytes]:
    """Sized frames of int16 streams: the raw byte count, then the stream,
    zstd-compressed with ``zstd_params`` unless that is None. ``pool`` (an
    executor) spreads the zstd calls over threads."""
    heads = [int(2 * n).to_bytes(4, "little") for n in counts]
    if zstd_params is None:
        return [h + s for h, s in zip(heads, streams)]
    mapper = map if pool is None else pool.map
    bodies = mapper(lambda s: zstd.compress(s, zstd_params), streams)
    return [h + b for h, b in zip(heads, bodies)]


def decode_frame(frame: bytes, zstd_level: int, device,
                 validating: bool = True) -> np.ndarray:
    """The int16 values of a sized frame; ``Refused`` where the
    reference refuses it. ``validating=False`` skips the stream's
    validation: the control that the read cells' checks must catch."""
    if len(frame) < 4:
        raise Refused(VBZ_DESTINATION_SIZE_ERROR, "no sized header")
    size = int.from_bytes(frame[:4], "little")
    body = frame[4:]
    if zstd_level:
        try:
            body = zstd.decompress(body)
        except zstd.ZstdError as exc:
            raise Refused(VBZ_ZSTD_ERROR, str(exc)) from None
    if size % 2:
        raise Refused(VBZ_DESTINATION_SIZE_ERROR,
                              f"{size} bytes is no whole int16 count")
    stream = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(device)
    if validating:
        validate(stream, size // 2)
    return decode(stream, size // 2).cpu().numpy()
