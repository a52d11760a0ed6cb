"""PyTorch codec backend: the StreamVByte stage on the W2 kernels.

The counterpart of ``vbz_compression_tpu.models.codec.PallasSvbBackend``,
with the same four methods, so the JAX package's pipeline functions
(``vbz_compression_tpu.api``) run the port when handed a
:class:`TorchSvbBackend` as ``backend=``. The host keeps what the JAX
backend keeps: input typing, stream validation with the same ``VbzError``
codes, and the trim of each row's output to the exact wire length.

A batch call puts all of its chunks into one padded ``[B, Nmax]`` tensor with
per-row lengths, so one launch sequence per direction serves the whole call.

Flavors: zz16 (int16, zig-zag; v1 at width 2 is v0) and zz8 (v0 int8,
zig-zag). The W4 flavors and v1 int8 are not ported yet and raise
``NotImplementedError``; there is no fallback to another backend.
"""

from __future__ import annotations

import numpy as np
import torch

from vbz_compression_tpu.errors import (
    VBZ_INPUT_SIZE_ERROR,
    VBZ_INTEGER_SIZE_ERROR,
    VBZ_STREAMVBYTE_STREAM_ERROR,
    VbzError,
)
from vbz_compression_tpu.ops import scalar

from ..ops import svb_w2

_NUMPY_DTYPES = {"zz16": np.int16, "zz8": np.int8}
_SIGNED_FOR_SIZE = {1: np.int8, 2: np.int16, 4: np.int32}


def _w2_flavor(integer_size: int, use_zigzag: bool, version: int) -> str:
    """The W2 flavor of an option set, or raise for what is not ported."""
    if integer_size not in _SIGNED_FOR_SIZE:
        raise VbzError(VBZ_INTEGER_SIZE_ERROR, f"integer_size={integer_size}")
    if use_zigzag and integer_size == 2:
        return "zz16"
    if integer_size == 1 and version == 1:
        raise NotImplementedError(
            "v1 int8 half-byte streams are not ported yet "
            "(ROADMAP Queue 2, pallas_v1 encode_v1/decode_v1)")
    if use_zigzag and integer_size == 1:
        return "zz8"
    raise NotImplementedError(
        f"W4 flavor (integer_size={integer_size}, zigzag={use_zigzag}) is not "
        "ported yet (ROADMAP Queue 2, pallas_w4 encode_w4_dense/decode_w4_dense)")


def _typed_input(data, integer_size: int) -> np.ndarray:
    raw = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data).view(np.uint8).ravel()
    if raw.size % integer_size != 0:
        raise VbzError(VBZ_INPUT_SIZE_ERROR,
                       f"{raw.size} % {integer_size} != 0")
    return raw.view(_SIGNED_FOR_SIZE[integer_size])


def _as_u8(stream) -> np.ndarray:
    return np.frombuffer(bytes(stream), dtype=np.uint8) if not isinstance(
        stream, np.ndarray) else stream.astype(np.uint8, copy=False)


def _is_empty(buf: np.ndarray, count: int) -> bool:
    """Empty-stream rule: zero values need zero bytes, and only then."""
    if count == 0 or buf.size == 0:
        if buf.size != count:
            raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "empty stream mismatch")
        return True
    return False


def _check_w2_stream(buf: np.ndarray, count: int) -> int:
    """Validate a non-empty W2 stream the way the reference decoder does
    (``streamvbyte_validate_stream``); returns its key length."""
    key_len = (count + 3) // 4
    if buf.size < key_len:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "stream too short")
    codes = scalar.unpack_keys(buf[:key_len], 4 * key_len)
    if (codes[:count] > 1).any():
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "invalid code for width")
    if (codes[count:] != 0).any():
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR,
                       "nonzero trailing key bits")
    if key_len + count + int(codes[:count].sum()) != buf.size:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "stream length mismatch")
    return key_len


def _split(flat: np.ndarray, sizes: list[int]) -> list[np.ndarray]:
    return np.split(flat, np.cumsum(sizes)[:-1]) if sizes else []


class TorchSvbBackend:
    """StreamVByte stage on ``device``: the W2 kernels on a CUDA device, their
    plain PyTorch versions on the CPU."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    # -- encode ----------------------------------------------------------------

    def svb_compress(self, data, integer_size: int, use_zigzag: bool,
                     version: int) -> bytes:
        return self.svb_compress_batch([data], integer_size, use_zigzag,
                                       version)[0]

    def svb_compress_batch(self, arrays, integer_size: int, use_zigzag: bool,
                           version: int) -> list:
        flavor = _w2_flavor(integer_size, use_zigzag, version)
        typed = [_typed_input(a, integer_size) for a in arrays]
        live = [i for i, t in enumerate(typed) if t.size]
        out = [b""] * len(typed)
        if not live:
            return out
        rows = [typed[i] for i in live]
        x, lens = self._padded_rows(rows)
        keys, data, data_len = svb_w2.encode_w2_rows(x, lens, flavor)
        key_lens = [(r.size + 3) // 4 for r in rows]
        data_lens = data_len.tolist()
        flat = torch.cat([keys[j, :k] for j, k in enumerate(key_lens)]
                         + [data[j, :d] for j, d in enumerate(data_lens)])
        parts = _split(flat.cpu().numpy(), key_lens + data_lens)
        for j, i in enumerate(live):
            out[i] = parts[j].tobytes() + parts[len(live) + j].tobytes()
        return out

    def _padded_rows(self, rows: list[np.ndarray]):
        """One [B, Nmax] device tensor of the non-empty rows (Nmax a multiple
        of 4) and their lengths. Each row's tail is left unset: the encoder
        gives every value past lens[b] code 0 and no data bytes, which is
        what the JAX backend's tail padding (its last sample repeated) was
        for."""
        counts = [r.size for r in rows]
        width = -(-max(counts) // 4) * 4
        flat = torch.from_numpy(np.concatenate(rows)).to(self.device)
        x = torch.empty(len(rows), width, dtype=flat.dtype, device=self.device)
        start = 0
        for b, n in enumerate(counts):
            x[b, :n] = flat[start:start + n]
            start += n
        lens = torch.tensor(counts, dtype=torch.int32, device=self.device)
        return x, lens

    # -- decode ----------------------------------------------------------------

    def svb_decompress(self, stream, count: int, integer_size: int,
                       use_zigzag: bool, version: int) -> np.ndarray:
        return self.svb_decompress_batch([stream], [count], integer_size,
                                         use_zigzag, version)[0]

    def svb_decompress_batch(self, streams, counts, integer_size: int,
                             use_zigzag: bool, version: int) -> list:
        flavor = _w2_flavor(integer_size, use_zigzag, version)
        dtype = _NUMPY_DTYPES[flavor]
        bufs = [_as_u8(s) for s in streams]
        counts = [int(c) for c in counts]
        out = [np.zeros(0, dtype)] * len(bufs)
        live, key_lens = [], []
        for i, (buf, count) in enumerate(zip(bufs, counts)):
            if not _is_empty(buf, count):
                key_lens.append(_check_w2_stream(buf, count))
                live.append(i)
        if not live:
            return out
        width = -(-max(counts[i] for i in live) // 4) * 4
        B = len(live)
        flat = torch.from_numpy(np.concatenate([bufs[i] for i in live])).to(
            self.device)
        keys = torch.zeros(B, width // 4, dtype=torch.uint8, device=self.device)
        data = torch.empty(B, 2 * width, dtype=torch.uint8, device=self.device)
        start = 0
        for b, (i, k) in enumerate(zip(live, key_lens)):
            n = bufs[i].size
            keys[b, :k] = flat[start:start + k]
            data[b, :n - k] = flat[start + k:start + n]
            start += n
        cnt = torch.tensor([counts[i] for i in live], dtype=torch.int32,
                           device=self.device)
        rows = svb_w2.decode_w2_rows(keys, data, cnt, flavor)
        sizes = [counts[i] for i in live]
        flat_out = torch.cat([rows[b, :n] for b, n in enumerate(sizes)])
        for i, part in zip(live, _split(flat_out.cpu().numpy(), sizes)):
            out[i] = part
        return out
