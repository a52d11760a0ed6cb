"""PyTorch codec backend: the StreamVByte stage on the port's kernels.

The counterpart of ``vbz_compression_tpu.models.codec.PallasSvbBackend``,
with the same four methods, so the port's pipeline (:mod:`..api`) runs it
when handed a :class:`TorchSvbBackend` as ``backend=``. The host keeps what
the JAX backend keeps: input typing, stream validation with the same
``VbzError`` codes, and the trim of each row's output to the exact wire
length.

A batch call puts all of its chunks into one padded ``[B, Nmax]`` tensor with
per-row lengths, so one launch sequence per direction serves the whole call.

A batch call's host spans (:mod:`..utils.profiling`): ``backend.encode`` or
``backend.decode`` around it; inside, ``backend.validate`` (the streams'
bytes), ``backend.pack`` (typing, concatenation, the padded tensors and the
per-row copies' enqueue), ``backend.h2d`` and ``backend.d2h`` (each copy
and its bytes), ``backend.launch`` (the kernel wrapper's call),
``backend.gather`` (the rows' concatenation on the device) and
``backend.unpack`` (the host split into rows). While the recorder is on and
the device is a card, ``backend.wait`` synchronizes the stream just before
the first read that would wait for the card anyway, so that the wait is
its own span.

Every flavor of the v0/v1 option lattice has a kernel pair:
    W2 (``ops.svb_w2``, kernels E/D): zz16, and v0 zz8;
    W4 (``ops.svb_w4``, kernels E4/D4): zz32, none32, none16, v0 none8;
    v1 (``ops.svb_v1``, kernels V1E/V1D): v1 int8, zz8 and none8.
v1 at integer_size 2 or 4 is v0, as in the reference. There is no fallback
to another backend.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import (
    VBZ_INPUT_SIZE_ERROR,
    VBZ_INTEGER_SIZE_ERROR,
    VBZ_STREAMVBYTE_STREAM_ERROR,
    VbzError,
)
from ..ops import svb_v1, svb_w2, svb_w4
from ..utils import profiling

_SIGNED_FOR_SIZE = {1: np.int8, 2: np.int16, 4: np.int32}

# (integer_size, zigzag) -> flavor, as in the JAX backend's _PALLAS_FLAVOR.
_FLAVOR = {(2, True): "zz16", (2, False): "none16",
           (1, True): "zz8", (1, False): "none8",
           (4, True): "zz32", (4, False): "none32"}
# kind -> (encode rows, decode rows, data bytes per value at most)
_KINDS = {
    "w2": (svb_w2.encode_w2_rows, svb_w2.decode_w2_rows, 2),
    "w4": (svb_w4.encode_w4_rows, svb_w4.decode_w4_rows, 4),
    "v1": (svb_v1.encode_v1_rows, svb_v1.decode_v1_rows, 2),
}


def _route(integer_size: int, use_zigzag: bool,
           version: int) -> tuple[str, str]:
    """(kind, flavor) of an option set: "v1" for v1 int8, "w2" for the
    zig-zag widths 2 and 1, "w4" for the rest."""
    if integer_size not in _SIGNED_FOR_SIZE:
        raise VbzError(VBZ_INTEGER_SIZE_ERROR, f"integer_size={integer_size}")
    flavor = _FLAVOR[(integer_size, bool(use_zigzag))]
    if integer_size == 1 and version == 1:
        return "v1", flavor
    return ("w2" if flavor in svb_w2.FLAVOR_DTYPES else "w4"), flavor


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


def _pair_table(weights) -> np.ndarray:
    """Sum of ``weights[code]`` over the eight codes of each key-byte pair,
    indexed by the pair read as one uint16. An index below 256 is one byte
    whose partner is 0, so the same table serves a stream's odd last byte.
    int64, so that a lookup's result is summed without a cast."""
    byte = np.arange(256)
    per_byte = sum(np.asarray(weights, np.int64)[(byte >> s) & 3]
                   for s in (0, 2, 4, 6))
    return np.add.outer(per_byte, per_byte).ravel()


_CODE_SUM = _pair_table([0, 1, 2, 3])     # v0: data bytes a value, less 1
_V1_NIBBLE_SUM = _pair_table([0, 1, 2, 4])  # v1: data nibbles a value


def _check_stream(buf: np.ndarray, count: int, kind: str) -> int:
    """Validate a non-empty stream the way the reference decoder does
    (``streamvbyte_validate_stream`` and, for v1,
    ``streamvbyte_validate_stream_half``); returns its key length.

    Reads the key bytes only: W2's codes of 2 and 3 are those with their
    high bit set, the codes past ``count`` live in the last key byte, and
    the data length is one table lookup a key-byte pair, summed."""
    if count < 0:  # no stream's length matches fewer than zero values
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "stream length mismatch")
    key_len = (count + 3) // 4
    if buf.size < key_len:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "stream too short")
    keys = np.ascontiguousarray(buf[:key_len])
    last = int(keys[-1])
    live = (1 << 2 * (count % 4 or 4)) - 1  # the last key byte's live codes
    if kind == "w2" and (int(np.bitwise_or.reduce(keys[:-1]))
                         | last & live) & 0xAA:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "invalid code for width")
    if last & ~live:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR,
                       "nonzero trailing key bits")
    table = _V1_NIBBLE_SUM if kind == "v1" else _CODE_SUM
    even = key_len & ~1
    # mode="wrap": every uint16 indexes the table, so no bounds check
    total = int(np.take(table, keys[:even].view(np.uint16), mode="wrap")
                .sum()) + (int(table[last]) if key_len & 1 else 0)
    data_len = (total + 1) // 2 if kind == "v1" else count + total
    if key_len + data_len != buf.size:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "stream length mismatch")
    return key_len


def _split(flat: np.ndarray, sizes: list[int]) -> list[np.ndarray]:
    return np.split(flat, np.cumsum(sizes)[:-1]) if sizes else []


def padded_rows(rows: list[np.ndarray], device, width: int | None = None):
    """One [B, width] tensor on ``device`` of non-empty 1-D rows, and their
    lengths (int32). ``width`` is a multiple of 4 and at least the longest
    row; by default it is the longest row rounded up. The rows cross to the
    device as one copy. Each row's tail is left unset: the encoders give
    every value past lens[b] code 0 and no data bytes, which is what the JAX
    backend's tail padding (its last sample repeated) was for."""
    with profiling.span("backend.pack"):
        counts = [r.size for r in rows]
        if width is None:
            width = -(-max(counts) // 4) * 4
        host = np.concatenate(rows)
    with profiling.span("backend.h2d", host.nbytes):
        flat = torch.from_numpy(host).to(device)
    with profiling.span("backend.pack"):
        x = torch.empty(len(rows), width, dtype=flat.dtype, device=device)
        start = 0
        for b, n in enumerate(counts):
            x[b, :n] = flat[start:start + n]
            start += n
    with profiling.span("backend.h2d", 4 * len(counts)):
        lens = torch.tensor(counts, dtype=torch.int32, device=device)
    return x, lens


def _wait(device: torch.device) -> None:
    """Span ``backend.wait``: the host blocked until the card's stream is
    done. Only while the recorder is on, and only on a card: the read that
    follows would wait as long."""
    if device.type != "cuda":
        return
    with profiling.span("backend.wait") as s:
        if s:
            torch.cuda.current_stream(device).synchronize()


def wire_streams(keys: torch.Tensor, data: torch.Tensor, key_lens: list[int],
                 data_lens: list[int]) -> list[bytes]:
    """Each row's wire stream, its first ``key_lens[j]`` key bytes and then
    its first ``data_lens[j]`` data bytes, gathered on the device and copied
    to the host once."""
    with profiling.span("backend.gather"):
        flat = torch.cat([keys[j, :k] for j, k in enumerate(key_lens)]
                         + [data[j, :d] for j, d in enumerate(data_lens)])
    with profiling.span("backend.d2h", flat.numel()):
        host = flat.cpu().numpy()
    with profiling.span("backend.unpack"):
        parts = _split(host, key_lens + data_lens)
        B = len(key_lens)
        return [parts[j].tobytes() + parts[B + j].tobytes()
                for j in range(B)]


class TorchSvbBackend:
    """StreamVByte stage on ``device``: the port's kernels on a CUDA device,
    their plain PyTorch versions on the CPU."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    # -- encode ----------------------------------------------------------------

    def svb_compress(self, data, integer_size: int, use_zigzag: bool,
                     version: int) -> bytes:
        return self.svb_compress_batch([data], integer_size, use_zigzag,
                                       version)[0]

    def svb_compress_batch(self, arrays, integer_size: int, use_zigzag: bool,
                           version: int) -> list:
        with profiling.span("backend.encode"):
            return self._compress_batch(arrays, integer_size, use_zigzag,
                                        version)

    def _compress_batch(self, arrays, integer_size, use_zigzag,
                        version) -> list:
        kind, flavor = _route(integer_size, use_zigzag, version)
        with profiling.span("backend.pack"):
            typed = [_typed_input(a, integer_size) for a in arrays]
            live = [i for i, t in enumerate(typed) if t.size]
            out = [b""] * len(typed)
        if not live:
            return out
        rows = [typed[i] for i in live]
        x, lens = padded_rows(rows, self.device)
        with profiling.span("backend.launch"):
            keys, data, data_len = _KINDS[kind][0](x, lens, flavor)
        _wait(self.device)
        with profiling.span("backend.d2h", 4 * len(rows)):
            data_lens = data_len.tolist()
        streams = wire_streams(keys, data, [(r.size + 3) // 4 for r in rows],
                               data_lens)
        for i, stream in zip(live, streams):
            out[i] = stream
        return out

    # -- decode ----------------------------------------------------------------

    def svb_decompress(self, stream, count: int, integer_size: int,
                       use_zigzag: bool, version: int) -> np.ndarray:
        return self.svb_decompress_batch([stream], [count], integer_size,
                                         use_zigzag, version)[0]

    def svb_decompress_batch(self, streams, counts, integer_size: int,
                             use_zigzag: bool, version: int) -> list:
        with profiling.span("backend.decode"):
            return self._decompress_batch(streams, counts, integer_size,
                                          use_zigzag, version)

    def _decompress_batch(self, streams, counts, integer_size, use_zigzag,
                          version) -> list:
        kind, flavor = _route(integer_size, use_zigzag, version)
        _, decode, per_value = _KINDS[kind]
        dtype = _SIGNED_FOR_SIZE[integer_size]
        bufs = [_as_u8(s) for s in streams]
        counts = [int(c) for c in counts]
        out = [np.zeros(0, dtype)] * len(bufs)
        live, key_lens = [], []
        with profiling.span("backend.validate") as s:
            if s:
                s.add(sum(buf.size for buf in bufs))
            for i, (buf, count) in enumerate(zip(bufs, counts)):
                if not _is_empty(buf, count):
                    key_lens.append(_check_stream(buf, count, kind))
                    live.append(i)
        if not live:
            return out
        with profiling.span("backend.pack"):
            width = -(-max(counts[i] for i in live) // 4) * 4
            B = len(live)
            host = np.concatenate([bufs[i] for i in live])
        with profiling.span("backend.h2d", host.nbytes):
            flat = torch.from_numpy(host).to(self.device)
        with profiling.span("backend.pack"):
            keys = torch.zeros(B, width // 4, dtype=torch.uint8,
                               device=self.device)
            data = torch.empty(B, per_value * width, dtype=torch.uint8,
                               device=self.device)
            start = 0
            for b, (i, k) in enumerate(zip(live, key_lens)):
                n = bufs[i].size
                keys[b, :k] = flat[start:start + k]
                data[b, :n - k] = flat[start + k:start + n]
                start += n
        with profiling.span("backend.h2d", 4 * B):
            cnt = torch.tensor([counts[i] for i in live], dtype=torch.int32,
                               device=self.device)
        with profiling.span("backend.launch"):
            rows = decode(keys, data, cnt, flavor)
        sizes = [counts[i] for i in live]
        with profiling.span("backend.gather"):
            flat_out = torch.cat([rows[b, :n] for b, n in enumerate(sizes)])
        _wait(self.device)
        with profiling.span("backend.d2h",
                            flat_out.numel() * flat_out.element_size()):
            host_out = flat_out.cpu().numpy()
        with profiling.span("backend.unpack"):
            for i, part in zip(live, _split(host_out, sizes)):
                out[i] = part
        return out
