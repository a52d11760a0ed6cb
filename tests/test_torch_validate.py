"""The backend's stream check (``models.codec._check_stream``) against the
JAX package: an oracle copied from its host validation (every 2-bit code
expanded with ``vbz_compression_tpu.ops.scalar.unpack_keys`` and counted),
streams packed with that package's ``scalar.pack_keys``, and, on every
broken stream, ``PallasSvbBackend``'s own host checks (``_queue_decode`` for
W2 and W4, ``_v1_decompress`` for v1), which raise before any device work.
All must give the same key length, or the same ``VbzError`` code and
message, on sound and broken streams of every kind, every ``count % 4``
and odd and even key lengths; and the backend's decode must call the check
through the module global once per non-empty stream, the name
``benchmark/metrics/validate_pct.read.py`` wraps."""

import numpy as np
import pytest

from vbz_compression_tpu.errors import VbzError as JaxVbzError
from vbz_compression_tpu.models.codec import PallasSvbBackend
from vbz_compression_tpu.ops import scalar
from vbz_compression_tpu_torch import api
from vbz_compression_tpu_torch.errors import (
    VBZ_STREAMVBYTE_STREAM_ERROR,
    VbzError,
)
from vbz_compression_tpu_torch.models import codec
from vbz_compression_tpu_torch.options import CompressionOptions

KINDS = ("w2", "w4", "v1")
_MAX_CODE = {"w2": 1, "w4": 3, "v1": 3}
_V1_NIBBLES = np.array([0, 1, 2, 4], np.int64)      # v1 nibbles per code
_W4_EXTRA_BYTES = np.array([0, 1, 2, 3], np.int64)  # v0 bytes per code - 1
_JAX = PallasSvbBackend()
# kind -> the JAX backend's host validation of a non-empty stream
_JAX_CHECK = {
    "w2": lambda buf, count: _JAX._queue_decode(buf, count, 2, True),
    "w4": lambda buf, count: _JAX._queue_decode(buf, count, 4, True),
    "v1": lambda buf, count: _JAX._v1_decompress(buf, count, True),
}


def oracle(buf: np.ndarray, count: int, kind: str) -> int:
    """The check as the JAX package makes it: expand every key byte into
    four codes."""
    key_len = (count + 3) // 4
    if buf.size < key_len:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "stream too short")
    codes = scalar.unpack_keys(buf[:key_len], 4 * key_len)
    per_code = np.bincount(codes[:count], minlength=4)  # values per code
    if kind == "w2" and per_code[2:].any():
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "invalid code for width")
    if (codes[count:] != 0).any():
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR,
                       "nonzero trailing key bits")
    if kind == "v1":
        data_len = (int(per_code @ _V1_NIBBLES) + 1) // 2
    else:
        data_len = count + int(per_code @ _W4_EXTRA_BYTES)
    if key_len + data_len != buf.size:
        raise VbzError(VBZ_STREAMVBYTE_STREAM_ERROR, "stream length mismatch")
    return key_len


def _outcome(check, *args):
    try:
        return check(*args)
    except (VbzError, JaxVbzError) as e:
        return e.code, str(e)


def _assert_same(buf, count, kind):
    """The port's check against the oracle and, where the stream is broken,
    against the JAX backend's own host validation."""
    want = _outcome(oracle, buf, count, kind)
    assert _outcome(codec._check_stream, buf, count, kind) == want
    if isinstance(want, tuple):
        assert _outcome(_JAX_CHECK[kind], buf, count) == want
    return want


def _stream(rng, codes: np.ndarray, kind: str) -> np.ndarray:
    """A sound stream of ``codes``: its key bytes, then random data bytes."""
    if kind == "v1":
        data_len = (int(_V1_NIBBLES[codes].sum()) + 1) // 2
    else:
        data_len = codes.size + int(codes.sum())
    data = rng.integers(0, 256, data_len, dtype=np.uint8)
    return np.concatenate([scalar.pack_keys(codes), data])


def _set_code(buf: np.ndarray, place: int, code: int) -> np.ndarray:
    out = buf.copy()
    byte, shift = divmod(place, 4)
    out[byte] = int(out[byte]) & ~(3 << 2 * shift) | code << 2 * shift
    return out


def _faults(rng, buf, count, fault):
    """The broken variants of a sound stream of ``count`` values."""
    key_len = (count + 3) // 4
    if fault == "none":
        return [buf]
    if fault == "too_short":
        return [buf[:key_len - 1]]
    if fault == "live_code_high":  # a code of 2 or 3 among the live codes
        places = {0, count - 1, int(rng.integers(count))}
        return [_set_code(buf, p, c) for p in sorted(places) for c in (2, 3)]
    if fault == "trailing_code":  # each place past the end, each code
        return [_set_code(buf, p, c) for p in range(count, 4 * key_len)
                for c in (1, 2, 3)]
    if fault == "data_byte_more":
        return [np.append(buf, np.uint8(int(rng.integers(256))))]
    if fault == "data_byte_fewer":
        return [buf[:-1]]
    assert fault == "key_byte_changed"
    out = []
    for _ in range(8):
        changed = buf.copy()
        changed[int(rng.integers(key_len))] ^= int(rng.integers(1, 256))
        out.append(changed)
    return out


@pytest.mark.parametrize("fault", [
    "none", "too_short", "live_code_high", "trailing_code", "data_byte_more",
    "data_byte_fewer", "key_byte_changed"])
@pytest.mark.parametrize("key_len", [1, 2, 37, 38])
@pytest.mark.parametrize("rem", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_check_matches_oracle(kind, rem, key_len, fault):
    count = 4 * key_len if rem == 0 else 4 * (key_len - 1) + rem
    rng = np.random.default_rng([KINDS.index(kind), rem, key_len])
    codes = rng.integers(0, _MAX_CODE[kind] + 1, count).astype(np.uint8)
    buf = _stream(rng, codes, kind)
    assert _assert_same(buf, count, kind) == key_len
    for broken in _faults(rng, buf, count, fault):
        _assert_same(broken, count, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_check_on_views(kind):
    """A stream that starts at an odd address, and one that is strided."""
    rng = np.random.default_rng(7)
    count = 4 * 37 + 3
    codes = rng.integers(0, _MAX_CODE[kind] + 1, count).astype(np.uint8)
    buf = _stream(rng, codes, kind)
    shifted = np.empty(buf.size + 1, np.uint8)[1:]
    shifted[:] = buf
    strided = np.repeat(buf, 2)[::2]
    for view in (shifted, strided, shifted[:-1], strided[:-1]):
        _assert_same(view, count, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_check_large_sums(kind):
    """1,000,003 values all of the largest code: sums past 20 bits."""
    count = 1_000_003
    codes = np.full(count, _MAX_CODE[kind], np.uint8)
    buf = _stream(np.random.default_rng(3), codes, kind)
    assert _assert_same(buf, count, kind) == (count + 3) // 4
    _assert_same(buf[:-1], count, kind)
    _assert_same(_set_code(buf, count, 1), count, kind)


@pytest.mark.parametrize("count", [-1, -2, -3, -4, -5, -8])
@pytest.mark.parametrize("kind", KINDS)
def test_check_negative_count(kind, count):
    """A count below zero, as a destination of -2 bytes at width 2 gives:
    no stream matches it. From -1 to -3 the oracle and the JAX backend say
    so too; below, their key length is negative and they fail outside
    ``VbzError``, so the port is held to the same error alone."""
    buf = _stream(np.random.default_rng(5), np.ones(9, np.uint8), kind)
    mismatch = (VBZ_STREAMVBYTE_STREAM_ERROR,
                str(VbzError(VBZ_STREAMVBYTE_STREAM_ERROR,
                             "stream length mismatch")))
    if count > -4:
        assert _assert_same(buf, count, kind) == mismatch
    assert _outcome(codec._check_stream, buf, count, kind) == mismatch


def test_api_negative_destination_size():
    backend, opts = codec.TorchSvbBackend("cpu"), CompressionOptions(True, 2,
                                                                     0, 0)
    stream = api.vbz_compress(np.arange(9, dtype=np.int16), opts,
                              backend=backend)
    with pytest.raises(VbzError, match="stream length mismatch") as e:
        api.vbz_decompress(stream, -2, opts, backend=backend)
    assert e.value.code == VBZ_STREAMVBYTE_STREAM_ERROR


def test_decode_checks_each_stream_through_module_global(monkeypatch):
    """Three streams, one empty: two checks, by the module-global name that
    ``benchmark/metrics/validate_pct.read.py`` wraps."""
    backend = codec.TorchSvbBackend("cpu")
    sigs = [np.arange(n, dtype=np.int16) * 37 for n in (5, 0, 9)]
    streams = backend.svb_compress_batch(sigs, 2, True, 0)
    real, calls = codec._check_stream, []

    def counting(buf, count, kind):
        calls.append(count)
        return real(buf, count, kind)

    monkeypatch.setattr(codec, "_check_stream", counting)
    out = backend.svb_decompress_batch(streams, [s.size for s in sigs], 2,
                                       True, 0)
    assert calls == [5, 9]
    for got, want in zip(out, sigs):
        np.testing.assert_array_equal(got, want)
