"""The port's backend (``TorchSvbBackend``) on the CPU, against the NumPy
oracle and the JAX package's XLA backend: the same streams, the same decoded
arrays, the same ``VbzError`` codes on malformed streams, for every flavor
of the v0/v1 option lattice."""

import numpy as np
import pytest

from vbz_compression_tpu.models.codec import JaxSvbBackend
from vbz_compression_tpu.ops import scalar
from vbz_compression_tpu_torch.errors import (
    VBZ_INPUT_SIZE_ERROR,
    VBZ_INTEGER_SIZE_ERROR,
    VBZ_STREAMVBYTE_STREAM_ERROR,
    VbzError,
)
from vbz_compression_tpu_torch.models.codec import TorchSvbBackend

BACKEND = TorchSvbBackend("cpu")
RAGGED = (0, 1, 3, 4, 5, 7, 8, 4093, 4095, 4096)
_FLAVORS = [(np.int16, 2, 0), (np.int16, 2, 1), (np.int8, 1, 0)]


def _signal(rng, n, dtype):
    info = np.iinfo(dtype)
    if n % 2:
        return rng.integers(info.min, info.max + 1, n).astype(dtype)
    return np.clip(np.cumsum(rng.normal(0, info.max / 200, n)), info.min,
                   info.max).astype(dtype)


@pytest.mark.parametrize("dtype,size,version", _FLAVORS)
def test_ragged_lengths_match_oracle(dtype, size, version):
    """v0 zz16, v1 at width 2 (which is v0) and zz8 over ragged lengths."""
    rng = np.random.default_rng(size * 10 + version)
    for n in RAGGED:
        sig = _signal(rng, n, dtype)
        ref = scalar.svb_compress(sig, size, True, version)
        assert BACKEND.svb_compress(sig, size, True, version) == ref, n
        out = BACKEND.svb_decompress(ref, n, size, True, version)
        assert out.dtype == dtype
        np.testing.assert_array_equal(out, sig)


def test_int16_wrap_boundary():
    sig = np.array([-32768, 32767] * 1024 + [0, -32768, 32767, -1], np.int16)
    ref = scalar.svb_compress(sig, 2, True, 0)
    assert BACKEND.svb_compress(sig, 2, True, 0) == ref
    np.testing.assert_array_equal(
        BACKEND.svb_decompress(ref, sig.size, 2, True, 0), sig)


@pytest.mark.parametrize("dtype,size", [(np.int16, 2), (np.int8, 1)])
def test_batch_matches_per_chunk_and_jax(dtype, size):
    """One padded batch for the whole call gives each chunk's own stream,
    which is also the JAX backend's."""
    rng = np.random.default_rng(8)
    chunks = [_signal(rng, n, dtype) for n in (4096, 0, 1, 3001)]
    streams = BACKEND.svb_compress_batch(chunks, size, True, 0)
    jax_backend = JaxSvbBackend()
    for c, s in zip(chunks, streams):
        assert s == BACKEND.svb_compress(c, size, True, 0)
        assert s == jax_backend.svb_compress(c, size, True, 0)
    outs = BACKEND.svb_decompress_batch(streams, [c.size for c in chunks],
                                        size, True, 0)
    for c, o in zip(chunks, outs):
        assert o.dtype == dtype
        np.testing.assert_array_equal(o, c)
        np.testing.assert_array_equal(
            jax_backend.svb_decompress(
                BACKEND.svb_compress(c, size, True, 0), c.size, size, True, 0),
            o)


def test_bytes_input_and_empty():
    sig = np.arange(-50, 50, dtype=np.int16)
    assert BACKEND.svb_compress(sig.tobytes(), 2, True, 0) == \
        scalar.svb_compress(sig, 2, True, 0)
    assert BACKEND.svb_compress(b"", 2, True, 0) == b""
    assert BACKEND.svb_decompress(b"", 0, 2, True, 0).size == 0
    assert BACKEND.svb_compress_batch([], 2, True, 0) == []
    assert BACKEND.svb_decompress_batch([], [], 2, True, 0) == []


def _good_stream(n=9):
    sig = np.array([0, 1, 300, -300, 5, 5, 5, 1000, 2][:n], np.int16)
    return sig, scalar.svb_compress(sig, 2, True, 0)


@pytest.mark.parametrize("case", [
    "too_short", "code_gt_1", "trailing_bits", "length_long", "length_short",
    "empty_mismatch", "count_without_bytes"])
def test_malformed_streams_raise(case):
    """The JAX backend's host validation (models/codec.py:412-434) and empty
    rules, with the same error code."""
    sig, ref = _good_stream()
    n = sig.size
    key_len = (n + 3) // 4
    buf = bytearray(ref)
    count = n
    if case == "too_short":
        buf = buf[:key_len - 1]
    elif case == "code_gt_1":
        buf[0] = (buf[0] & ~0x3) | 0x2
    elif case == "trailing_bits":
        buf[key_len - 1] |= 0x3 << 2 * (n % 4)  # code of value n, past count
    elif case == "length_long":
        buf += b"\0"
    elif case == "length_short":
        buf = buf[:-1]
    elif case == "empty_mismatch":
        count = 0
    else:
        buf = b""
    with pytest.raises(VbzError) as exc:
        BACKEND.svb_decompress(bytes(buf), count, 2, True, 0)
    assert exc.value.code == VBZ_STREAMVBYTE_STREAM_ERROR
    with pytest.raises(VbzError):  # one bad stream fails the whole batch
        BACKEND.svb_decompress_batch([ref, bytes(buf)], [n, count], 2, True, 0)


def test_input_and_width_errors():
    with pytest.raises(VbzError) as exc:
        BACKEND.svb_compress(b"\0\0\0", 2, True, 0)
    assert exc.value.code == VBZ_INPUT_SIZE_ERROR
    with pytest.raises(VbzError) as exc:
        BACKEND.svb_compress(b"\0" * 6, 3, True, 0)
    assert exc.value.code == VBZ_INTEGER_SIZE_ERROR


# (integer_size, zigzag, version) of the W4 flavors and v1 int8.
_NEW_FLAVORS = [(4, True, 0), (4, False, 0), (2, False, 0), (1, False, 0),
                (1, True, 1), (1, False, 1)]
_DTYPES = {1: np.int8, 2: np.int16, 4: np.int32}


@pytest.mark.parametrize("size,zigzag,version,item", [
    (4, True, 0, "pallas_w4"), (4, False, 0, "pallas_w4"),
    (2, False, 0, "pallas_w4"), (1, False, 0, "pallas_w4"),
    (1, True, 1, "pallas_v1"), (1, False, 1, "pallas_v1")])
def test_unported_flavors_raise(size, zigzag, version, item):
    """The flavors that raised NotImplementedError before their kernels
    (``item`` names the Pallas module they replace) now round-trip through
    the backend, stream for stream with the oracle."""
    data = np.array([0, 1, -1, 127, -128, 300, -7, 5], np.int64).astype(
        _DTYPES[size])
    stream = BACKEND.svb_compress(data, size, zigzag, version)
    assert stream == scalar.svb_compress(data, size, zigzag, version), item
    np.testing.assert_array_equal(
        BACKEND.svb_decompress(stream, 8, size, zigzag, version), data)


@pytest.mark.parametrize("size,zigzag,version", _NEW_FLAVORS)
def test_new_flavors_ragged_match_oracle(size, zigzag, version):
    """W4 flavors and v1 int8 over ragged lengths: signal-like and uniform
    content, one chunk at a time and as one batch."""
    rng = np.random.default_rng(size * 10 + zigzag + 3 * version)
    dtype = _DTYPES[size]
    chunks = [_signal(rng, n, dtype) for n in RAGGED]
    streams = BACKEND.svb_compress_batch(chunks, size, zigzag, version)
    for c, s in zip(chunks, streams):
        assert s == scalar.svb_compress(c, size, zigzag, version), c.size
        assert s == BACKEND.svb_compress(c, size, zigzag, version)
        out = BACKEND.svb_decompress(s, c.size, size, zigzag, version)
        assert out.dtype == dtype
        np.testing.assert_array_equal(out, c)
    outs = BACKEND.svb_decompress_batch(streams, [c.size for c in chunks],
                                        size, zigzag, version)
    for c, o in zip(chunks, outs):
        np.testing.assert_array_equal(o, c)


@pytest.mark.parametrize("size,zigzag,version", _NEW_FLAVORS)
def test_new_flavors_match_jax_backend(size, zigzag, version):
    """The JAX package's XLA backend writes the same streams and reads the
    port's back."""
    rng = np.random.default_rng(40 + size)
    chunk = _signal(rng, 4001, _DTYPES[size])
    stream = BACKEND.svb_compress(chunk, size, zigzag, version)
    jax_backend = JaxSvbBackend()
    assert stream == jax_backend.svb_compress(chunk, size, zigzag, version)
    np.testing.assert_array_equal(
        jax_backend.svb_decompress(stream, chunk.size, size, zigzag, version),
        chunk)


def _good_new_stream(size, zigzag, version, n=9):
    sig = np.array([0, 1, 300, -300, 5, 5, 5, 100000, 2][:n], np.int64)
    sig = sig.astype(_DTYPES[size])
    return sig, scalar.svb_compress(sig, size, zigzag, version)


@pytest.mark.parametrize("size,zigzag,version", [(4, True, 0), (2, False, 0),
                                                 (1, True, 1)])
@pytest.mark.parametrize("case", [
    "too_short", "trailing_bits", "length_long", "length_short",
    "empty_mismatch", "count_without_bytes"])
def test_malformed_new_streams_raise(size, zigzag, version, case):
    """W4 and v1 streams are checked as the JAX backend checks them
    (models/codec.py:333-347 for v1, :412-434 for W4): no code is invalid,
    but the trailing key bits must be zero and the length must match
    (key bytes + the data bytes the codes need, nibbles rounded up for
    v1)."""
    sig, ref = _good_new_stream(size, zigzag, version)
    n = sig.size
    key_len = (n + 3) // 4
    buf = bytearray(ref)
    count = n
    if case == "too_short":
        buf = buf[:key_len - 1]
    elif case == "trailing_bits":
        buf[key_len - 1] |= 0x1 << 2 * (n % 4)  # code of value n, past count
    elif case == "length_long":
        buf += b"\0"
    elif case == "length_short":
        buf = buf[:-1]
    elif case == "empty_mismatch":
        count = 0
    else:
        buf = b""
    with pytest.raises(VbzError) as exc:
        BACKEND.svb_decompress(bytes(buf), count, size, zigzag, version)
    assert exc.value.code == VBZ_STREAMVBYTE_STREAM_ERROR
    with pytest.raises(VbzError):  # one bad stream fails the whole batch
        BACKEND.svb_decompress_batch([ref, bytes(buf)], [n, count], size,
                                     zigzag, version)
