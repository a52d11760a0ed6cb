"""The port's W2 rows (``vbz_compression_tpu_torch.ops.svb_w2``) against the
JAX package's Pallas W2 kernels and the NumPy oracle.

The JAX side runs as ``tests/test_pallas_kernels.py`` runs it, in interpret
mode, on that file's inputs; the port side runs the plain PyTorch version,
which is what ``encode_w2_rows`` / ``decode_w2_rows`` do for CPU tensors.
Every comparison is exact: the codec is an integer codec. The kernels
themselves run only on a CUDA card (``tests/test_torch_cuda.py``).
"""

import sys
import threading
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vbz_compression_tpu.ops import pallas_codec3 as pc3
from vbz_compression_tpu.ops import pallas_codec4 as pc4
from vbz_compression_tpu.ops import pallas_codec5 as pc5
from vbz_compression_tpu.ops import pallas_dense as pcd
from vbz_compression_tpu.ops import scalar
from vbz_compression_tpu_torch.ops import _rows, svb_w2

_SIZE = {"zz16": 2, "zz8": 1}


def _encode(rows: np.ndarray, lens, flavor: str):
    """Port encode of a [B, N] batch on the CPU; per-row wire streams plus
    the raw outputs."""
    keys, data, dlen = svb_w2.encode_w2_rows(
        torch.from_numpy(rows), torch.tensor(lens, dtype=torch.int32), flavor)
    streams = [keys[b, :(n + 3) // 4].numpy().tobytes()
               + data[b, :int(dlen[b])].numpy().tobytes()
               for b, n in enumerate(lens)]
    return streams, keys, data, dlen


def _decode(keys, data, lens, flavor: str) -> np.ndarray:
    return svb_w2.decode_w2_rows(keys, data,
                                 torch.tensor(lens, dtype=torch.int32),
                                 flavor).numpy()


def _walk(rng, n, sigma=12.0):
    return np.clip(500 + np.cumsum(rng.normal(0, sigma, n)), -2000,
                   2000).astype(np.int16)


def test_rows_batch_matches_pallas5():
    """test_pallas5_rows_batch_roundtrip's batch: per-row resets, each row's
    keys, data and length equal to the batched Pallas kernels'."""
    rng = np.random.default_rng(3)
    B, N, block, slack = 3, 2048, 512, 256
    rows = np.stack([
        _walk(rng, N),
        np.cumsum(rng.integers(-40, 40, N)).astype(np.int16),
        np.full(N, -7, np.int16),
    ])
    with pltpu.force_tpu_interpret_mode():
        jkeys, jdata, jlens, ovf = pc5.encode_w2_rows(
            jnp.asarray(rows), block=block, flavor="zz16", slack=slack)
    assert np.all(np.asarray(ovf) == 0)
    streams, keys, data, dlen = _encode(rows, [N] * B, "zz16")
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(dlen.numpy(), np.asarray(jlens))
    jdata = np.asarray(jdata).astype(np.uint8)
    for b in range(B):
        n = int(dlen[b])
        np.testing.assert_array_equal(data[b, :n].numpy(), jdata[b, :n])
        assert streams[b] == scalar.svb_compress(rows[b], 2, True, 0)
    with pltpu.force_tpu_interpret_mode():
        jout = pc5.decode_w2_rows(jkeys, jnp.asarray(jdata.astype(np.int8)),
                                  block=block, flavor="zz16", slack=slack)
    out = _decode(keys, data, [N] * B, "zz16")
    np.testing.assert_array_equal(out, np.asarray(jout))
    np.testing.assert_array_equal(out, rows)


def _dense_inputs(name: str) -> np.ndarray:
    """The test_dense_* inputs of tests/test_pallas_kernels.py."""
    if name == "incompressible":
        return np.random.default_rng(9).integers(-32768, 32768,
                                                 4096).astype(np.int16)
    if name == "all_two_byte":
        return np.cumsum(np.full(2048, 300, np.int64)).astype(np.int16)
    if name == "signal":
        return _walk(np.random.default_rng(0), 4096)
    if name == "mixed_codes":
        return np.cumsum(np.random.default_rng(7).integers(
            -400, 400, 4096)).astype(np.int16)
    if name == "multiblock":
        rng = np.random.default_rng(3)
        a = rng.integers(-32768, 32768, 1024).astype(np.int16)
        b = _walk(rng, 1024)
        c = np.cumsum(rng.integers(-200, 200, 2048)).astype(np.int16)
        return np.concatenate([a, b, c])
    if name == "all_one_byte":   # code 0 everywhere, two kernel tiles
        return np.clip(np.cumsum(np.random.default_rng(5).integers(
            -60, 61, 8192)), -100, 100).astype(np.int16)
    if name == "all_two_byte_tiles":   # code 1 everywhere, two kernel tiles
        return np.tile(np.array([300, -300], np.int16), 4096)
    assert name == "wrap_extremes"
    return np.array([-32768, 32767] * 1024, np.int16)


@pytest.mark.parametrize("name,block", [
    ("incompressible", 512), ("all_two_byte", 512), ("signal", 1024),
    ("mixed_codes", 512), ("multiblock", 512), ("wrap_extremes", 512),
    ("all_one_byte", 512), ("all_two_byte_tiles", 512)])
def test_dense_content_matches_pallas_dense(name, block):
    sig = _dense_inputs(name)
    with pltpu.force_tpu_interpret_mode():
        keys, data, total = pcd.encode_w2_dense(jnp.asarray(sig), block=block)
    jstream = np.asarray(keys).tobytes() + \
        np.asarray(data).astype(np.uint8).tobytes()[: int(total)]
    streams, pkeys, pdata, _ = _encode(sig[None], [sig.size], "zz16")
    assert streams[0] == jstream
    assert streams[0] == scalar.svb_compress(sig, 2, True, 0)
    np.testing.assert_array_equal(
        _decode(pkeys, pdata, [sig.size], "zz16")[0], sig)


@pytest.mark.parametrize("name,flavor", [
    ("signal", "zz16"), ("extremes", "zz16"), ("zz8", "zz8"),
    ("code0", "zz16"), ("code0", "zz8"), ("code1", "zz16"), ("code1", "zz8")])
def test_small_chunks_match_pallas3(name, flavor):
    """test_pallas3_roundtrip_* and test_pallas3_zz8 inputs: the W2 kernel
    for chunks under 16384 values; and rows of one code, code 0 (zig-zag
    values < 256) or code 1 (>= 256; zz8 from its second value on)."""
    rng = np.random.default_rng(1 if flavor == "zz8" else 0)
    dtype = np.int16 if flavor == "zz16" else np.int8
    if name == "signal":
        sig = _walk(rng, 1024)
    elif name == "extremes":
        sig = np.tile(np.array([-32768, 32767], np.int16), 512)
    elif name == "code0":
        sig = np.clip(np.cumsum(rng.integers(-60, 61, 1024)), -100,
                      100).astype(dtype)
    elif name == "code1":
        big = 300 if flavor == "zz16" else -100
        sig = np.tile(np.array([big, -big], dtype), 512)
    else:
        sig = np.clip(np.cumsum(rng.normal(0, 3, 1024)), -100,
                      100).astype(np.int8)
    with pltpu.force_tpu_interpret_mode():
        keys, data, total = pc3.encode_w2(jnp.asarray(sig), block=512,
                                          flavor=flavor)
    jstream = np.asarray(keys).tobytes() + \
        np.asarray(data).astype(np.uint8).tobytes()[: int(total)]
    streams, pkeys, pdata, _ = _encode(sig[None], [sig.size], flavor)
    assert streams[0] == jstream
    assert streams[0] == scalar.svb_compress(sig, _SIZE[flavor], True, 0)
    np.testing.assert_array_equal(
        _decode(pkeys, pdata, [sig.size], flavor)[0], sig)


@pytest.mark.parametrize("flavor", ["zz16", "zz8"])
@pytest.mark.parametrize("lens", [(1, 3, 4095), (4, 5, 0), (4093, 4096, 7),
                                  (1, 4095, 4096), (4097, 12293, 0)])
def test_ragged_rows_match_oracle(flavor, lens):
    """Rows of unlike lengths in one padded batch, with garbage past each
    length: every row encodes as the oracle does on its own prefix, and the
    tails take code 0, no data bytes, and decode to 0. The last two length
    sets sit on the edges of the kernels' 4096-value tiles."""
    rng = np.random.default_rng(17 + sum(lens))
    dtype = np.int16 if flavor == "zz16" else np.int8
    info = np.iinfo(dtype)
    width = max(4096, -(-max(lens) // 4) * 4)
    rows = rng.integers(info.min, info.max + 1, (3, width)).astype(dtype)
    rows[1] = np.cumsum(rng.integers(-3, 4, width)).astype(dtype)
    streams, keys, data, dlen = _encode(rows, lens, flavor)
    for b, n in enumerate(lens):
        assert streams[b] == scalar.svb_compress(rows[b, :n], _SIZE[flavor],
                                                 True, 0), f"row {b}"
        assert not keys[b, (n + 3) // 4:].any()
    out = _decode(keys, data, lens, flavor)
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(out[b, :n], rows[b, :n])
        assert not out[b, n:].any()


def test_decode_stays_inside_data():
    """Keys that claim more bytes than the data row holds: decode reads
    nothing past the row (missing bytes read as 0) and matches the oracle's
    values on the bytes that are there."""
    sig = np.arange(0, 4096 * 300, 300, dtype=np.int64).astype(np.int16)
    streams, keys, data, dlen = _encode(sig[None], [sig.size], "zz16")
    short = data[:, :100].contiguous()
    out = _decode(keys, short, [sig.size], "zz16")
    assert out.shape == (1, 4096)
    # 2-byte values: the first 50 survive whole.
    np.testing.assert_array_equal(out[0, :50], sig[:50])


def test_cpu_tensor_runs_plain_and_counts_nothing():
    rows = _walk(np.random.default_rng(4), 2048)[None]
    x = torch.from_numpy(rows)
    n = torch.tensor([2000], dtype=torch.int32)
    before = (svb_w2.ENCODE_LAUNCHES, svb_w2.DECODE_LAUNCHES)
    got = svb_w2.encode_w2_rows(x, n, "zz16")
    want = svb_w2.encode_w2_rows_plain(x, n, "zz16")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    out = svb_w2.decode_w2_rows(got[0], got[1], n, "zz16")
    assert torch.equal(out, svb_w2.decode_w2_rows_plain(got[0], got[1], n,
                                                        "zz16"))
    assert (svb_w2.ENCODE_LAUNCHES, svb_w2.DECODE_LAUNCHES) == before


@pytest.mark.parametrize("bad", ["meta_device", "dtype", "width", "lens_dtype",
                                 "lens_shape", "flavor"])
def test_encode_rejects_bad_arguments(bad):
    x = torch.zeros(2, 16, dtype=torch.int16)
    lens = torch.tensor([16, 3], dtype=torch.int32)
    flavor = "zz16"
    if bad == "meta_device":
        x, lens = x.to("meta"), lens.to("meta")
    elif bad == "dtype":
        x = x.to(torch.int32)
    elif bad == "width":
        x = x[:, :15]
    elif bad == "lens_dtype":
        lens = lens.to(torch.int64)
    elif bad == "lens_shape":
        lens = lens[:1]
    else:
        flavor = "none16"
    with pytest.raises(ValueError):
        svb_w2.encode_w2_rows(x, lens, flavor)


def test_decode_rejects_bad_arguments():
    keys = torch.zeros(2, 4, dtype=torch.uint8)
    data = torch.zeros(2, 32, dtype=torch.uint8)
    counts = torch.tensor([16, 3], dtype=torch.int32)
    with pytest.raises(ValueError):
        svb_w2.decode_w2_rows(keys.to("meta"), data.to("meta"),
                              counts.to("meta"), "zz16")
    with pytest.raises(ValueError):
        svb_w2.decode_w2_rows(keys, data[:1], counts, "zz16")
    with pytest.raises(ValueError):
        svb_w2.decode_w2_rows(keys.to(torch.int8), data, counts, "zz16")
    with pytest.raises(ValueError):
        svb_w2.decode_w2_rows(keys, data, counts, "zz32")



@pytest.mark.parametrize("flavor", ["zz16", "zz8"])
def test_stream_decode_on_cpu_is_the_composition(flavor):
    """On CPU tensors the plane's in-place decoder runs the plain version:
    the stream sections, the plain row decode and ``ok``, on rows of the
    oracle's v0 streams (one stream length one long, one short, a key row
    cut by M), and launches nothing."""
    rng = np.random.default_rng(9)
    dtype = np.int16 if flavor == "zz16" else np.int8
    lens = [0, 3, 17, 600, 1024]
    M = 256 + 2 * 1024 + 5
    streams = torch.zeros(len(lens), M, dtype=torch.uint8)
    rows, slen = [], []
    for b, n in enumerate(lens):
        rows.append(rng.integers(-1000, 1000, n).astype(dtype))
        s = scalar.svb_compress(rows[-1], _SIZE[flavor], True, 0)
        streams[b, :len(s)] = torch.tensor(list(s), dtype=torch.uint8)
        slen.append(len(s))
    slen = torch.tensor(slen)
    slen[1] += 1
    slen[2] -= 1
    counts = torch.tensor(lens, dtype=torch.int32)
    before = (svb_w2.DECODE_LAUNCHES, svb_w2.DECODE_STREAM_LAUNCHES)
    for m in (M, 200):
        cut = streams[:, :m].contiguous()
        out, ok = svb_w2.decode_w2_streams(cut, counts, slen, 1024, flavor)
        keys, data, kl = _rows.stream_sections(cut, counts, 1024)
        assert torch.equal(out, svb_w2.decode_w2_rows_plain(keys, data,
                                                            counts, flavor))
        assert torch.equal(ok, _rows.stream_ok(keys, counts, kl, slen))
    # M = 200 cuts the last row's 256 key bytes (codes 1 among them), not
    # the 150 of the row before.
    assert ok.tolist() == [True, False, False, True, False]
    out, ok = svb_w2.decode_w2_streams(streams, counts, slen, 1024, flavor)
    assert ok.tolist() == [True, False, False, True, True]
    for b, r in enumerate(rows):
        np.testing.assert_array_equal(out[b, :r.size].numpy(), r)
        assert not out[b, r.size:].any()
    assert (svb_w2.DECODE_LAUNCHES,
            svb_w2.DECODE_STREAM_LAUNCHES) == before


@pytest.mark.parametrize("bad", ["meta_device", "dtype", "counts_dtype",
                                 "stream_lens_shape", "out_n", "flavor"])
def test_stream_decode_rejects_bad_arguments(bad):
    streams = torch.zeros(2, 40, dtype=torch.uint8)
    counts = torch.tensor([16, 3], dtype=torch.int32)
    slen = torch.tensor([4, 1], dtype=torch.int32)
    out_n, flavor = 16, "zz16"
    if bad == "meta_device":
        streams, counts, slen = (t.to("meta") for t in (streams, counts,
                                                        slen))
    elif bad == "dtype":
        streams = streams.to(torch.int8)
    elif bad == "counts_dtype":
        counts = counts.to(torch.int64)
    elif bad == "stream_lens_shape":
        slen = slen[:1]
    elif bad == "out_n":
        out_n = 18
    else:
        flavor = "none16"
    with pytest.raises(ValueError):
        svb_w2.decode_w2_streams(streams, counts, slen, out_n, flavor)


def test_stream_scratch_is_kept_while_large_enough(monkeypatch):
    """The stream decoder's look-back buffer: int64, the next power of two
    of the words asked, and the same tensor for the same key while it holds
    what a call asks, however much less that is."""
    monkeypatch.setattr(svb_w2, "_STREAM_SCRATCH", {})
    grown = svb_w2.STREAM_SCRATCH_GROWN
    buf = svb_w2.stream_scratch((0, 7), 40, torch.device("cpu"))
    assert buf.dtype == torch.int64 and buf.numel() == 64
    for words in (40, 64, 1, 33):
        assert svb_w2.stream_scratch((0, 7), words, "cpu") is buf
    assert svb_w2.STREAM_SCRATCH_GROWN == grown + 1


def test_stream_scratch_grows_once_for_a_larger_call(monkeypatch):
    """A call that asks more than the kept buffer holds replaces it, once,
    counted in STREAM_SCRATCH_GROWN; the larger one is kept after it."""
    monkeypatch.setattr(svb_w2, "_STREAM_SCRATCH", {})
    small = svb_w2.stream_scratch((0, 7), 64, "cpu")
    grown = svb_w2.STREAM_SCRATCH_GROWN
    large = svb_w2.stream_scratch((0, 7), 65, "cpu")
    assert large is not small and large.numel() == 128
    assert svb_w2.STREAM_SCRATCH_GROWN == grown + 1
    for words in (128, 65, 64, 1):
        assert svb_w2.stream_scratch((0, 7), words, "cpu") is large
    assert svb_w2.STREAM_SCRATCH_GROWN == grown + 1


def test_stream_scratch_is_separate_per_device_and_stream(monkeypatch):
    """Each (device index, stream) key holds a buffer of its own, each
    counted once."""
    monkeypatch.setattr(svb_w2, "_STREAM_SCRATCH", {})
    grown = svb_w2.STREAM_SCRATCH_GROWN
    keys = [(0, 7), (0, 8), (1, 7)]
    bufs = [svb_w2.stream_scratch(k, 100, "cpu") for k in keys]
    assert len({id(b) for b in bufs}) == len(keys)
    assert svb_w2.STREAM_SCRATCH_GROWN == grown + len(keys)
    for k, b in zip(keys, bufs):
        assert svb_w2.stream_scratch(k, 100, "cpu") is b
    assert svb_w2.STREAM_SCRATCH_GROWN == grown + len(keys)


def test_stream_scratch_from_many_threads(monkeypatch):
    """Threads asking two keys for growing sizes at once: every buffer holds
    what its caller asked, each buffer made is counted once, and each key
    ends with the next power of two of the most it was asked."""
    monkeypatch.setattr(svb_w2, "_STREAM_SCRATCH", {})
    grown = svb_w2.STREAM_SCRATCH_GROWN
    seen, short = [], []

    def ask(t):
        rng = np.random.default_rng(t)
        for words in rng.integers(1, 5000, 200).tolist():
            buf = svb_w2.stream_scratch((0, t % 2), words, "cpu")
            seen.append(buf)
            if buf.numel() < words:
                short.append(words)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert len(seen) == 16 * 200 and not short
    assert svb_w2.STREAM_SCRATCH_GROWN - grown == len({id(b) for b in seen})
    for key in (0, 1):
        most = max(int(w) for t in range(key, 16, 2) for w in
                   np.random.default_rng(t).integers(1, 5000, 200))
        assert svb_w2._STREAM_SCRATCH[(0, key)].numel() == \
            1 << (most - 1).bit_length()


@pytest.mark.parametrize("case", ["current device", "another device",
                                  "error"])
def test_launch_takes_the_raw_stream_and_guards_only_another_device(case):
    """``_rows.launch`` hands a stand-in entry point each tensor's pointer,
    the other arguments as they are and the raw current stream of the first
    tensor's device, last; it enters that device's guard only where another
    device is current, and raises on a nonzero return."""
    x, y = torch.zeros(4), torch.zeros(2, dtype=torch.int32)
    index = x.get_device()
    current = index if case != "another device" else index + 1
    calls = []

    def entry(*args):
        calls.append(args)
        return 700 if case == "error" else 0

    guard = mock.MagicMock()
    with mock.patch.object(torch._C, "_cuda_getCurrentRawStream",
                           create=True, return_value=0xBEEF) as raw, \
            mock.patch.object(torch._C, "_cuda_getDevice", create=True,
                              return_value=current), \
            mock.patch.object(torch.cuda, "device", guard):
        if case == "error":
            with pytest.raises(RuntimeError, match="stand-in kernel launch "
                               "failed: CUDA error 700"):
                _rows.launch(entry, "stand-in", 5, x, y, 3)
        else:
            _rows.launch(entry, "stand-in", 5, x, y, 3)
    raw.assert_called_once_with(index)
    assert calls == [(5, x.data_ptr(), y.data_ptr(), 3, 0xBEEF)]
    if case == "another device":
        guard.assert_called_once_with(index)
        guard.return_value.__enter__.assert_called_once()
    else:
        guard.assert_not_called()

def test_batch_rows_match_pallas3_batch():
    """test_pallas3_batch_rows_independent's batch: pallas_codec3's batched
    W2 kernels (chunks under 16384 values) against E/D's plain versions, row
    for row."""
    rng = np.random.default_rng(4)
    B, N, block = 2, 1024, 512
    rows = np.stack([_walk(rng, N) for _ in range(B)])
    with pltpu.force_tpu_interpret_mode():
        jkeys, jdata, jlens = pc3.encode_w2_batch(jnp.asarray(rows),
                                                  block=block)
        boffs = pc3.block_offsets_from_keys_batch(jkeys, block)
        jout = pc3.decode_w2_batch(jkeys, jdata, boffs, block=block)
    streams, keys, data, dlen = _encode(rows, [N] * B, "zz16")
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(dlen.numpy(), np.asarray(jlens))
    jdata = np.asarray(jdata).astype(np.uint8)
    for b in range(B):
        assert streams[b] == np.asarray(jkeys)[b].tobytes() + \
            jdata[b, :int(jlens[b])].tobytes()
        assert streams[b] == scalar.svb_compress(rows[b], 2, True, 0)
    out = _decode(keys, data, [N] * B, "zz16")
    np.testing.assert_array_equal(out, np.asarray(jout))
    np.testing.assert_array_equal(out, rows)


def _pallas4_case(name: str):
    """(signal, block, slack, flavor) of each test_pallas4_* round trip."""
    if name == "signal":
        return _walk(np.random.default_rng(0), 4096), 512, 256, "zz16"
    if name == "mixed_codes":
        return np.cumsum(np.random.default_rng(7).integers(
            -400, 400, 4096)).astype(np.int16), 512, 512, "zz16"
    if name == "constant":
        return np.full(2048, 123, np.int16), 512, 128, "zz16"
    if name == "overflow_flag":
        return (np.arange(2048, dtype=np.int32) * 200).astype(
            np.int16), 512, 128, "zz16"
    if name == "wrap_extremes":
        return np.tile(np.array([-32768, 32767], np.int16), 1024), 512, \
            128, "zz16"
    assert name == "zz8"
    return np.clip(np.cumsum(np.random.default_rng(1).normal(0, 3, 2048)),
                   -100, 100).astype(np.int8), 512, 256, "zz8"


@pytest.mark.parametrize("name", ["signal", "mixed_codes", "constant",
                                  "overflow_flag", "wrap_extremes", "zz8"])
def test_matches_pallas4(name):
    """The test_pallas4_* inputs: pallas_codec4's superseded W2 kernels
    against E/D's plain versions. Where codec4 flags an overflow (its slack
    is too small for the block) the port has no such limit and matches the
    oracle."""
    sig, block, slack, flavor = _pallas4_case(name)
    N = sig.size
    ref = scalar.svb_compress(sig, _SIZE[flavor], True, 0)
    keysA = np.frombuffer(ref[: N // 4], np.uint8)
    datab = np.frombuffer(ref[N // 4:], np.uint8)
    with pltpu.force_tpu_interpret_mode():
        jkeys, jdata, total, ovf = pc4.encode_w2(
            jnp.asarray(sig), block=block, flavor=flavor, slack=slack)
        if not int(ovf):
            jout = pc4.decode_w2(
                jnp.asarray(keysA), jnp.asarray(datab.astype(np.int32)),
                pc4.block_offsets_from_keys(jnp.asarray(keysA), block),
                block=block, flavor=flavor, slack=slack)
    assert bool(int(ovf)) == (name == "overflow_flag")
    streams, keys, data, _ = _encode(sig[None], [N], flavor)
    assert streams[0] == ref
    out = _decode(keys, data, [N], flavor)[0]
    np.testing.assert_array_equal(out, sig)
    if not int(ovf):
        assert streams[0] == np.asarray(jkeys).tobytes() + np.asarray(
            jdata).astype(np.uint8).tobytes()[: int(total)]
        np.testing.assert_array_equal(out, np.asarray(jout))
