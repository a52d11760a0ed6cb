"""The port's W4 rows (``vbz_compression_tpu_torch.ops.svb_w4``) against the
JAX package's Pallas W4 kernels and the NumPy oracle.

The JAX side runs as ``tests/test_pallas_kernels.py`` runs it, in interpret
mode, on that file's inputs (``test_pallas3_zz32``,
``test_pallas3_none16_sign_extends``, ``test_w4_dense_*``, and the
``_roundtrip`` inputs of ``pallas_codec2``) and on the content of
``signals.w4_tile_cases``, whose rows also go whole against the oracle at
the tile E4 and D4 share; the port side runs the plain
PyTorch version, which is what ``encode_w4_rows`` / ``decode_w4_rows`` do
for CPU tensors. Every comparison is exact: the codec is an integer codec.
The kernels themselves run only on a CUDA card (``tests/test_torch_cuda.py``).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vbz_compression_tpu.ops import pallas_codec2 as pc2
from vbz_compression_tpu.ops import pallas_codec3 as pc3
from vbz_compression_tpu.ops import pallas_w4 as pw4
from vbz_compression_tpu.ops import scalar
from vbz_compression_tpu_torch import oracle, signals
from vbz_compression_tpu_torch.ops import svb_w2, svb_w4

_SIZE = {"zz32": 4, "none32": 4, "none16": 2, "none8": 1}
_DTYPE = {"zz32": np.int32, "none32": np.int32, "none16": np.int16,
          "none8": np.int8}
_TILE = 4096  # the tile E4 and D4 share on the card (vbz_w4_*_tile)
# (name, flavor) of every case of signals.w4_tile_cases.
_TILE_CASES = [(name, flavor)
               for name in ("tile edges", "all code 0", "all code 3",
                            "codes cycling")
               for flavor in _SIZE] + [("wrap extremes", "zz32"),
                                       ("negative", "none16"),
                                       ("negative", "none8")]


def _encode(rows: np.ndarray, lens, flavor: str):
    """Port encode of a [B, N] batch on the CPU: per-row wire streams, keys
    and data."""
    keys, data, dlen = svb_w4.encode_w4_rows(
        torch.from_numpy(rows), torch.tensor(lens, dtype=torch.int32), flavor)
    streams = [keys[b, :(n + 3) // 4].numpy().tobytes()
               + data[b, :int(dlen[b])].numpy().tobytes()
               for b, n in enumerate(lens)]
    return streams, keys, data


def _decode(keys, data, lens, flavor: str) -> np.ndarray:
    return svb_w4.decode_w4_rows(keys, data,
                                 torch.tensor(lens, dtype=torch.int32),
                                 flavor).numpy()


def _pallas_stream(keys, data, total) -> bytes:
    return np.asarray(keys).tobytes() + \
        np.asarray(data).astype(np.uint8).tobytes()[: int(total)]


def _case(name: str):
    """(signal, flavor, block, kernel generation) for each Pallas W4 test."""
    if name == "pallas3_zz32":
        rng = np.random.default_rng(2)
        return np.clip(5e4 + np.cumsum(rng.normal(0, 3e3, 1024)), -8e6,
                       8e6).astype(np.int32), "zz32", 512, "codec3"
    if name == "pallas3_none16_sign_extends":
        rng = np.random.default_rng(3)
        return rng.integers(-32768, 32768, 1024).astype(
            np.int16), "none16", 512, "codec3"
    if name == "dense_zz32":
        rng = np.random.default_rng(0)
        return np.cumsum(rng.integers(-300000, 300000, 2048)).astype(
            np.int32), "zz32", 512, "dense"
    if name == "dense_none16_signed":
        rng = np.random.default_rng(1)
        return rng.integers(-2000, 2000, 2048).astype(
            np.int16), "none16", 512, "dense"
    if name == "dense_none8":
        rng = np.random.default_rng(2)
        return rng.integers(-128, 128, 2048).astype(
            np.int8), "none8", 512, "dense"
    if name == "dense_none32_multiblock":
        rng = np.random.default_rng(3)
        return rng.integers(0, 1 << 28, 4096,
                            dtype=np.int32), "none32", 1024, "dense"
    assert name == "dense_all_code_boundaries"
    vals = np.array([0, 1, 255, 256, 65535, 65536, (1 << 24) - 1, 1 << 24]
                    * 256, np.int32)
    return vals, "none32", 512, "dense"


@pytest.mark.parametrize("name", [
    "pallas3_zz32", "pallas3_none16_sign_extends", "dense_zz32",
    "dense_none16_signed", "dense_none8", "dense_none32_multiblock",
    "dense_all_code_boundaries"])
def test_matches_pallas_w4(name):
    """Keys, data and decoded values equal to the Pallas W4 kernels' (codec3
    below 16384 values, the dense kernels above) and to the oracle's."""
    _check_against_pallas(*_case(name))


def _check_against_pallas(sig: np.ndarray, flavor: str, block: int,
                          gen: str) -> None:
    N = sig.size
    ref = scalar.svb_compress(sig, _SIZE[flavor], flavor == "zz32", 0)
    assert ref == oracle.svb_compress(sig, _SIZE[flavor], flavor == "zz32", 0)
    keysA = np.frombuffer(ref[: N // 4], np.uint8)
    datab = np.frombuffer(ref[N // 4:], np.uint8)
    with pltpu.force_tpu_interpret_mode():
        if gen == "codec3":
            jstream = _pallas_stream(*pc3.encode_w4(
                jnp.asarray(sig), block=block, flavor=flavor))
            boffs = pc3.block_offsets_from_keys(jnp.asarray(keysA), block,
                                                four_byte_codes=True)
            jout = pc3.decode_w4(jnp.asarray(keysA),
                                 jnp.asarray(datab.astype(np.int32)), boffs,
                                 block=block, flavor=flavor)
        else:
            jstream = _pallas_stream(*pw4.encode_w4_dense(
                jnp.asarray(sig), block=block, flavor=flavor))
            boffs = pw4.byte_offsets_from_keys_w4(jnp.asarray(keysA), block)
            jout = pw4.decode_w4_dense(jnp.asarray(keysA),
                                       jnp.asarray(datab.astype(np.int8)),
                                       boffs, block=block, flavor=flavor)
    streams, keys, data = _encode(sig[None], [N], flavor)
    assert streams[0] == jstream == ref
    out = _decode(keys, data, [N], flavor)[0]
    np.testing.assert_array_equal(out, np.asarray(jout))
    np.testing.assert_array_equal(out, sig)
    assert out.dtype == sig.dtype


@functools.cache
def _tile_cases() -> dict:
    return {c[:2]: c[2:] for c in signals.w4_tile_cases(_TILE)}


@pytest.mark.parametrize("name,flavor", _TILE_CASES)
def test_tile_cases_match_oracle(name, flavor):
    """Rows of signals.w4_tile_cases at E4's and D4's tile, whole: each
    row's stream is the oracle's, and decode gives the row back and zeros
    past its length."""
    rows, lens = _tile_cases()[(name, flavor)]
    lens = [int(n) for n in lens]
    streams, keys, data = _encode(rows, lens, flavor)
    for b, n in enumerate(lens):
        assert streams[b] == oracle.svb_compress(
            rows[b, :n], _SIZE[flavor], flavor == "zz32", 0), f"row {b}"
    out = _decode(keys, data, lens, flavor)
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(out[b, :n], rows[b, :n])
        assert not out[b, n:].any()


@pytest.mark.parametrize("name,flavor", [c for c in _TILE_CASES
                                         if c[0] != "tile edges"])
def test_tile_contents_match_pallas3(name, flavor):
    """The content of each one-code, cycling and extreme case: the first
    1024 values of its first row through pallas_codec3's W4 kernels (the
    size interpret mode allows), the plain versions and the oracle."""
    rows, _ = _tile_cases()[(name, flavor)]
    _check_against_pallas(np.ascontiguousarray(rows[0, :1024]), flavor, 512,
                          "codec3")


def _codec2_input(name: str) -> tuple[np.ndarray, int]:
    """The inputs and blocks of test_pallas_roundtrip_*."""
    if name.startswith("signal"):
        rng = np.random.default_rng(0)
        sig = np.clip(500 + np.cumsum(rng.normal(0, 12, 4096)), -2000,
                      2000).astype(np.int16)
        return sig, int(name.split("_")[1])
    if name == "extremes":
        return np.tile(np.array([-32768, 32767], np.int16), 2048), 2048
    assert name == "constant"
    return np.full(4096, 123, np.int16), 2048


@pytest.mark.parametrize("name", ["signal_512", "signal_2048", "extremes",
                                  "constant"])
def test_codec2_pack_matches_e4_none32_and_d(name):
    """pallas_codec2.encode_int16_zz packs pre-zig-zagged values (< 65536) as
    W2: E4's none32 plain version on the same values gives the same bytes.
    decode_int16_zz is the full zz16 decode: D's plain version gives the
    same int16."""
    sig, block = _codec2_input(name)
    N = sig.size
    zz = scalar.zigzag_delta_encode(sig, 2)
    ref = scalar.svb_compress(sig, 2, True, 0)
    keysA = np.frombuffer(ref[: N // 4], np.uint8)
    datab = np.frombuffer(ref[N // 4:], np.uint8)
    codes = (np.repeat(keysA, 4)
             >> np.tile(np.array([0, 2, 4, 6], np.uint8), keysA.size)) & 3
    bsum = (np.minimum(codes, 1) + 1).reshape(-1, block).sum(1)
    boffs = np.concatenate([[0], np.cumsum(bsum)[:-1]]).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        jstream = _pallas_stream(*pc2.encode_int16_zz(jnp.asarray(zz),
                                                      block=block))
        jout = pc2.decode_int16_zz(jnp.asarray(keysA),
                                   jnp.asarray(datab.astype(np.int32)),
                                   jnp.asarray(boffs), block=block)
    streams, _, _ = _encode(zz.astype(np.int32)[None], [N], "none32")
    assert streams[0] == jstream == ref
    keys, data, _ = svb_w2.encode_w2_rows(
        torch.from_numpy(sig[None]), torch.tensor([N], dtype=torch.int32),
        "zz16")
    out = svb_w2.decode_w2_rows(keys, data,
                                torch.tensor([N], dtype=torch.int32),
                                "zz16").numpy()[0]
    np.testing.assert_array_equal(out, np.asarray(jout))
    np.testing.assert_array_equal(out, sig)


@pytest.mark.parametrize("flavor", ["zz32", "none32", "none16", "none8"])
@pytest.mark.parametrize("lens", [(1, 3, 4095), (4, 5, 0), (4093, 4096, 7)])
def test_ragged_rows_match_oracle(flavor, lens):
    """Rows of unlike lengths in one padded batch, with garbage past each
    length: every row encodes as the oracle does on its own prefix, and the
    tails take code 0, no data bytes, and decode to 0."""
    rng = np.random.default_rng(19 + sum(lens))
    dtype = _DTYPE[flavor]
    info = np.iinfo(dtype)
    rows = rng.integers(info.min, info.max, (3, 4096),
                        dtype=np.int64).astype(dtype)
    rows[1] = np.cumsum(rng.integers(-70000, 70000, 4096)).astype(dtype)
    streams, keys, data = _encode(rows, lens, flavor)
    for b, n in enumerate(lens):
        assert streams[b] == oracle.svb_compress(
            rows[b, :n], _SIZE[flavor], flavor == "zz32", 0), f"row {b}"
        assert not keys[b, (n + 3) // 4:].any()
    out = _decode(keys, data, lens, flavor)
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(out[b, :n], rows[b, :n])
        assert not out[b, n:].any()


@pytest.mark.parametrize("flavor", list(_SIZE))
@pytest.mark.parametrize("shift", [1, 2, 3])
def test_views_off_alignment_match_oracle(flavor, shift):
    """Inputs that are contiguous views 1-3 elements into their buffer, the
    ones E4 on the card reads one value at a time: every row's stream is the
    oracle's, and decode gives the rows back."""
    rng = np.random.default_rng(29 + shift)
    dtype = _DTYPE[flavor]
    info = np.iinfo(dtype)
    rows = rng.integers(info.min, info.max, (3, 8200),
                        dtype=np.int64).astype(dtype)
    rows[0] = np.cumsum(rng.integers(-300, 300, 8200)).astype(dtype)
    lens = [8200, 4097, 5]
    buf = torch.empty(rows.size + shift, dtype=torch.from_numpy(rows).dtype)
    x = buf[shift:].view(rows.shape)
    x.copy_(torch.from_numpy(rows))
    assert x.is_contiguous() and x.storage_offset() == shift
    keys, data, dlen = svb_w4.encode_w4_rows(
        x, torch.tensor(lens, dtype=torch.int32), flavor)
    for b, n in enumerate(lens):
        stream = (keys[b, :(n + 3) // 4].numpy().tobytes()
                  + data[b, :int(dlen[b])].numpy().tobytes())
        assert stream == oracle.svb_compress(
            rows[b, :n], _SIZE[flavor], flavor == "zz32", 0), f"row {b}"
    out = _decode(keys, data, lens, flavor)
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(out[b, :n], rows[b, :n])


def test_decode_stays_inside_data():
    """Keys that claim more bytes than the data row holds: decode reads
    nothing past the row (missing bytes read as 0)."""
    sig = np.full(4096, 1 << 30, np.int32)  # 4 bytes per value
    _, keys, data = _encode(sig[None], [sig.size], "none32")
    out = _decode(keys, data[:, :402].contiguous(), [sig.size], "none32")
    np.testing.assert_array_equal(out[0, :100], sig[:100])
    assert out[0, 100] == 0  # bytes 400-401 of its four are there, and 0
    assert not out[0, 101:].any()


def test_decode_into_out():
    """``out`` receives the values, at any storage offset; an ``out`` of
    another dtype or shape raises."""
    x = torch.from_numpy(np.arange(-600, 600, 3, dtype=np.int16)[None])
    n = torch.tensor([397], dtype=torch.int32)
    keys, data, _ = svb_w4.encode_w4_rows(x, n, "none16")
    out = torch.full((x.numel() + 1,), 7, dtype=torch.int16)[1:].view(x.shape)
    got = svb_w4.decode_w4_rows(keys, data, n, "none16", out=out)
    assert got is out
    assert torch.equal(out, svb_w4.decode_w4_rows_plain(keys, data, n,
                                                        "none16"))
    for bad in (torch.zeros_like(x, dtype=torch.int32), x[:, :396]):
        with pytest.raises(ValueError):
            svb_w4.decode_w4_rows(keys, data, n, "none16", out=bad)


def test_cpu_tensor_runs_plain_and_counts_nothing():
    x = torch.from_numpy(np.arange(-600, 600, 3, dtype=np.int32)[None])
    n = torch.tensor([397], dtype=torch.int32)
    before = (svb_w4.ENCODE_LAUNCHES, svb_w4.DECODE_LAUNCHES)
    got = svb_w4.encode_w4_rows(x, n, "zz32")
    for g, w in zip(got, svb_w4.encode_w4_rows_plain(x, n, "zz32")):
        assert torch.equal(g, w)
    out = svb_w4.decode_w4_rows(got[0], got[1], n, "zz32")
    assert torch.equal(out, svb_w4.decode_w4_rows_plain(got[0], got[1], n,
                                                        "zz32"))
    assert (svb_w4.ENCODE_LAUNCHES, svb_w4.DECODE_LAUNCHES) == before


@pytest.mark.parametrize("bad", ["meta_device", "dtype", "width", "lens_dtype",
                                 "flavor"])
def test_rejects_bad_arguments(bad):
    x = torch.zeros(2, 16, dtype=torch.int32)
    lens = torch.tensor([16, 3], dtype=torch.int32)
    keys = torch.zeros(2, 4, dtype=torch.uint8)
    data = torch.zeros(2, 64, dtype=torch.uint8)
    flavor = "none32"
    if bad == "meta_device":
        x, lens = x.to("meta"), lens.to("meta")
        keys, data = keys.to("meta"), data.to("meta")
    elif bad == "dtype":
        x, keys = x.to(torch.int16), keys.to(torch.int8)
    elif bad == "width":
        x, data = x[:, :15], data[:1]
    elif bad == "lens_dtype":
        lens = lens.to(torch.int64)
    else:
        flavor = "zz16"
    with pytest.raises(ValueError):
        svb_w4.encode_w4_rows(x, lens, flavor)
    with pytest.raises(ValueError):
        svb_w4.decode_w4_rows(keys, data, lens, flavor)
