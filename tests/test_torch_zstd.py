"""The port's from-scratch zstd encoders (``ops.fse``, ``ops.zstd_huff``,
``ops.zstd_seq``, ``ops.zstd_match``) against the JAX package's, on the CPU.

- ``match_candidates_plain`` equals JAX's ``zstd_match_tpu.match_candidates``
  (int32 ``off``) on ``signals.match_cases``: the JAX match tests' inputs,
  random bytes, an all-zero buffer, lengths around o + 4 for o = 1 and 1024,
  an unsorted offset list, a list that repeats offsets;
  ``match_index_plain`` (uint8 places in the list), mapped back through the
  list, equals it too, 0 exactly where it is 0;
  ``build_match_index_device(..., "cpu")`` equals ``build_match_index_tpu``.
- Frames byte for byte the JAX package's on every input of
  ``tests/test_zstd_seq.py`` and ``tests/test_zstd_huff.py``, with the host
  matcher and the device matcher (JAX's "tpu"), against both JAX paths: its
  default (the native encoder where ``native/libvbz_native.so`` is built) and
  its NumPy path (the native branches patched to None, as
  ``test_native_encoder_parity`` does). Each frame decodes with
  ``zstandard``.
- The pipeline with ``VBZ_ZSTD_ENCODER=own`` and ``own-tpu`` on the CPU
  backend: the JAX pipeline's frames through ``vbz_compress_sized`` and
  ``vbz_compress_sized_batch`` at three option sets and through the corpus
  driver, each decoded back through the port's api.

Exact: bytes and int32 values.
"""

import unittest.mock as mock
import warnings

import numpy as np
import pytest
import torch

zstandard = pytest.importorskip("zstandard")

from vbz_compression_tpu import api as jax_api  # noqa: E402
from vbz_compression_tpu.models.codec import JaxSvbBackend  # noqa: E402
from vbz_compression_tpu.ops import fse as jax_fse  # noqa: E402
from vbz_compression_tpu.ops import scalar, zstd_match_tpu  # noqa: E402
from vbz_compression_tpu.ops import zstd_huff as jax_huff  # noqa: E402
from vbz_compression_tpu.ops import zstd_seq as jax_seq  # noqa: E402
from vbz_compression_tpu.options import CompressionOptions  # noqa: E402
from vbz_compression_tpu.parallel import (  # noqa: E402
    multihost as jax_multihost)
from vbz_compression_tpu_torch import (  # noqa: E402
    CompressionOptions as PortOptions)
from vbz_compression_tpu_torch import api, signals  # noqa: E402
from vbz_compression_tpu_torch.models.codec import (  # noqa: E402
    TorchSvbBackend)
from vbz_compression_tpu_torch.ops import (  # noqa: E402
    fse, zstd_huff, zstd_match, zstd_seq)
from vbz_compression_tpu_torch.parallel import multihost  # noqa: E402

_TILE = _HALO = 4096  # csrc/match_scan.cu kTile, kHaloCap
JAX_BACKEND = JaxSvbBackend()
MATCH_CASES = {c[0]: c[1:] for c in signals.match_cases(_TILE, _HALO)}


def _offsets(offsets):
    return zstd_match.DEFAULT_OFFSETS if offsets is None else offsets


# ---------------------------------------------------------------------------
# The match scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MATCH_CASES))
def test_plain_scan_matches_jax(name):
    buf, offsets = MATCH_CASES[name]
    offsets = _offsets(offsets)
    want = np.asarray(zstd_match_tpu.match_candidates(buf, offsets=offsets))
    got = zstd_match.match_candidates(torch.from_numpy(buf.copy()), offsets)
    assert got.dtype == torch.int32 and got.shape == (buf.size,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, zstd_match.match_candidates_plain(
        torch.from_numpy(buf.copy()), offsets))


@pytest.mark.parametrize("name", list(MATCH_CASES))
def test_plain_index_matches_jax(name):
    buf, offsets = MATCH_CASES[name]
    offsets = _offsets(offsets)
    want = np.asarray(zstd_match_tpu.match_candidates(buf, offsets=offsets))
    got = zstd_match.match_index(torch.from_numpy(buf.copy()), offsets)
    assert got.dtype == torch.uint8 and got.shape == (buf.size,)
    index = got.numpy()
    np.testing.assert_array_equal(index == 0, want == 0)
    probed = zstd_match._probed(offsets, buf.size)
    np.testing.assert_array_equal(np.array((0,) + probed)[index], want)
    assert torch.equal(got, zstd_match.match_index_plain(
        torch.from_numpy(buf.copy()), offsets))


def test_index_names_a_repeated_offset_by_its_first_place():
    buf, offsets = MATCH_CASES["repeated offsets"]
    index = zstd_match.match_index(torch.from_numpy(buf.copy()), offsets)
    places = set(np.unique(index.numpy()).tolist())
    # (3, 1, 3, 2, 1, 8, 2): the second 3, 1 and 2 never win.
    assert places <= {0, 1, 2, 4, 6} and {1, 2} <= places


def test_scan_cases_reach_what_they_name():
    """The cases hold what they are there for: matches at every offset kind
    (first, far, past the halo), none on random bytes."""
    def off(name):
        buf, offsets = MATCH_CASES[name]
        return zstd_match.match_candidates(torch.from_numpy(buf.copy()),
                                           _offsets(offsets)).numpy()

    assert (off("all zero")[1:-3] == 1).all() and off("all zero")[0] == 0
    assert (off("random") == 0).mean() > 0.99
    assert off("period 1024, n=1028")[1024] == 1024
    assert not off("period 1024, n=1027").any()
    assert set(np.unique(off("offsets past the halo"))) == {0, 5000}
    assert 1 in off("unsorted offsets") and 2 not in off("unsorted offsets")


@pytest.mark.parametrize("name", ["svb payload", "text", "period 1024, n=5",
                                  "period 1024, n=3", "unsorted offsets"])
def test_build_match_index_matches_tpu(name):
    buf, offsets = MATCH_CASES[name]
    offsets = _offsets(offsets)
    prev, v4 = zstd_match.build_match_index_device(buf, offsets, "cpu")
    jprev, jv4 = zstd_match_tpu.build_match_index_tpu(buf, offsets)
    assert prev.dtype == jprev.dtype and v4.dtype == jv4.dtype
    np.testing.assert_array_equal(prev, jprev)
    np.testing.assert_array_equal(v4, jv4)


def test_scan_takes_bytes_only():
    """A deliberate difference: the JAX function also takes int32 buffers;
    the port's scan takes uint8 (every caller hands it a byte buffer), at
    most MAX_OFFSETS offsets, and refuses offsets below 1 and devices other
    than the CPU and CUDA."""
    with pytest.raises(ValueError, match="uint8"):
        zstd_match.match_candidates(torch.zeros(9, dtype=torch.int32))
    with pytest.raises(ValueError, match="uint8"):
        zstd_match.match_candidates_plain(torch.zeros(3, 3,
                                                      dtype=torch.uint8))
    with pytest.raises(ValueError, match=">= 1"):
        zstd_match.match_candidates(torch.zeros(9, dtype=torch.uint8), (1, 0))
    many = tuple(range(1, zstd_match.MAX_OFFSETS + 2))
    with pytest.raises(ValueError, match="at most"):
        zstd_match.match_candidates(torch.zeros(999, dtype=torch.uint8), many)
    assert not zstd_match.match_candidates(
        torch.zeros(999, dtype=torch.uint8), many[:-1])[:1].any()
    with pytest.raises(ValueError, match="meta"):
        zstd_match.match_candidates(torch.zeros(9, dtype=torch.uint8,
                                                device="meta"))


def test_index_takes_what_the_scan_takes():
    """The index's wrapper and plain version refuse what the int32 scan
    refuses; a uint8 place holds at most MAX_OFFSETS (255) offsets."""
    assert zstd_match.MAX_OFFSETS == 255
    many = tuple(range(1, zstd_match.MAX_OFFSETS + 2))
    for fn in (zstd_match.match_index, zstd_match.match_index_plain):
        with pytest.raises(ValueError, match="uint8"):
            fn(torch.zeros(9, dtype=torch.int32))
        with pytest.raises(ValueError, match=">= 1"):
            fn(torch.zeros(9, dtype=torch.uint8), (1, 0))
        with pytest.raises(ValueError, match="at most"):
            fn(torch.zeros(999, dtype=torch.uint8), many)
        index = fn(torch.zeros(999, dtype=torch.uint8), many[:-1])
        assert index.dtype == torch.uint8 and int(index[1]) == 1
        assert int(index[:1].sum()) == 0
    with pytest.raises(ValueError, match="meta"):
        zstd_match.match_index(torch.zeros(9, dtype=torch.uint8,
                                           device="meta"))


def test_scan_reads_views_at_any_offset():
    """The payload may sit at any storage offset, and np.frombuffer(bytes)
    is read-only: the index copies it."""
    buf, _ = MATCH_CASES["svb payload"]
    want = zstd_match.match_candidates(torch.from_numpy(buf.copy()))
    for shift in (1, 2, 3):
        big = torch.zeros(buf.size + shift, dtype=torch.uint8)
        big[shift:] = torch.from_numpy(buf.copy())
        assert torch.equal(zstd_match.match_candidates(big[shift:]), want)
    ro = np.frombuffer(buf.tobytes(), np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        prev, _ = zstd_match.build_match_index_device(ro, device="cpu")
    np.testing.assert_array_equal(
        prev, zstd_match_tpu.build_match_index_tpu(buf)[0])


# ---------------------------------------------------------------------------
# Frames: every input of tests/test_zstd_seq.py and tests/test_zstd_huff.py
# ---------------------------------------------------------------------------


def _seq_inputs() -> dict:
    out = {
        "empty": b"", "tiny": b"x", "small_repeat": b"abcabcabcabc",
        "text": b"the quick brown fox jumps over the lazy dog. " * 3000,
        "periodic": bytes(np.tile(np.arange(64, dtype=np.uint8), 2000)),
        "all_zero": b"\x00" * 100000,
        "random": np.random.default_rng(0).integers(
            0, 256, 50000).astype(np.uint8).tobytes(),
    }
    rng = np.random.default_rng(0)
    sig = np.clip(500 + np.cumsum(rng.normal(0, 12, 200000)), -2000,
                  2000).astype(np.int16)
    out["svb_signal"] = scalar.svb_compress(sig, 2, True, 0)
    unit = np.random.default_rng(1).integers(0, 256, 70000).astype(
        np.uint8).tobytes()
    out["multiblock"] = unit * 5
    lits = np.random.default_rng(2).integers(0, 256, 300).astype(np.uint8)
    out["sequence_lengths"] = lits.tobytes() + lits.tobytes() * 20
    base = np.random.default_rng(3).integers(0, 256, 5000).astype(np.uint8)
    out["match_finder"] = np.concatenate(
        [base, base[:2000], base[1000:3000]]).tobytes()
    out["tpu_text"] = b"the quick brown fox jumps over the lazy dog. " * 1000
    out["tpu_periodic"] = bytes(np.tile(np.arange(64, dtype=np.uint8), 1500))
    rng = np.random.default_rng(6)
    sig = np.clip(500 + np.cumsum(rng.normal(0, 12, 120000)), -2000,
                  2000).astype(np.int16)
    out["tpu_ratio"] = scalar.svb_compress(sig, 2, True, 0)
    rng = np.random.default_rng(9)
    out["parity_svb"] = scalar.svb_compress(np.clip(500 + np.cumsum(
        rng.normal(0, 12, 200_000)), -2000, 2000).astype(np.int16), 2,
        True, 0)
    out["parity_repeat"] = b"abcabcabcabc" * 400
    out["parity_random"] = rng.integers(0, 256, 3000).astype(
        np.uint8).tobytes() * 3
    return out


def _huff_inputs() -> dict:
    rng = np.random.default_rng(0)
    out = {}
    out["skewed"] = rng.choice(
        np.arange(8, dtype=np.uint8),
        p=[.5, .2, .1, .08, .05, .04, .02, .01], size=5000).tobytes()
    out["text"] = bytes(rng.choice(list(b"abcdefgh etaoinshrdlu."),
                                   size=24000))
    out["uniform"] = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    out["constant"] = b"\x07" * 5000
    out["empty"] = b""
    out["tiny"] = b"ab"
    out["runs"] = b"\x00" * 100 + b"abcabc" * 50 + b"\xff" * 1000
    out["large"] = rng.choice(np.arange(16, dtype=np.uint8),
                              size=600_000).tobytes()
    sig = np.clip(500 + np.cumsum(rng.normal(0, 12, 100_000)), -2000,
                  2000).astype(np.int16)
    out["svb_payload"] = scalar.svb_compress(sig, 2, True, 0)
    rng = np.random.default_rng(5)
    p = np.r_[np.full(64, 12.0), np.full(192, 1.0)]
    out["wide_alphabet"] = rng.choice(np.arange(256, dtype=np.uint8),
                                      p=p / p.sum(), size=50_000).tobytes()
    return out


FRAME_INPUTS = {**{"seq " + k: v for k, v in _seq_inputs().items()},
                **{"huff " + k: v for k, v in _huff_inputs().items()}}


def _jax_numpy_path():
    """The JAX package's encoder with its native branches off."""
    return (mock.patch.object(jax_seq, "_native_lz", lambda: None),
            mock.patch.object(jax_huff, "_native_bits", lambda: None))


def _decodes(frame: bytes, data: bytes) -> None:
    back = zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=max(len(data), 1))
    assert back == data


@pytest.mark.parametrize("name", list(FRAME_INPUTS))
def test_frames_match_jax(name):
    """The port's huffman-only, host-matcher and device-matcher frames equal
    the JAX package's, on its default path and on its NumPy path."""
    data = FRAME_INPUTS[name]
    ours = {"huff": zstd_huff.compress_frame(data),
            "host": zstd_seq.compress_frame(data, matcher="host"),
            "device": zstd_seq.compress_frame(data, matcher="device",
                                              device="cpu")}

    def theirs():
        return {"huff": jax_huff.compress_frame(data),
                "host": jax_seq.compress_frame(data, matcher="host"),
                "device": jax_seq.compress_frame(data, matcher="tpu")}

    default = theirs()
    a, b = _jax_numpy_path()
    with a, b:
        numpy_path = theirs()
    assert ours == numpy_path
    assert ours == default
    for frame in ours.values():
        _decodes(frame, data)


def test_matcher_names():
    with pytest.raises(ValueError, match="matcher"):
        zstd_seq.compress_frame(b"abcabcabc", matcher="tpu")


def test_fse_primitives_match_jax():
    """Normalised counts, their serialisation and the weight compressor of
    the port's fse copy equal the original's (the inputs of
    test_fse_primitives_roundtrip and test_fse_norm_count_serialization)."""
    rng = np.random.default_rng(7)
    for _ in range(30):
        w = rng.integers(0, 12, int(rng.integers(4, 250)))
        assert fse.compress_weights(w) == jax_fse.compress_weights(w)
    rng = np.random.default_rng(8)
    for _ in range(50):
        nsym = int(rng.integers(2, 30))
        freqs = rng.integers(0, 50, nsym)
        freqs[rng.integers(0, nsym)] += 50
        if (freqs > 0).sum() < 2:
            continue
        norm = fse.normalize_counts(freqs, 6)
        np.testing.assert_array_equal(norm, jax_fse.normalize_counts(freqs,
                                                                     6))
        assert fse.write_norm_counts(norm, 6) == jax_fse.write_norm_counts(
            norm, 6)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

# cd_values and the content the pipeline gets for each.
PIPE_OPTIONS = [((0, 2, 1, 1), np.int16), ((0, 4, 1, 1), np.int32),
                ((1, 1, 1, 1), np.int8)]


def _signals(dtype, seed):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    walk = np.cumsum(rng.normal(0, min(12, info.max / 20), 30000))
    return [np.clip(walk, info.min, info.max).astype(dtype),
            rng.integers(info.min, info.max + 1, 2501).astype(dtype),
            np.zeros(0, dtype), np.full(7, 3, dtype)]


@pytest.fixture
def torch_cpu(monkeypatch):
    monkeypatch.setenv("VBZ_BACKEND", "torch")


@pytest.mark.parametrize("encoder", ["own", "own-tpu"])
@pytest.mark.parametrize("cd,dtype", PIPE_OPTIONS, ids=str)
def test_pipeline_frames_match_jax(torch_cpu, monkeypatch, encoder, cd,
                                   dtype):
    monkeypatch.setenv("VBZ_ZSTD_ENCODER", encoder)
    ours, theirs = PortOptions.from_cd_values(cd), \
        CompressionOptions.from_cd_values(cd)
    chunks = _signals(dtype, seed=sum(cd))
    frames = api.vbz_compress_sized_batch(chunks, ours)
    for c, f in zip(chunks, frames):
        want = jax_api.vbz_compress_sized(c, theirs, backend=JAX_BACKEND)
        assert f == want
        assert api.vbz_compress_sized(c, ours) == want
        np.testing.assert_array_equal(
            np.frombuffer(api.vbz_decompress_sized(f, ours), dtype), c)
    monkeypatch.setenv("VBZ_ZSTD_ENCODER", "libzstd")
    assert api.vbz_compress_sized(chunks[0], ours) != frames[0]
    for c, b in zip(chunks, api.vbz_decompress_sized_batch(frames, ours)):
        np.testing.assert_array_equal(np.frombuffer(b, dtype), c)


@pytest.mark.parametrize("encoder", ["own", "own-tpu"])
def test_corpus_driver_frames_match_jax(monkeypatch, encoder):
    """compress_signals at (0,2,1,1) (the driver takes 16-bit signals only)
    on the walks of tests/test_multihost.py: the JAX driver's frames."""
    monkeypatch.setenv("VBZ_ZSTD_ENCODER", encoder)
    rng = np.random.default_rng(1)
    sigs = [np.clip(500 + np.cumsum(rng.normal(0, 12, n)), -2000,
                    2000).astype(np.int16) for n in (30_000, 70_000, 16_384)]
    cd = (0, 2, 1, 1)
    got = multihost.compress_signals(sigs, PortOptions.from_cd_values(cd),
                                     device="cpu")
    assert got == jax_multihost.compress_signals(
        sigs, CompressionOptions.from_cd_values(cd), plane="xla")
    backend = TorchSvbBackend("cpu")
    for s, f in zip(sigs, got):
        np.testing.assert_array_equal(np.frombuffer(api.vbz_decompress_sized(
            f, PortOptions.from_cd_values(cd), backend=backend), np.int16), s)


def test_encoder_choice(monkeypatch):
    """The level-2 warning of the single-profile encoders, the ValueError
    for an unknown name, and the scan's device: the backend's, else the
    card, else the CPU under VBZ_BACKEND=torch; with neither it raises."""
    data = bytes(np.tile(np.arange(50, dtype=np.uint8), 40))
    for encoder in ("own", "own-tpu"):
        with pytest.warns(UserWarning, match="single-profile"):
            frame = api.zstd_compress(data, 2, encoder, device="cpu")
        assert frame == api.zstd_compress(data, 1, encoder, device="cpu")
        _decodes(frame, data)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        api.zstd_compress(data, 1, "own")
    monkeypatch.setenv("VBZ_ZSTD_ENCODER", "zlib")
    with pytest.raises(ValueError, match="unknown zstd encoder"):
        api.zstd_compress(data, 1)
    with pytest.raises(ValueError, match="unknown zstd encoder"):
        api.vbz_compress_sized(np.arange(9, dtype=np.int16),
                               PortOptions(True, 2, 1, 0),
                               backend=TorchSvbBackend("cpu"))
    monkeypatch.setenv("VBZ_ZSTD_ENCODER", "own-tpu")
    monkeypatch.delenv("VBZ_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="VBZ_BACKEND=torch"):
        api.zstd_compress(data, 1)
    assert api.scan_device(TorchSvbBackend("cpu")).type == "cpu"
    monkeypatch.setenv("VBZ_BACKEND", "torch")
    assert api.zstd_compress(data, 1) == frame
    monkeypatch.delenv("VBZ_BACKEND")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert api.scan_device().type == "cuda"
