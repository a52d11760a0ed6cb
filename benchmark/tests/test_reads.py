import numpy as np
import pytest
import torch

from benchmark.harness import reads, reference
from vbz_compression_tpu_torch.ops import scalar

SPEC = {"count": 12, "shortest": 30_000, "longest": 200_000, "dwell": 9,
        "level_mean": 500, "level_sd": 70, "noise_sd": 10, "clip": 2000}
SMALL = dict(SPEC, count=7, shortest=5, longest=3000)


def test_same_seed_same_set():
    a = reads.make(SMALL, 2**31 + 11, "cpu")
    b = reads.make(SMALL, 2**31 + 11, "cpu")
    assert np.array_equal(a.lengths, b.lengths)
    assert torch.equal(a.values, b.values)


def test_seeds_share_lengths_in_another_order():
    a = reads.make(SPEC, 1, "cpu")
    b = reads.make(SPEC, 2**31 + 3, "cpu")
    assert sorted(a.lengths) == sorted(b.lengths)
    assert not np.array_equal(a.lengths, b.lengths)
    assert not torch.equal(a.values[:1000], b.values[:1000])


def test_lengths_within_the_range():
    lengths = reads.lengths_of(435, 30_000, 200_000)
    assert lengths.min() >= 30_000 and lengths.max() <= 200_000
    assert abs(2 * lengths.sum() - 100e6) < 0.001 * 100e6


def test_squiggle_within_its_clip():
    rs = reads.make(SMALL, 5, "cpu")
    for r in rs.host():
        assert r.dtype == np.int16 and np.abs(r).max() <= 2000
        assert abs(int(r.mean()) - 500) < 200


def test_squiggle_needs_two_byte_codes_and_never_sticks():
    """Some deltas need two-byte codes, as real signal's do, and no value
    is pinned: runs of a repeated value stay short."""
    rs = reads.make(dict(SPEC, count=4, longest=60_000), 2**31 + 9, "cpu")
    x = rs.values.to(torch.int32)
    d = (x[1:] - x[:-1]).abs()
    assert 0.01 < float((d >= 128).float().mean()) < 0.05
    assert float((d == 0).float().mean()) < 0.05
    assert int(x.min()) > -2000 and int(x.max()) < 2000


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 1])
def test_reference_streams_are_the_oracles(seed):
    rs = reads.make(SMALL, seed, "cpu")
    streams = reference.encode(rs.values, rs.starts, rs.lengths)
    for r, s in zip(rs.host(), streams.host()):
        assert s == scalar.svb_compress(r, 2, True, 0)
        t = torch.frombuffer(bytearray(s), dtype=torch.uint8)
        reference.validate(t, r.size)
        assert np.array_equal(reference.decode(t, r.size).numpy(), r)


def test_reference_on_wrapping_deltas():
    x = np.array([-32768, 32767, -32768, 0, 1, -1, 300, -300, 32767],
                 np.int16)
    s = reference.encode(torch.from_numpy(x), np.array([0]),
                         np.array([x.size])).host()[0]
    assert s == scalar.svb_compress(x, 2, True, 0)


def test_reference_frames_are_the_ports():
    from vbz_compression_tpu_torch import api
    from vbz_compression_tpu_torch.options import CompressionOptions

    rs = reads.make(dict(SPEC, count=3, longest=40_000), 3, "cpu")
    params = {"windowLog": 19, "chainLog": 14, "hashLog": 16,
              "searchLog": 1, "minMatch": 5, "targetLength": 0,
              "strategy": 2, "contentSizeFlag": 1, "checksumFlag": 0}
    streams = reference.encode(rs.values, rs.starts, rs.lengths).host()
    frames = reference.frames(streams, rs.lengths, params)
    opts = CompressionOptions.from_cd_values((0, 2, 1, 1))
    assert frames == api.vbz_compress_sized_batch(rs.host(), opts)
    for f, r in zip(frames, rs.host()):
        assert np.array_equal(reference.decode_frame(f, 1, "cpu"), r)
