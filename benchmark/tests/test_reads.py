import hashlib

import numpy as np
import pytest
import torch

from benchmark.harness import reads, reference
from vbz_compression_tpu_torch.ops import scalar

SPEC = {"count": 12, "shortest": 30_000, "longest": 200_000, "dwell": 9,
        "level_mean": 500, "level_sd": 70, "noise_sd": 10, "clip": 2000}
SMALL = dict(SPEC, count=7, shortest=5, longest=3000)
# The planned multi-read file of ultra-long reads (4,000 reads, ONT's
# ultra-long protocol at 9 samples a base), and a few reads of its shape.
ULTRALONG = dict(SPEC, count=4000, shortest=4_500, longest=7_938_000,
                 lengths={"kind": "lognormal", "median": 270_000,
                          "n50": 900_000})
LOGNORMAL = dict(SPEC, count=9, shortest=5, longest=6_000,
                 lengths={"kind": "lognormal", "median": 600, "n50": 2_000})

# sha256[:16] of the lengths, the values, and the streams' bytes, starts and
# lengths, as the parent's single draw and single-pass encode made them.
DIGESTS = {
    ("SPEC", 0): ("fcd0899bd26f7467", "ef1025b3fec035ec", "ebf853204bbf4788"),
    ("SPEC", 7): ("da7c27c1c1ef3a1b", "e0b2a2313c9ee86e", "6e6c95f09c2bf102"),
    ("SPEC", 2**31 + 1): ("ab1dc18e06fab755", "f6f3eee899416a44",
                          "75bebffb4a8f7573"),
    ("SMALL", 0): ("ee13334da241b335", "b1f8749a3ea114c3", "2ca11f00861736d8"),
    ("SMALL", 7): ("b13d85b6b1388d3c", "e629bba800c34ccd", "4a11c845709f4708"),
    ("SMALL", 2**31 + 1): ("c3b658592966f7f2", "f8f2ebc9e3808aec",
                           "2ea682b41d4baac7"),
}


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def n50(lengths) -> int:
    """The length at which reads that long or longer hold half the
    samples."""
    desc = np.sort(lengths)[::-1]
    held = np.cumsum(desc)
    return int(desc[np.searchsorted(held, held[-1] / 2)])


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
    lengths = reads.multiset(dict(SPEC, count=435))
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


@pytest.mark.parametrize("name,seed", sorted(DIGESTS))
def test_even_sets_and_streams_are_pinned(name, seed):
    spec = {"SPEC": SPEC, "SMALL": SMALL}[name]
    rs = reads.make(spec, seed, "cpu")
    st = reference.encode(rs.values, rs.starts, rs.lengths)
    assert (digest(rs.lengths), digest(rs.values.numpy()),
            digest(st.flat.numpy(), st.starts, st.lengths)) == \
        DIGESTS[name, seed]


def test_even_kind_named_is_the_default():
    a = reads.make(SMALL, 3, "cpu")
    b = reads.make(dict(SMALL, lengths={"kind": "even"}), 3, "cpu")
    assert np.array_equal(a.lengths, b.lengths)
    assert torch.equal(a.values, b.values)


def test_lognormal_seeds_share_lengths_in_another_order():
    a = reads.lengths_for(ULTRALONG, 1)
    b = reads.lengths_for(ULTRALONG, 2**31 + 3)
    assert len(a) == 4000
    assert np.array_equal(np.sort(a), np.sort(b))
    assert not np.array_equal(a, b)


def test_lognormal_lengths_follow_the_spec():
    shape = ULTRALONG["lengths"]
    lengths = reads.multiset(ULTRALONG)
    assert lengths.min() >= ULTRALONG["shortest"]
    assert lengths.max() == ULTRALONG["longest"]
    assert int((lengths == ULTRALONG["longest"]).sum()) == 1
    assert abs(np.median(lengths) / shape["median"] - 1) < 0.01
    assert abs(n50(lengths) / shape["n50"] - 1) < 0.05
    narrow = reads.multiset(dict(ULTRALONG, shortest=200_000,
                                 longest=400_000))
    assert narrow.min() >= 200_000 and narrow.max() == 400_000
    assert np.median(narrow) > shape["median"]


@pytest.mark.parametrize("shape", [
    {"kind": "even", "shortest": 5},
    {"kind": "lognormal", "median": 600, "n50": 2_000, "longest": 6_000},
    {"kind": "lognormal", "median": 600},
    {"kind": "uniform"},
    {"kind": "../configs/fast5_zstd1"},
], ids=["even-bound", "lognormal-bound", "lognormal-no-n50", "unknown",
        "path"])
def test_lengths_spec_refused(shape):
    """A bound is the group's alone, a shape's keys are its file's, and a
    kind names a file of ``lengths/``."""
    with pytest.raises((ValueError, KeyError)):
        reads.multiset(dict(LOGNORMAL, lengths=shape))


def test_a_new_distribution_is_a_new_file(tmp_path, monkeypatch):
    from benchmark.harness import cell

    (tmp_path / "lengths").mkdir()
    (tmp_path / "lengths" / "listed.py").write_text(
        "import numpy as np\n"
        "def multiset(spec):\n"
        "    return np.array(spec['lengths']['each'], np.int64)\n")
    monkeypatch.setattr(cell, "BENCH", tmp_path)
    spec = dict(SPEC, count=3, lengths={"kind": "listed",
                                        "each": [7, 3000, 40]})
    rs = reads.make(spec, 2**31 + 5, "cpu")
    assert sorted(rs.lengths.tolist()) == [7, 40, 3000]
    assert rs.values.numel() == 3047


def test_pieces_hold_whole_reads_up_to_the_piece():
    lengths = np.array([5, 5, 20, 5, 4, 1, 11])
    assert reads.pieces(lengths, 10) == [(0, 2), (2, 3), (3, 6), (6, 7)]
    assert reads.pieces(lengths, 100) == [(0, 7)]
    assert reads.pieces(lengths[:0], 10) == []


@pytest.mark.parametrize("spec", [SPEC, LOGNORMAL], ids=["even", "lognormal"])
@pytest.mark.parametrize("piece", [1, 50_000, 250_000])
def test_encoding_in_pieces_is_one_pass(spec, piece):
    rs = reads.make(spec, 2**31 + 13, "cpu")
    whole = reference.encode(rs.values, rs.starts, rs.lengths,
                             piece=2**62)
    parts = reference.encode(rs.values, rs.starts, rs.lengths, piece=piece)
    assert torch.equal(parts.flat, whole.flat)
    assert np.array_equal(parts.starts, whole.starts)
    assert np.array_equal(parts.lengths, whole.lengths)


@pytest.mark.parametrize("spec,piece", [(SMALL, 4000), (LOGNORMAL, 3000)],
                         ids=["even", "lognormal"])
def test_set_drawn_in_pieces(spec, piece):
    """The pieces draw in turn from one generator, each as the whole set's
    draw over its samples alone; one piece, as the pinned sets are, is the
    single draw; a seed gives the same set again, and every read stays
    within its clip."""
    seed = 2**31 + 17
    rs = reads.make(spec, seed, "cpu", piece=piece)
    parts = reads.pieces(rs.lengths, piece)
    assert len(parts) > 2
    gen = torch.Generator().manual_seed(seed)
    drawn = [reads._squiggle(spec, int(rs.lengths[r0:r1].sum()), gen,
                             "cpu") for r0, r1 in parts]
    assert torch.equal(rs.values, torch.cat(drawn))
    assert torch.equal(rs.values, reads.make(
        spec, seed, "cpu", piece=piece).values)
    one = reads.make(spec, seed, "cpu", piece=2**62).values
    assert torch.equal(one, reads._squiggle(
        spec, rs.values.numel(), torch.Generator().manual_seed(seed), "cpu"))
    assert not torch.equal(rs.values, one)
    assert int(rs.values.abs().max()) <= 2000


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 1])
def test_lognormal_streams_are_the_oracles(seed):
    rs = reads.make(LOGNORMAL, seed, "cpu", piece=3000)
    streams = reference.encode(rs.values, rs.starts, rs.lengths, piece=3000)
    for r, s in zip(rs.host(), streams.host()):
        assert s == scalar.svb_compress(r, 2, True, 0)
        t = torch.frombuffer(bytearray(s), dtype=torch.uint8)
        assert np.array_equal(reference.decode(t, r.size).numpy(), r)
