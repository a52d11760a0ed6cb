import pytest

from benchmark.harness import counting, reads, reference
from vbz_compression_tpu_torch.models import codec
from vbz_compression_tpu_torch.ops import svb_w2
from vbz_compression_tpu_torch.utils import roofline


def test_live_bytes_on_a_ragged_batch():
    spec = {"count": 3, "shortest": 100, "longest": 4000, "dwell": 9,
            "level_mean": 500, "level_sd": 70, "noise_sd": 10, "clip": 2000}
    rs = reads.make(spec, 4, "cpu")
    streams = reference.encode(rs.values, rs.starts, rs.lengths)
    x, lens = codec.padded_rows(rs.host(), "cpu")
    keys, data, data_len = svb_w2.encode_w2_rows(x, lens, "zz16")
    padded_enc, padded_dec = roofline.codec_bytes(x, keys, data_len)
    live_enc = counting.encode_bytes(rs.lengths, streams.lengths)
    live_dec = counting.decode_bytes(rs.lengths, streams.lengths)
    B, n = len(rs.lengths), int(rs.lengths.sum())
    assert live_dec == int(streams.lengths.sum()) + 4 * B + 2 * n
    assert live_enc == live_dec + 4 * B
    # The padded count takes each row at the longest row's width.
    pad = B * x.shape[1] - n
    assert pad > 0
    assert padded_dec - live_dec == 2 * pad + (keys.numel()
                                               - int(((lens + 3) // 4).sum()))
    assert padded_enc > live_enc


def test_roofline_share():
    assert counting.roofline_pct(3350, 1e-9) == pytest.approx(100.0)
    assert counting.roofline_pct(0, 1.0) is None
    assert counting.roofline_pct(10, 0.0) is None
