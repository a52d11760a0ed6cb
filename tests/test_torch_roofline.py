"""The port's roofline module (``vbz_compression_tpu_torch.utils.roofline``)
against the JAX package's: kernel CP's plain version against the Pallas
``copy_blocked`` in interpret mode, the refusal of a ragged row count beside
the Pallas kernel's unwritten tail, the bytes a codec call must move against
hand counts and against the reckoning ``chip_smoke.time_pair`` made before
it moved here, and the card-only measurement raising without a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vbz_compression_tpu.utils import roofline as jax_roofline
from vbz_compression_tpu_torch import signals
from vbz_compression_tpu_torch.ops import svb_v1, svb_w2, svb_w4
from vbz_compression_tpu_torch.utils import roofline


def _rows(R, seed):
    return np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, (R, 128), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("R,rows", [(1024, 256), (512, 512), (768, 128),
                                    (96, 32)])
def test_copy_plain_matches_pallas(R, rows):
    x = _rows(R, R + rows)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_roofline.copy_blocked(jnp.asarray(x), rows=rows))
    before = roofline.COPY_LAUNCHES
    got = roofline.copy_blocked(torch.from_numpy(x), rows)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(roofline.copy_blocked_plain(
        torch.from_numpy(x)).numpy(), x)
    assert roofline.COPY_LAUNCHES == before  # the CPU runs the plain version


def test_ragged_row_count_raises_where_pallas_leaves_a_tail():
    """The Pallas grid of R // rows blocks never writes the last R % rows
    rows; the port refuses such a shape (ROADMAP Queue 3)."""
    R, rows = 1000, 256
    x = np.arange(R * 128, dtype=np.int32).reshape(R, 128)
    with pltpu.force_tpu_interpret_mode():
        jout = np.asarray(jax_roofline.copy_blocked(jnp.asarray(x),
                                                    rows=rows))
    done = R // rows * rows
    np.testing.assert_array_equal(jout[:done], x[:done])
    assert not np.array_equal(jout[done:], x[done:])
    with pytest.raises(ValueError, match="not a multiple"):
        roofline.copy_blocked(torch.from_numpy(x), rows)


@pytest.mark.parametrize("bad,rows", [
    (torch.zeros(8, 128, dtype=torch.int64), 8),
    (torch.zeros(8, 64, dtype=torch.int32), 8),
    (torch.zeros(8 * 128, dtype=torch.int32), 8),
    (torch.zeros(8, 128, dtype=torch.int32), 0)])
def test_copy_rejects_bad_arguments(bad, rows):
    with pytest.raises(ValueError):
        roofline.copy_blocked(bad, rows)


def test_copy_of_no_rows():
    x = torch.zeros(0, 128, dtype=torch.int32)
    assert roofline.copy_blocked(x, 8).shape == (0, 128)


def _time_pair_bytes(x, lens, keys, data_len):
    """chip_smoke.time_pair's reckoning before it moved to roofline."""
    raw = x.numel() * x.element_size()
    stream = keys.numel() + int(data_len.sum())
    return (raw + lens.nbytes + stream + data_len.nbytes,
            stream + lens.nbytes + raw)


def _encode(mod_encode, rows, flavor):
    x = torch.from_numpy(np.ascontiguousarray(rows))
    lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32)
    keys, _, data_len = mod_encode(x, lens, flavor)
    return x, lens, keys, data_len


@pytest.mark.parametrize("flavor,rows,data_len,enc,dec", [
    # 8 one-byte values; then one one-byte and seven two-byte values.
    ("zz16", np.array([[0, 1, 2, 3, 4, 5, 6, 7],
                       [0, 300, 0, 300, 0, 300, 0, 300]], np.int16),
     [8, 15], 32 + 8 + (4 + 23) + 8, (4 + 23) + 8 + 32),
    # 1, 2, 3 and 4 bytes.
    ("none32", np.array([[1, 256, 65536, 1 << 24]], np.int32),
     [10], 16 + 4 + 11 + 4, 11 + 4 + 16),
    # four values without nibbles, four of one nibble: two data bytes.
    ("v1 none8", np.array([[0, 0, 0, 0, 5, 5, 5, 5]], np.int8),
     [2], 8 + 4 + 4 + 4, 4 + 4 + 8)])
def test_codec_bytes_hand_counts(flavor, rows, data_len, enc, dec):
    mod = {"zz16": svb_w2, "none32": svb_w4, "v1 none8": svb_v1}[flavor]
    encode = {svb_w2: svb_w2.encode_w2_rows, svb_w4: svb_w4.encode_w4_rows,
              svb_v1: svb_v1.encode_v1_rows}[mod]
    x, _, keys, got_len = _encode(encode, rows, flavor.split()[-1])
    assert got_len.tolist() == data_len
    assert roofline.codec_bytes(x, keys, got_len) == (enc, dec)


@pytest.mark.parametrize("flavor", ["zz16", "zz8", "zz32", "none32", "none16",
                                    "none8", "v1 zz8", "v1 none8"])
def test_codec_bytes_match_chip_smoke_reckoning(flavor):
    name = flavor.split()[-1]
    dtype = {"zz16": np.int16, "zz8": np.int8, "zz32": np.int32,
             "none32": np.int32, "none16": np.int16, "none8": np.int8}[name]
    rng = np.random.default_rng(len(flavor))
    rows = np.stack([signals.uniform(rng, 4096, dtype),
                     np.cumsum(rng.integers(-9, 9, 4096)).astype(dtype)])
    if flavor.startswith("v1"):
        encode = svb_v1.encode_v1_rows
    elif name in ("zz16", "zz8"):
        encode = svb_w2.encode_w2_rows
    else:
        encode = svb_w4.encode_w4_rows
    x, lens, keys, data_len = _encode(encode, rows, name)
    assert roofline.codec_bytes(x, keys, data_len) == _time_pair_bytes(
        x, lens, keys, data_len)


def test_bounds():
    assert roofline.HBM_PEAK_GB_S == 3350.0
    assert roofline.bound_ms(3.35e9) == pytest.approx(1.0)
    assert roofline.bound_ms(3_350_000) == pytest.approx(1e-3)


def test_measure_copy_gbps_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        roofline.measure_copy_gbps(1, 8)
