"""The port's v1 half-byte rows (``vbz_compression_tpu_torch.ops.svb_v1``)
against the JAX package's Pallas v1 kernels and the NumPy oracle.

The JAX side runs as ``tests/test_pallas_kernels.py`` runs it, in interpret
mode, on that file's ``test_v1_*`` inputs; the port side runs the plain
PyTorch version, which is what ``encode_v1_rows`` / ``decode_v1_rows`` do for
CPU tensors. Every comparison is exact: the codec is an integer codec. The
kernels themselves run only on a CUDA card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vbz_compression_tpu.ops import pallas_v1 as pv1
from vbz_compression_tpu.ops import scalar
from vbz_compression_tpu_torch import oracle, signals
from vbz_compression_tpu_torch.ops import svb_v1


def _encode(rows: np.ndarray, lens, flavor: str):
    """Port encode of a [B, N] batch on the CPU: per-row wire streams, keys,
    data and byte lengths."""
    keys, data, dlen = svb_v1.encode_v1_rows(
        torch.from_numpy(rows), torch.tensor(lens, dtype=torch.int32), flavor)
    streams = [keys[b, :(n + 3) // 4].numpy().tobytes()
               + data[b, :int(dlen[b])].numpy().tobytes()
               for b, n in enumerate(lens)]
    return streams, keys, data, dlen


def _decode(keys, data, lens, flavor: str) -> np.ndarray:
    return svb_v1.decode_v1_rows(keys, data,
                                 torch.tensor(lens, dtype=torch.int32),
                                 flavor).numpy()


def _case(name: str) -> tuple[np.ndarray, int]:
    """(signal, block) of each test_v1_* test."""
    if name == "signal":
        rng = np.random.default_rng(0)
        return np.clip(np.cumsum(rng.normal(0, 3, 4096)), -100,
                       100).astype(np.int8), 512
    if name == "random":
        rng = np.random.default_rng(7)
        return rng.integers(-128, 128, 4096).astype(np.int8), 1024
    if name == "zero_runs":
        sig = np.zeros(2048, np.int8)
        sig[100:110] = 50
        return sig, 512
    assert name == "all_codes_and_odd_nibbles"
    return signals.v1_odd_nibbles(), 512


@pytest.mark.parametrize("name,flavor", [
    ("signal", "zz8"), ("signal", "none8"), ("random", "zz8"),
    ("random", "none8"), ("all_codes_and_odd_nibbles", "zz8"),
    ("zero_runs", "zz8")])
def test_matches_pallas_v1(name, flavor):
    """Keys, nibble stream and decoded values equal to the Pallas v1
    kernels' and to the oracle's."""
    sig, block = _case(name)
    zz = flavor == "zz8"
    N = sig.size
    ref = scalar.svb_compress(sig, 1, zz, 1)
    assert ref == oracle.svb_compress(sig, 1, zz, 1)
    keysA = np.frombuffer(ref[: N // 4], np.uint8)
    datab = np.frombuffer(ref[N // 4:], np.uint8)
    with pltpu.force_tpu_interpret_mode():
        keys, data, total = pv1.encode_v1(jnp.asarray(sig), block=block,
                                          flavor=flavor)
        jstream = np.asarray(keys).tobytes() + np.asarray(data).astype(
            np.uint8).tobytes()[: (int(total) + 1) // 2]
        noffs = pv1.nib_offsets_from_keys(jnp.asarray(keysA), block)
        jout = pv1.decode_v1(jnp.asarray(keysA),
                             jnp.asarray(datab.astype(np.int8)), noffs,
                             block=block, flavor=flavor)
    streams, pkeys, pdata, _ = _encode(sig[None], [N], flavor)
    assert streams[0] == jstream == ref
    out = _decode(pkeys, pdata, [N], flavor)[0]
    np.testing.assert_array_equal(out, np.asarray(jout))
    np.testing.assert_array_equal(out, sig)


def test_odd_nibble_input_has_odd_prefixes():
    """The all-codes input really puts values on odd nibble offsets at
    1024-value boundaries (the Pallas tests' blocks) and at the starts of
    4-value key bytes."""
    sig = signals.v1_odd_nibbles()
    v = scalar.zigzag_delta_encode(sig, 1)
    nib = np.where(v == 0, 0, np.where(v < 16, 1, np.where(v < 256, 2, 4)))
    starts = np.concatenate([[0], np.cumsum(nib)[:-1]])
    assert (starts[::1024] % 2).any()
    assert (starts[::4] % 2).mean() > 0.2
    assert set(np.unique(nib)) == {0, 1, 2, 4}


_TILE = 4096  # V1E's and V1D's tile (``vbz_v1_encode_tile``)
_TILE_CASES = [
    *((name, f) for name in ("tile edges", "all code 0", "all code 3",
                             "codes cycling", "odd offsets across empty tiles")
      for f in ("zz8", "none8")),
    ("negative", "none8"), ("extremes", "zz8")]


def _tile_case(name: str, flavor: str):
    return next(c[2:] for c in signals.v1_tile_cases(_TILE)
                if c[:2] == (name, flavor))


@pytest.mark.parametrize("name,flavor", _TILE_CASES)
def test_tile_cases_match_oracle(name, flavor):
    """Every signals.v1_tile_cases case at the kernels' 4096-value tile:
    each row's stream is the oracle's on its own prefix, and decode gives
    the row back, zeros past its length."""
    rows, lens = _tile_case(name, flavor)
    streams, keys, data, _ = _encode(rows, lens.tolist(), flavor)
    for b, n in enumerate(lens.tolist()):
        assert streams[b] == oracle.svb_compress(
            rows[b, :n], 1, flavor == "zz8", 1), f"row {b}"
    out = _decode(keys, data, lens.tolist(), flavor)
    valid = np.arange(rows.shape[1])[None] < lens[:, None]
    np.testing.assert_array_equal(out, np.where(valid, rows, 0))


def _pallas_stream(sig: np.ndarray, block: int, flavor: str):
    """The Pallas v1 kernels in interpret mode on ``sig``, padded with
    code-0 values to a whole number of blocks: the stream of ``sig`` and the
    decoded values of the padded row."""
    pad = -sig.size % block
    fill = sig[-1] if flavor == "zz8" else 0   # a delta of 0, or 0
    x = np.concatenate([sig, np.full(pad, fill, np.int8)])
    with pltpu.force_tpu_interpret_mode():
        keys, data, total = pv1.encode_v1(jnp.asarray(x), block=block,
                                          flavor=flavor)
        keys = np.asarray(keys).reshape(-1)
        data = np.asarray(data).astype(np.uint8)[: (int(total) + 1) // 2]
        noffs = pv1.nib_offsets_from_keys(jnp.asarray(keys), block)
        out = pv1.decode_v1(jnp.asarray(keys), jnp.asarray(data.view(np.int8)),
                            noffs, block=block, flavor=flavor)
    return (keys[: (sig.size + 3) // 4].tobytes() + data.tobytes(),
            np.asarray(out)[: sig.size])


@pytest.mark.parametrize("name,flavor,block", [
    ("odd offsets across empty tiles", "zz8", 16384),
    ("odd offsets across empty tiles", "none8", 16384),
    ("codes cycling", "zz8", 4096)])
def test_tile_cases_match_pallas_v1(name, flavor, block):
    """The first odd-offset row (36,868 values) and a codes-cycling row
    (12,296) through the Pallas v1 kernels in interpret mode: the port's
    stream and values equal theirs. The odd-offset row runs in the Pallas
    kernels' own block of 16384: in blocks of 4096 or 512 their stream has
    its first 4096 data bytes 0 (ROADMAP.md, Queue 3)."""
    rows, lens = _tile_case(name, flavor)
    sig = rows[0, :lens[0]]
    want, jout = _pallas_stream(sig, block, flavor)
    streams, keys, data, _ = _encode(sig[None], [sig.size], flavor)
    assert streams[0] == want
    out = _decode(keys, data, [sig.size], flavor)[0]
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, sig)


def test_odd_offset_case_puts_odd_offsets_after_empty_tiles():
    """The odd-offset rows really start 4096-value tiles on odd nibble
    offsets after one and after two empty tiles, start a tile on an odd
    offset with a code-0 value (a code-0 run one value short of a tile),
    and end on an odd count after empty tiles, for both flavors."""
    for flavor in ("zz8", "none8"):
        rows, lens = _tile_case("odd offsets across empty tiles", flavor)
        sig = rows[0, :lens[0]]
        v = (scalar.zigzag_delta_encode(sig, 1) if flavor == "zz8"
             else sig.astype(np.int64) & 0xFFFFFFFF)
        nib = np.where(v == 0, 0, np.where(v < 16, 1, np.where(v < 256, 2, 4)))
        starts = np.concatenate([[0], np.cumsum(nib)])[::_TILE]
        agg = np.add.reduceat(nib, np.arange(0, sig.size, _TILE))
        odd_after = [t for t in range(1, agg.size) if starts[t] % 2]
        empty_before = {t: next(k for k in range(t) if agg[t - 1 - k]) for t
                        in odd_after}
        assert 1 in empty_before.values() and 2 in empty_before.values()
        assert any(nib[t * _TILE] == 0 and agg[t - 1] for t in odd_after)
        assert nib.sum() % 2 == 1 and agg[-1] == 0 and agg[-2] == 0


@pytest.mark.parametrize("flavor", ["zz8", "none8"])
@pytest.mark.parametrize("lens", [(1, 3, 4095), (4, 5, 0), (4093, 4096, 7)])
def test_ragged_rows_match_oracle(flavor, lens):
    """Rows of unlike lengths in one padded batch, with garbage past each
    length: every row encodes as the oracle does on its own prefix (an odd
    nibble count padded with 0), and the tails take code 0 and decode to
    0."""
    rng = np.random.default_rng(23 + sum(lens))
    rows = rng.integers(-128, 128, (3, 4096)).astype(np.int8)
    rows[1] = np.cumsum(rng.integers(-5, 6, 4096)).astype(np.int8)
    streams, keys, data, _ = _encode(rows, lens, flavor)
    for b, n in enumerate(lens):
        assert streams[b] == oracle.svb_compress(
            rows[b, :n], 1, flavor == "zz8", 1), f"row {b}"
        assert not keys[b, (n + 3) // 4:].any()
    out = _decode(keys, data, lens, flavor)
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(out[b, :n], rows[b, :n])
        assert not out[b, n:].any()


def test_decode_stays_inside_data():
    """Keys that claim more nibbles than the data row holds: decode reads
    nothing past the row (missing nibbles read as 0)."""
    sig = np.full(4096, 77, np.int8)  # none8: two nibbles per value
    _, keys, data, _ = _encode(sig[None], [sig.size], "none8")
    out = _decode(keys, data[:, :100].contiguous(), [sig.size], "none8")
    np.testing.assert_array_equal(out[0, :100], sig[:100])
    assert not out[0, 100:].any()


def test_cpu_tensor_runs_plain_and_counts_nothing():
    x = torch.from_numpy(signals.v1_odd_nibbles()[None, :1024])
    n = torch.tensor([1001], dtype=torch.int32)
    before = (svb_v1.ENCODE_LAUNCHES, svb_v1.DECODE_LAUNCHES)
    got = svb_v1.encode_v1_rows(x, n, "zz8")
    for g, w in zip(got, svb_v1.encode_v1_rows_plain(x, n, "zz8")):
        assert torch.equal(g, w)
    out = svb_v1.decode_v1_rows(got[0], got[1], n, "zz8")
    assert torch.equal(out, svb_v1.decode_v1_rows_plain(got[0], got[1], n,
                                                        "zz8"))
    assert (svb_v1.ENCODE_LAUNCHES, svb_v1.DECODE_LAUNCHES) == before


@pytest.mark.parametrize("bad", ["meta_device", "dtype", "width", "lens_dtype",
                                 "flavor"])
def test_rejects_bad_arguments(bad):
    x = torch.zeros(2, 16, dtype=torch.int8)
    lens = torch.tensor([16, 3], dtype=torch.int32)
    keys = torch.zeros(2, 4, dtype=torch.uint8)
    data = torch.zeros(2, 32, dtype=torch.uint8)
    flavor = "zz8"
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
        svb_v1.encode_v1_rows(x, lens, flavor)
    with pytest.raises(ValueError):
        svb_v1.decode_v1_rows(keys, data, lens, flavor)
