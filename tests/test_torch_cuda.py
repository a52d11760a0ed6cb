"""The port's CUDA kernels on the card: E/D (W2), E4/D4 (W4) and V1E/V1D
(v1) against their plain PyTorch versions and, through the backend, against
the port's NumPy oracle; the look-back across tiles of E/D, E4/D4 and
V1E/V1D (tile edges, uniform codes, V1E's half-byte carried across empty
tiles, short data rows, views off alignment, repeated calls);
the copy kernel CP and the capability probe's kernels against their plain
versions, the prefix sum also on tile edges and in repeated calls, the
butterfly at every stage count around its tile edges in one launch; the
data-parallel plane and the corpus driver against the oracle; the match
scan M at both widths against its plain versions (``signals.match_cases``,
the clean payload, views off alignment, repeated calls, threads), the
own-tpu zstd stage's frames against the CPU path's and, with the native
encoder branches, against the NumPy branches'; level-1 frames decoded
through the native C ABI; the main option sets at zstd level 1 through the
api's zstd stage (``libzstd.so.1`` where ``zstandard`` is not installed),
the corpus driver at its defaults and the numpy api on default options,
against the oracle backend through the same stage. Exact.

Every test here is marked ``cuda`` and skips without a card. The file
imports nothing of the JAX package, so it also runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import sys
import threading

import numpy as np
import pytest
import torch

from vbz_compression_tpu_torch import CompressionOptions, api, oracle, signals
from vbz_compression_tpu_torch.models.codec import TorchSvbBackend
from vbz_compression_tpu_torch.ops import (_build, _rows, probes, svb_v1,
                                           svb_w2, svb_w4, zstd_match,
                                           zstd_seq)
from vbz_compression_tpu_torch.parallel import multihost, sharded
from vbz_compression_tpu_torch.tools import capability_probe, kernel_times
from vbz_compression_tpu_torch.utils import roofline

# flavor -> (row module, encode, plain encode, decode, plain decode, dtype)
_ROWS = {
    **{f: (svb_w2, svb_w2.encode_w2_rows, svb_w2.encode_w2_rows_plain,
           svb_w2.decode_w2_rows, svb_w2.decode_w2_rows_plain, dt)
       for f, dt in (("zz16", np.int16), ("zz8", np.int8))},
    **{f: (svb_w4, svb_w4.encode_w4_rows, svb_w4.encode_w4_rows_plain,
           svb_w4.decode_w4_rows, svb_w4.decode_w4_rows_plain, dt)
       for f, dt in (("zz32", np.int32), ("none32", np.int32),
                     ("none16", np.int16), ("none8", np.int8))},
    **{"v1_" + f: (svb_v1, svb_v1.encode_v1_rows, svb_v1.encode_v1_rows_plain,
                   svb_v1.decode_v1_rows, svb_v1.decode_v1_rows_plain,
                   np.int8)
       for f in ("zz8", "none8")},
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _launches(mod):
    return mod.ENCODE_LAUNCHES, mod.DECODE_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_ROWS))
def test_kernels_match_plain_on_card(cuda_device, name):
    mod, enc, enc_plain, dec, dec_plain, dtype = _ROWS[name]
    flavor = name.removeprefix("v1_")
    rng = np.random.default_rng(23)
    lens = np.array([5, 4097, 70000, 0, 65536], np.int32)
    rows = signals.uniform(rng, lens.size * 70000, dtype).reshape(-1, 70000)
    rows[::2] = np.cumsum(rng.integers(-9, 9, (3, 70000)), axis=1).astype(dtype)
    if dtype == np.int8:
        rows[1, :2048] = signals.v1_odd_nibbles()
    x = torch.from_numpy(rows).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    before = _launches(mod)
    k1, d1, l1 = enc(x, n, flavor)
    k0, d0, l0 = enc_plain(x, n, flavor)
    assert torch.equal(k1, k0) and torch.equal(l1, l0)
    written = torch.arange(d0.shape[1], device=cuda_device)[None] < l0[:, None]
    assert torch.equal(torch.where(written, d1, 0), torch.where(written, d0, 0))
    o1 = dec(k1, d1, n, flavor)
    assert torch.equal(o1, dec_plain(k1, d1, n, flavor))
    valid = torch.arange(x.shape[1], device=cuda_device)[None] < n[:, None]
    assert torch.equal(o1, torch.where(valid, x, 0))
    assert _launches(mod) == (before[0] + 1, before[1] + 1)


def _w2_check(x, n, flavor):
    """E and D against their plain versions on x [B, N] with lengths n, bit
    for bit; returns E's outputs."""
    k1, d1, l1 = svb_w2.encode_w2_rows(x, n, flavor)
    k0, d0, l0 = svb_w2.encode_w2_rows_plain(x, n, flavor)
    assert torch.equal(k1, k0) and torch.equal(l1, l0)
    written = torch.arange(d0.shape[1], device=x.device)[None] < l0[:, None]
    assert torch.equal(torch.where(written, d1, 0),
                       torch.where(written, d0, 0))
    o1 = svb_w2.decode_w2_rows(k1, d1, n, flavor)
    assert torch.equal(o1, svb_w2.decode_w2_rows_plain(k1, d1, n, flavor))
    valid = torch.arange(x.shape[1], device=x.device)[None] < n[:, None]
    assert torch.equal(o1, torch.where(valid, x, 0))
    return k1, d1, l1


def _w2_tile_case(name: str, flavor: str):
    """(rows, lens) of signals.w2_tile_cases at the kernels' tile."""
    cases = signals.w2_tile_cases(_build.lib("w2").vbz_w2_tile())
    return next(c[2:] for c in cases if c[:2] == (name, flavor))


@pytest.mark.cuda
@pytest.mark.parametrize("name,flavor", [
    ("tile edges", "zz16"), ("tile edges", "zz8"), ("all code 0", "zz16"),
    ("all code 0", "zz8"), ("all code 1", "zz16"), ("all code 1", "zz8"),
    ("wrap extremes", "zz16")])
def test_w2_lookback_cases_match_plain_on_card(cuda_device, name, flavor):
    """Lengths on tile edges, all-code-0 and all-code-1 content, the int16
    wrap extremes."""
    rows, lens = _w2_tile_case(name, flavor)
    _w2_check(torch.from_numpy(rows).to(cuda_device),
              torch.from_numpy(lens).to(cuda_device), flavor)


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["zz16", "zz8"])
def test_w2_decode_short_data_row_on_card(cuda_device, flavor):
    """Data rows cut shorter than the keys require, inside and between
    tiles: D reads nothing at or past D (the next row's bytes would show),
    and the bytes that are missing read as 0, as in the plain version."""
    rows, lens = _w2_tile_case("all code 1", flavor)
    n = torch.from_numpy(lens).to(cuda_device)
    keys, data, data_len = _w2_check(torch.from_numpy(rows).to(cuda_device),
                                     n, flavor)
    for D in (1, 4095, 8193, int(data_len.min()) - 3):
        short = data[:, :D].contiguous()
        assert torch.equal(svb_w2.decode_w2_rows(keys, short, n, flavor),
                           svb_w2.decode_w2_rows_plain(keys, short, n, flavor))


def _shifted(t, shift):
    """A contiguous copy of t that starts ``shift`` elements into its own
    buffer, so its address sits off the 16-byte alignment."""
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    view = buf[shift:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("flavor,shift", [
    ("zz16", 1), ("zz16", 2), ("zz16", 4), ("zz8", 1), ("zz8", 2),
    ("zz8", 3), ("zz8", 4)])
def test_w2_views_off_alignment_on_card(cuda_device, flavor, shift):
    """Inputs that are contiguous views at a storage offset (int16 2, 4 or 8
    bytes, int8 1-4 bytes past a 16-byte boundary): E reads such rows by
    narrower words or one value at a time, D its keys and data at the same
    shift; both equal the plain versions."""
    rows, lens = _w2_tile_case("tile edges", flavor)
    n = torch.from_numpy(lens).to(cuda_device)
    x = _shifted(torch.from_numpy(rows).to(cuda_device), shift)
    keys, data, _ = _w2_check(x, n, flavor)
    assert torch.equal(
        svb_w2.decode_w2_rows(_shifted(keys, shift), _shifted(data, shift), n,
                              flavor),
        svb_w2.decode_w2_rows_plain(keys, data, n, flavor))


@pytest.mark.cuda
def test_w2_repeated_calls_give_identical_bytes_on_card(cuda_device):
    """A look-back race shows as output that changes from call to call: 20
    calls of E and of D on [4, 4M] give the same bytes, those of the plain
    versions."""
    x = torch.from_numpy(signals.TIERS["realistic"](4, 4 << 20)).to(
        cuda_device)
    n = torch.full((4,), 4 << 20, dtype=torch.int32, device=cuda_device)
    keys, data, data_len = _w2_check(x, n, "zz16")
    written = torch.arange(data.shape[1], device=cuda_device)[None] < \
        data_len[:, None]
    for _ in range(20):
        k, d, l = svb_w2.encode_w2_rows(x, n, "zz16")
        assert torch.equal(k, keys) and torch.equal(l, data_len)
        assert torch.equal(torch.where(written, d, 0),
                           torch.where(written, data, 0))
        assert torch.equal(svb_w2.decode_w2_rows(keys, data, n, "zz16"), x)


def _w4_check(x, n, flavor):
    """E4 and D4 against their plain versions on x [B, N] with lengths n,
    bit for bit; returns E4's outputs."""
    k1, d1, l1 = svb_w4.encode_w4_rows(x, n, flavor)
    k0, d0, l0 = svb_w4.encode_w4_rows_plain(x, n, flavor)
    assert torch.equal(k1, k0) and torch.equal(l1, l0)
    written = torch.arange(d0.shape[1], device=x.device)[None] < l0[:, None]
    assert torch.equal(torch.where(written, d1, 0),
                       torch.where(written, d0, 0))
    o1 = svb_w4.decode_w4_rows(k1, d1, n, flavor)
    assert torch.equal(o1, svb_w4.decode_w4_rows_plain(k1, d1, n, flavor))
    valid = torch.arange(x.shape[1], device=x.device)[None] < n[:, None]
    assert torch.equal(o1, torch.where(valid, x, 0))
    return k1, d1, l1


def _w4_tile_case(name: str, flavor: str, device):
    """(rows, lens) of signals.w4_tile_cases at the tile E4 and D4 share, on
    the card."""
    cases = signals.w4_tile_cases(_build.lib("w4").vbz_w4_decode_tile())
    rows, lens = next(c[2:] for c in cases if c[:2] == (name, flavor))
    return torch.from_numpy(rows).to(device), torch.from_numpy(lens).to(device)


_W4_FLAVORS = ("zz32", "none32", "none16", "none8")


@pytest.mark.cuda
def test_w4_encode_and_decode_share_a_tile_on_card(cuda_device):
    """E4 and D4 cut rows into the same tiles, so the tile-edge lengths of
    signals.w4_tile_cases land on both kernels' edges."""
    lib = _build.lib("w4")
    assert lib.vbz_w4_encode_tile() == lib.vbz_w4_decode_tile() == 4096


@pytest.mark.cuda
@pytest.mark.parametrize("name,flavor", [
    *((name, f) for name in ("tile edges", "all code 0", "all code 3",
                             "codes cycling") for f in _W4_FLAVORS),
    ("wrap extremes", "zz32"), ("negative", "none16"), ("negative", "none8")])
def test_w4_lookback_cases_match_plain_on_card(cuda_device, name, flavor):
    """Lengths on E4's and D4's tile edges (the row's last values share a
    thread with values past the length), one-code and cycling rows, the
    int32 wrap extremes, the none16/none8 sign extremes."""
    _w4_check(*_w4_tile_case(name, flavor, cuda_device), flavor)


@pytest.mark.cuda
@pytest.mark.parametrize("flavor,shift", [
    (f, s) for f in _W4_FLAVORS for s in (1, 2, 3)])
def test_w4_encode_views_off_alignment_on_card(cuda_device, flavor, shift):
    """Inputs that are contiguous views 1-3 elements into their buffer
    (int32 4-12 bytes, int16 2-6, int8 1-3 off a 16-byte boundary): E4 reads
    them one value at a time, equals the plain version, and D4 gives them
    back."""
    x, n = _w4_tile_case("tile edges", flavor, cuda_device)
    _w4_check(_shifted(x, shift), n, flavor)


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", _W4_FLAVORS)
def test_w4_decode_short_data_row_on_card(cuda_device, flavor):
    """Data rows cut shorter than the keys require, inside and between
    tiles: D4 reads nothing at or past D, and missing bytes read as 0, as in
    the plain version."""
    x, n = _w4_tile_case("all code 3", flavor, cuda_device)
    keys, data, data_len = _w4_check(x, n, flavor)
    for D in (1, 4095, 4 * 4096 + 1, int(data_len.min()) - 3):
        short = data[:, :D].contiguous()
        assert torch.equal(svb_w4.decode_w4_rows(keys, short, n, flavor),
                           svb_w4.decode_w4_rows_plain(keys, short, n, flavor))


@pytest.mark.cuda
@pytest.mark.parametrize("flavor,shift", [
    (f, s) for f in _W4_FLAVORS for s in (1, 2, 3)])
def test_w4_decode_into_views_off_alignment_on_card(cuda_device, flavor,
                                                    shift):
    """Outputs that are contiguous views 1-3 elements into their buffer
    (int32, int16 and int8 off the 16-byte alignment): D4 stores them one
    value at a time and gives the plain version's values; keys and data at
    the same shift."""
    x, n = _w4_tile_case("tile edges", flavor, cuda_device)
    keys, data, _ = _w4_check(x, n, flavor)
    out = _shifted(torch.zeros_like(x), shift)
    got = svb_w4.decode_w4_rows(_shifted(keys, shift), _shifted(data, shift),
                                n, flavor, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, svb_w4.decode_w4_rows_plain(keys, data, n, flavor))


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", _W4_FLAVORS)
def test_w4_encode_repeated_calls_give_identical_bytes_on_card(cuda_device,
                                                               flavor):
    """A look-back race shows as output that changes from call to call: 20
    E4 calls on [4, 4M] of each flavor give the same keys, lengths and
    written bytes, those of the plain version."""
    x = torch.from_numpy(kernel_times.w4_rows(flavor, "signal")).to(
        cuda_device)
    n = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                   device=cuda_device)
    keys, data, data_len = _w4_check(x, n, flavor)
    written = torch.arange(data.shape[1], device=cuda_device)[None] < \
        data_len[:, None]
    for _ in range(20):
        k, d, l = svb_w4.encode_w4_rows(x, n, flavor)
        assert torch.equal(k, keys) and torch.equal(l, data_len)
        assert torch.equal(torch.where(written, d, 0),
                           torch.where(written, data, 0))


@pytest.mark.cuda
def test_w4_repeated_calls_give_identical_values_on_card(cuda_device):
    """A look-back race shows as output that changes from call to call: 20
    D4 calls on [4, 4M] zz32 give the same values, the input's."""
    x = torch.from_numpy(kernel_times.w4_rows("zz32", "signal")).to(
        cuda_device)
    n = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                   device=cuda_device)
    keys, data, _ = _w4_check(x, n, "zz32")
    for _ in range(20):
        assert torch.equal(svb_w4.decode_w4_rows(keys, data, n, "zz32"), x)


def _v1_check(x, n, flavor):
    """V1E and V1D against their plain versions on x [B, N] with lengths n,
    bit for bit, and each row's stream against the oracle's; returns V1E's
    outputs."""
    k1, d1, l1 = svb_v1.encode_v1_rows(x, n, flavor)
    k0, d0, l0 = svb_v1.encode_v1_rows_plain(x, n, flavor)
    assert torch.equal(k1, k0) and torch.equal(l1, l0)
    written = torch.arange(d0.shape[1], device=x.device)[None] < l0[:, None]
    assert torch.equal(torch.where(written, d1, 0),
                       torch.where(written, d0, 0))
    o1 = svb_v1.decode_v1_rows(k1, d1, n, flavor)
    assert torch.equal(o1, svb_v1.decode_v1_rows_plain(k1, d1, n, flavor))
    valid = torch.arange(x.shape[1], device=x.device)[None] < n[:, None]
    assert torch.equal(o1, torch.where(valid, x, 0))
    rows, keys, data = x.cpu().numpy(), k1.cpu().numpy(), d1.cpu().numpy()
    for b, cnt in enumerate(n.tolist()):
        stream = (keys[b, :(cnt + 3) // 4].tobytes()
                  + data[b, :int(l1[b])].tobytes())
        assert stream == oracle.svb_compress(rows[b, :cnt], 1,
                                             flavor == "zz8", 1), f"row {b}"
    return k1, d1, l1


def _v1_tile_case(name: str, flavor: str, device):
    """(rows, lens) of signals.v1_tile_cases at the tile V1E and V1D share,
    on the card."""
    cases = signals.v1_tile_cases(_build.lib("v1").vbz_v1_decode_tile())
    rows, lens = next(c[2:] for c in cases if c[:2] == (name, flavor))
    return torch.from_numpy(rows).to(device), torch.from_numpy(lens).to(device)


@pytest.mark.cuda
def test_v1_encode_and_decode_share_a_tile_on_card(cuda_device):
    """V1E and V1D cut rows into the same tiles, so the tile-edge lengths of
    signals.v1_tile_cases land on both kernels' edges."""
    lib = _build.lib("v1")
    assert lib.vbz_v1_encode_tile() == lib.vbz_v1_decode_tile() == 4096


@pytest.mark.cuda
@pytest.mark.parametrize("name,flavor", [
    *((name, f) for name in ("tile edges", "all code 0", "all code 3",
                             "codes cycling",
                             "odd offsets across empty tiles")
      for f in ("zz8", "none8")),
    ("negative", "none8"), ("extremes", "zz8")])
def test_v1_lookback_cases_match_plain_on_card(cuda_device, name, flavor):
    """Lengths on V1E's and V1D's tile edges, one-code and cycling rows, odd
    nibble offsets carried across empty tiles (the shared half-byte), the
    none8 sign extremes and the zz8 delta extremes: equal to the plain
    versions and to the oracle, row by row."""
    _v1_check(*_v1_tile_case(name, flavor, cuda_device), flavor)


@pytest.mark.cuda
@pytest.mark.parametrize("flavor,shift", [
    (f, s) for f in ("zz8", "none8") for s in (1, 2, 3)])
def test_v1_encode_views_off_alignment_on_card(cuda_device, flavor, shift):
    """Inputs that are contiguous views 1-3 bytes into their buffer: V1E
    reads them one value at a time and equals the plain version; V1D reads
    keys and data at the same shift."""
    x, n = _v1_tile_case("tile edges", flavor, cuda_device)
    keys, data, _ = _v1_check(_shifted(x, shift), n, flavor)
    assert torch.equal(
        svb_v1.decode_v1_rows(_shifted(keys, shift), _shifted(data, shift), n,
                              flavor),
        svb_v1.decode_v1_rows_plain(keys, data, n, flavor))


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["zz8", "none8"])
def test_v1_decode_short_data_row_on_card(cuda_device, flavor):
    """Data rows cut shorter than the keys require, at 1 byte, at a tile
    less one and 3 bytes short: V1D reads nothing at or past D, and missing
    nibbles read as 0, as in the plain version."""
    x, n = _v1_tile_case("all code 3", flavor, cuda_device)
    keys, data, data_len = _v1_check(x, n, flavor)
    for D in (1, 4095, int(data_len.min()) - 3):
        short = data[:, :D].contiguous()
        assert torch.equal(svb_v1.decode_v1_rows(keys, short, n, flavor),
                           svb_v1.decode_v1_rows_plain(keys, short, n, flavor))


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["zz8", "none8"])
def test_v1_repeated_calls_give_identical_bytes_on_card(cuda_device, flavor):
    """A look-back race shows as output that changes from call to call: 20
    V1E and V1D calls on [4, 4M] int8 walks give the same keys, lengths,
    written bytes and values, those of the plain version."""
    x = torch.from_numpy(kernel_times.walk8()).to(cuda_device)
    n = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                   device=cuda_device)
    keys, data, data_len = svb_v1.encode_v1_rows(x, n, flavor)
    k0, d0, l0 = svb_v1.encode_v1_rows_plain(x, n, flavor)
    written = torch.arange(data.shape[1], device=cuda_device)[None] < \
        data_len[:, None]
    assert torch.equal(keys, k0) and torch.equal(data_len, l0)
    assert torch.equal(torch.where(written, data, 0),
                       torch.where(written, d0, 0))
    for _ in range(20):
        k, d, l = svb_v1.encode_v1_rows(x, n, flavor)
        assert torch.equal(k, keys) and torch.equal(l, data_len)
        assert torch.equal(torch.where(written, d, 0),
                           torch.where(written, data, 0))
        assert torch.equal(svb_v1.decode_v1_rows(keys, data, n, flavor), x)


@pytest.mark.cuda
@pytest.mark.parametrize("size,zigzag,version", [
    (2, True, 0), (1, True, 0), (4, True, 0), (4, False, 0), (2, False, 0),
    (1, False, 0), (1, True, 1), (1, False, 1)])
def test_backend_batch_matches_oracle_on_card(cuda_device, size, zigzag,
                                              version):
    """One batch call of ragged chunks: one launch sequence per direction,
    every stream the oracle's, every chunk back."""
    rng = np.random.default_rng(31)
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[size]
    chunks = [np.cumsum(rng.integers(-200, 200, n)).astype(dtype)
              for n in (1, 3, 4, 4097, 16385, 200003)]
    chunks.append(np.zeros(0, dtype))
    chunks.append(signals.uniform(rng, 5000, dtype))
    mod = svb_v1 if version == 1 and size == 1 else (
        svb_w2 if zigzag and size < 4 else svb_w4)
    backend = TorchSvbBackend(cuda_device)
    before = _launches(mod)
    streams = backend.svb_compress_batch(chunks, size, zigzag, version)
    outs = backend.svb_decompress_batch(streams, [c.size for c in chunks],
                                        size, zigzag, version)
    assert _launches(mod) == (before[0] + 1, before[1] + 1)
    for c, s, o in zip(chunks, streams, outs):
        assert s == oracle.svb_compress(c, size, zigzag, version), c.size
        assert o.dtype == dtype
        np.testing.assert_array_equal(o, c)


@pytest.mark.cuda
@pytest.mark.parametrize("R,rows", [
    (1 << 16, 8192), (3000, 600), (1000, 1),
    # 4 GiB + 4 KiB: more int4 vectors than one grid of copy.cu covers.
    ((1 << 23) + 8, 8)])
def test_copy_matches_plain_on_card(cuda_device, R, rows):
    gen = torch.Generator(device=cuda_device).manual_seed(R)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (R, 128), dtype=torch.int32,
                      device=cuda_device, generator=gen)
    before = roofline.COPY_LAUNCHES
    assert torch.equal(roofline.copy_blocked(x, rows),
                       roofline.copy_blocked_plain(x))
    assert roofline.COPY_LAUNCHES == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 5, 32768,
                               32769, (1 << 22) + 7])
def test_prefix_sum_matches_plain_on_card(cuda_device, n):
    """Lengths on the prefix sum's tile edges, one cluster of tiles (up to
    32768 values) and beyond it (look-back), full int32 range: one launch
    each, equal to the plain version."""
    x = np.random.default_rng(n).integers(-2 ** 31, 2 ** 31, (1, n),
                                          dtype=np.int64)
    x = torch.from_numpy(x.astype(np.int32)).to(cuda_device)
    before = probes.LAUNCHES["prefix_sum"]
    assert torch.equal(probes.prefix_sum(x), probes.prefix_sum_plain(x))
    assert probes.LAUNCHES["prefix_sum"] == before + 1


@pytest.mark.cuda
def test_prefix_sum_repeated_calls_on_card(cuda_device):
    """20 calls on 4M values (1024 tiles) give the same values, the plain
    version's: a look-back race would make them differ."""
    x = np.random.default_rng(7).integers(-2 ** 31, 2 ** 31, (32768, 128),
                                          dtype=np.int64)
    x = torch.from_numpy(x.astype(np.int32)).to(cuda_device)
    want = probes.prefix_sum_plain(x)
    for _ in range(20):
        assert torch.equal(probes.prefix_sum(x), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4 * 128, 4096 * 128, (1 << 20) + 128,
                               (1 << 20) + 1152])
def test_fetch_i32_matches_plain_on_card(cuda_device, n):
    """fetch_i32's grid covers its array at four int4s a thread (4096
    values a block): under one block, 128 blocks, and one block past 256
    whose threads have one int4 or none, or two or one. One launch each,
    equal to the plain version."""
    data = np.random.default_rng(n).integers(-2 ** 31, 2 ** 31, n + 256,
                                             dtype=np.int64)
    data = torch.from_numpy(data.astype(np.int32)).to(cuda_device)
    before = probes.LAUNCHES["fetch_i32"]
    assert torch.equal(probes.fetch_i32(data, n),
                       probes.fetch_i32_plain(data, n))
    assert probes.LAUNCHES["fetch_i32"] == before + 1


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_card(cuda_device):
    before = dict(probes.LAUNCHES)
    cases = capability_probe.cases(cuda_device)
    for case in cases:
        assert capability_probe.max_abs_err(case.kernel(), case.plain()) == 0
    torch.cuda.synchronize()
    for key in before:
        assert probes.LAUNCHES[key] == before[key] + sum(
            c.key == key for c in cases)


@pytest.mark.cuda
@pytest.mark.parametrize("cd_values", [(0, 2, 1, 0), (0, 2, 0, 0)])
def test_compress_signals_matches_oracle_on_card(cuda_device, cd_values):
    """The corpus driver on the card at zstd level 0: one encode launch per
    bucket (E with zig-zag, E4 without), every frame the oracle's; reads of
    0-7 samples and of whole buckets among pseudo-reads."""
    rng = np.random.default_rng(31)
    reads = signals.pseudo_reads(12) + [
        rng.integers(-3000, 3000, n, dtype=np.int16)
        for n in (1, 2, 3, 4, 5, 6, 7, 4096, 8192, 0)]
    opts = CompressionOptions.from_cd_values(cd_values)
    mod = svb_w2 if opts.perform_delta_zig_zag else svb_w4
    before = mod.ENCODE_LAUNCHES
    frames = multihost.compress_signals(reads, opts, device=cuda_device)
    assert mod.ENCODE_LAUNCHES - before == len(
        {multihost.bucket_of(r.size) for r in reads})
    assert frames == [api.vbz_compress_sized(r, opts, backend=oracle)
                      for r in reads]


@pytest.mark.cuda
@pytest.mark.parametrize("size,zigzag", [(2, True), (2, False), (4, True),
                                         (1, True)])
def test_plane_matches_oracle_on_card(cuda_device, size, zigzag):
    """Both planes without a group on the card: each stream the oracle's,
    every ok true, the rows round-tripped; rows of 0-7 values, of a tile and
    one, and whole rows."""
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[size]
    N = 8192
    lens = np.array([1, 2, 3, 4, 5, 6, 7, N, 4097, 0], np.int32)
    x = signals.uniform(np.random.default_rng(37), lens.size * N,
                        dtype).reshape(-1, N)
    xt = torch.from_numpy(x).to(cuda_device)
    lt = torch.from_numpy(lens).to(cuda_device)
    kw = dict(integer_size=size, use_zigzag=zigzag)
    want = torch.where(torch.arange(N, device=cuda_device)[None]
                       < lt[:, None], xt, 0)
    streams, stream_lens, total = sharded.batch_encode_sharded(xt, lt, **kw)
    host = streams.cpu().numpy()
    for b, n in enumerate(lens):
        assert host[b, :int(stream_lens[b])].tobytes() == \
            oracle.svb_compress(x[b, :n], size, zigzag, 0)
    assert int(total) == int(stream_lens.sum())
    out, ok = sharded.batch_decode_sharded(streams, lt, stream_lens,
                                           out_n=N, **kw)
    assert bool(ok.all()) and torch.equal(out, want)
    keys, data, data_len, rows_total = sharded.batch_encode_sharded_rows(
        xt, lt, **kw)
    assert int(rows_total) == int(data_len.sum()) + lens.size * N // 4
    assert torch.equal(sharded.batch_decode_sharded_rows(keys, data, lt,
                                                         **kw), want)


@pytest.mark.cuda
def test_plane_in_world1_nccl_group_on_card(cuda_device):
    """The plane's collectives in a world-1 NCCL group: the gathered
    lengths and ``ok`` are the local ones, the totals their sums, the bytes
    those of the plane without a group."""
    import torch.distributed as dist

    lens = np.array([1, 7, 4096, 8192], np.int32)
    x = torch.from_numpy(signals.uniform(np.random.default_rng(41), 4 * 8192,
                                         np.int16).reshape(4, 8192))
    xt, lt = x.to(cuda_device), torch.from_numpy(lens).to(cuda_device)
    alone = sharded.batch_encode_sharded(xt, lt)
    group = multihost.initialize(multihost.local_init_method(), 1, 0, "nccl")
    try:
        streams, stream_lens, total = sharded.batch_encode_sharded(
            xt, lt, group=group)
        _, ok = sharded.batch_decode_sharded(streams, lt, stream_lens,
                                             group=group, out_n=8192)
        keys, data, data_len, rows_total = \
            sharded.batch_encode_sharded_rows(xt, lt, group=group)
    finally:
        dist.destroy_process_group()
    assert torch.equal(streams, alone[0]) and torch.equal(stream_lens,
                                                          alone[1])
    assert int(total) == int(alone[2]) == int(stream_lens.sum())
    assert bool(ok.all()) and ok.shape == (4,)
    assert int(rows_total) == int(data_len.sum()) + 4 * 8192 // 4


# Rows of 0-7 values, about a tile and one, and whole rows of N.
_STREAM_LENGTHS = [0, 1, 2, 3, 4, 5, 6, 7, 4095, 4096, 4097, 8191, 8192]
_STREAM_CASES = ["as encoded", "lengths past out_n", "out_n past the rows",
                 "M odd", "M below out_n/4", "M empty", "lengths moved",
                 "int64 lengths", "random bytes", "no rows", "out_n 0"]
# Cases with no tile to launch: the wrapper answers without the kernel.
_STREAM_NO_TILE = ("no rows", "out_n 0")


def _stream_case(name, flavor, device):
    """(streams [b, M] u8, lengths, stream_lens, out_n) of a case for the
    plane's in-place W2 decoder, from the plane's own encode of uniform
    rows of N = 8192 (codes 0 and 1 mixed), cut or moved as named; or, for
    "random bytes", keys with codes 2 and 3, whose ok total (code + 1) and
    D's byte offsets differ, half the stream lengths that total."""
    N = 8192
    size = 2 if flavor == "zz16" else 1
    rng = np.random.default_rng(59)
    lens = np.array(_STREAM_LENGTHS, np.int32)
    x = signals.uniform(rng, lens.size * N,
                        np.int16 if size == 2 else np.int8).reshape(-1, N)
    lt = torch.from_numpy(lens).to(device)
    streams, slen, _ = sharded.batch_encode_sharded(
        torch.from_numpy(x).to(device), lt, integer_size=size)
    top = int(slen.max())
    cut = {"M odd": top + 3 if top % 2 == 0 else top + 2,
           "M below out_n/4": 1001, "M empty": 0}
    if name in cut:
        streams = streams[:, :cut[name]].contiguous()
    if name == "lengths moved":
        slen = slen + torch.from_numpy(
            np.resize([1, -1, 0], lens.size).astype(np.int32)).to(device)
    if name == "int64 lengths":
        # Every third length also moved past int32, where no row is ok.
        slen = slen.to(torch.int64) + torch.from_numpy(np.resize(
            [1 << 32, 0, 0], lens.size)).to(device)
    if name == "no rows":
        streams, lt, slen = streams[:0], lt[:0], slen[:0]
    if name == "random bytes":
        M = 2 * N + 7
        streams = torch.from_numpy(rng.integers(
            0, 256, (lens.size, M), dtype=np.uint8)).to(device)
        lens = rng.integers(0, N + 100, lens.size).astype(np.int32)
        lt = torch.from_numpy(lens).to(device)
        keys, _, kl = _rows.stream_sections(streams, lt, N)
        ends = kl + ((_rows.unpack_keys(keys) + 1)
                     * _rows.valid_mask(lt, N)).sum(dim=1)
        assert bool(((_rows.unpack_keys(keys) >= 2)
                     & _rows.valid_mask(lt, N)).any())
        slen = torch.where(torch.arange(lens.size, device=device) % 2 == 0,
                           ends, ends + 1).to(torch.int32)
    out_n = {"lengths past out_n": 4096, "out_n past the rows": N + 4100,
             "out_n 0": 0}.get(name, N)
    return streams, lt, slen, out_n


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["zz16", "zz8"])
@pytest.mark.parametrize("name", _STREAM_CASES)
def test_stream_decode_matches_composition_on_card(cuda_device, flavor,
                                                   name):
    """The plane's in-place W2 decoder against the composition it replaces
    on the same card tensors (the key slice, the data gather, D on the
    sections, the key counts behind ok) and against the plain version on
    the CPU: values and ok bit for bit, one launch (none where there is no
    tile), no launch of D on sections."""
    streams, lt, slen, out_n = _stream_case(name, flavor, cuda_device)
    keys, data, kl = _rows.stream_sections(streams, lt, out_n)
    want = (svb_w2.decode_w2_rows(keys, data, lt, flavor),
            _rows.stream_ok(keys, lt, kl, slen))
    before = svb_w2.DECODE_STREAM_LAUNCHES, svb_w2.DECODE_LAUNCHES
    out, ok = svb_w2.decode_w2_streams(streams, lt, slen, out_n, flavor)
    assert (svb_w2.DECODE_STREAM_LAUNCHES, svb_w2.DECODE_LAUNCHES) == (
        before[0] + (name not in _STREAM_NO_TILE), before[1])
    assert out.dtype == want[0].dtype and ok.dtype == torch.bool
    assert torch.equal(out, want[0]) and torch.equal(ok, want[1])
    plain = svb_w2.decode_w2_streams(streams.cpu(), lt.cpu(), slen.cpu(),
                                     out_n, flavor)
    assert torch.equal(out.cpu(), plain[0]) and torch.equal(ok.cpu(),
                                                            plain[1])
    if name == "lengths moved":
        assert not bool(ok[0]) and not bool(ok[1]) and bool(ok[2])
    if name == "int64 lengths":
        assert not bool(ok[0::3].any()) and bool(ok[1::3].all())
    if name == "out_n 0":
        assert out.shape == (lt.numel(), 0) and bool(ok[0])
        assert not bool(ok[1:].any())
    if name == "random bytes":
        assert bool(ok[0::2].all()) and not bool(ok[1::2].any())


def _stream_want(case, flavor):
    """The composition on the card for a stream case: the sections, D on
    them, the key counts behind ok."""
    streams, lt, slen, out_n = case
    keys, data, kl = _rows.stream_sections(streams, lt, out_n)
    return (svb_w2.decode_w2_rows(keys, data, lt, flavor),
            _rows.stream_ok(keys, lt, kl, slen))


def _stream_words(case):
    """The look-back words a stream case's launch uses."""
    _, lt, _, out_n = case
    tile = _build.lib("w2").vbz_w2_tile()
    return 1 + (2 * -(-out_n // tile) + 1) * lt.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["zz16", "zz8"])
def test_stream_decode_back_to_back_on_one_stream(cuda_device, flavor,
                                                  monkeypatch):
    """Every stream case that launches, enqueued on one stream with no
    synchronize between: largest look-back first, on a fresh kept buffer,
    then, on another fresh one (the last one's dirty memory free to reuse),
    smallest first, so calls that use more of the buffer, or grow it,
    follow calls that used less. Each result bit for bit the
    composition's; the buffer grows only where a call asks more than it
    holds."""
    names = [n for n in _STREAM_CASES if n not in _STREAM_NO_TILE]
    cases = {n: _stream_case(n, flavor, cuda_device) for n in names}
    want = {n: _stream_want(c, flavor) for n, c in cases.items()}
    order = sorted(names, key=lambda n: _stream_words(cases[n]),
                   reverse=True)
    got = []
    for run in (order, order[::-1]):
        monkeypatch.setattr(svb_w2, "_STREAM_SCRATCH", {})
        held = 0
        for name in run:
            words = _stream_words(cases[name])
            grown = svb_w2.STREAM_SCRATCH_GROWN
            got.append((name, svb_w2.decode_w2_streams(*cases[name],
                                                       flavor)))
            assert svb_w2.STREAM_SCRATCH_GROWN - grown == (words > held)
            held = max(held, 1 << (words - 1).bit_length())
    torch.cuda.synchronize()
    for name, (out, ok) in got:
        assert torch.equal(out, want[name][0]), name
        assert torch.equal(ok, want[name][1]), name


@pytest.mark.cuda
@pytest.mark.parametrize("streams_of", ["one stream", "two streams"])
def test_stream_decode_from_two_threads(cuda_device, streams_of,
                                        monkeypatch):
    """Two threads decoding stream cases at once, 30 calls each: both on
    the device's current stream, where they share its kept buffer and the
    library's lock keeps each fill with its launch, or each on a stream of
    its own with a buffer of its own. Every result bit for bit the
    composition's."""
    monkeypatch.setattr(svb_w2, "_STREAM_SCRATCH", {})
    names = ("as encoded", "random bytes")
    cases = {n: _stream_case(n, "zz16", cuda_device) for n in names}
    want = {n: _stream_want(c, "zz16") for n, c in cases.items()}
    side = {n: torch.cuda.Stream(cuda_device) if streams_of == "two streams"
            else torch.cuda.current_stream(cuda_device) for n in names}
    torch.cuda.synchronize()
    got, failed = {}, []

    def decode(name):
        try:
            with torch.cuda.stream(side[name]):
                got[name] = [svb_w2.decode_w2_streams(*cases[name], "zz16")
                             for _ in range(30)]
                side[name].synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            failed.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=decode, args=(n,))
                   for n in names]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not failed, failed
    torch.cuda.synchronize()
    for name in names:
        assert len(got[name]) == 30
        for out, ok in got[name]:
            assert torch.equal(out, want[name][0]), name
            assert torch.equal(ok, want[name][1]), name
    assert len(svb_w2._STREAM_SCRATCH) == (2 if streams_of == "two streams"
                                           else 1)


@pytest.mark.cuda
def test_stream_scratch_grows_only_for_a_larger_call_on_card(
        cuda_device, monkeypatch):
    """STREAM_SCRATCH_GROWN moves on the first call and on a call that asks
    more look-back words than the kept buffer holds, and on no other; the
    results stay the composition's throughout."""
    monkeypatch.setattr(svb_w2, "_STREAM_SCRATCH", {})
    small = _stream_case("lengths past out_n", "zz16", cuda_device)
    mid = _stream_case("as encoded", "zz16", cuda_device)
    streams, lt, slen, out_n = _stream_case("out_n past the rows", "zz16",
                                            cuda_device)
    large = (torch.cat([streams] * 3), torch.cat([lt] * 3),
             torch.cat([slen] * 3), out_n)
    assert (_stream_words(small) < _stream_words(mid)
            < _stream_words(large))
    for case, moves in ((small, 1), (small, 0), (mid, 1), (small, 0),
                        (mid, 0), (large, 1), (mid, 0), (large, 0)):
        grown = svb_w2.STREAM_SCRATCH_GROWN
        out, ok = svb_w2.decode_w2_streams(*case, "zz16")
        assert svb_w2.STREAM_SCRATCH_GROWN - grown == moves
        want = _stream_want(case, "zz16")
        assert torch.equal(out, want[0]) and torch.equal(ok, want[1])


@pytest.mark.cuda
def test_plane_takes_the_in_place_decoder_on_card(cuda_device):
    """The plane launches D in place once a call for zz16 and zz8, and never
    for the W4 kinds, which launch D4 on the sections; every row ok and
    round-tripped either way."""
    N = 8192
    lens = np.array([0, 5, 4097, N], np.int32)
    lt = torch.from_numpy(lens).to(cuda_device)
    for size, zigzag, in_place in ((2, True, True), (1, True, True),
                                   (2, False, False), (4, True, False)):
        dtype = {1: np.int8, 2: np.int16, 4: np.int32}[size]
        x = torch.from_numpy(signals.uniform(
            np.random.default_rng(61), lens.size * N, dtype).reshape(-1, N))
        x = x.to(cuda_device)
        kw = dict(integer_size=size, use_zigzag=zigzag)
        streams, slen, _ = sharded.batch_encode_sharded(x, lt, **kw)
        before = (svb_w2.DECODE_STREAM_LAUNCHES, svb_w2.DECODE_LAUNCHES,
                  svb_w4.DECODE_LAUNCHES)
        for _ in range(3):
            out, ok = sharded.batch_decode_sharded(streams, lt, slen,
                                                   out_n=N, **kw)
            assert bool(ok.all())
            assert torch.equal(out, torch.where(
                torch.arange(N, device=cuda_device)[None] < lt[:, None],
                x, 0))
        after = (svb_w2.DECODE_STREAM_LAUNCHES, svb_w2.DECODE_LAUNCHES,
                 svb_w4.DECODE_LAUNCHES)
        assert after == ((before[0] + 3, before[1], before[2]) if in_place
                         else (before[0], before[1], before[2] + 3))


def _match_cases():
    lib = _build.lib("match")
    return [(name, buf, zstd_match.DEFAULT_OFFSETS if o is None else o)
            for name, buf, o in signals.match_cases(lib.vbz_match_tile(),
                                                    lib.vbz_match_halo())]


# M's two widths: (LAUNCHES key, wrapper, plain version, result dtype).
_WIDTHS = [("match_scan", zstd_match.match_candidates,
            zstd_match.match_candidates_plain, torch.int32),
           ("match_index", zstd_match.match_index,
            zstd_match.match_index_plain, torch.uint8)]


@pytest.mark.cuda
@pytest.mark.parametrize("key,fn,plain,dtype", _WIDTHS,
                         ids=[w[0] for w in _WIDTHS])
def test_match_scan_matches_plain_on_card(cuda_device, key, fn, plain, dtype):
    """M on every case of signals.match_cases (tile and halo edges, n around
    o + 4, unsorted and repeated offsets, offsets past the halo) equals the
    plain scan at both widths, one launch per non-empty buffer."""
    cases = _match_cases()
    before = zstd_match.LAUNCHES[key]
    for name, buf, offsets in cases:
        x = torch.from_numpy(buf.copy()).to(cuda_device)
        got = fn(x, offsets)
        assert got.dtype == dtype and got.shape == (buf.size,), name
        assert torch.equal(got, plain(x, offsets)), name
    torch.cuda.synchronize()
    assert zstd_match.LAUNCHES[key] - before == sum(
        b.size > 0 for _, b, _ in cases)


@pytest.mark.cuda
@pytest.mark.parametrize("key,fn,plain,dtype", _WIDTHS,
                         ids=[w[0] for w in _WIDTHS])
def test_match_scan_clean_payload_on_card(cuda_device, key, fn, plain, dtype):
    """M on the clean chunk's 5,243,482-byte payload, on views of it 0-3
    bytes into their buffer and over 20 repeated calls equals the plain
    scan at both widths; build_match_index_device on the card equals it on
    the CPU."""
    payload = np.frombuffer(signals.clean_payload(), np.uint8)
    x = torch.from_numpy(payload.copy()).to(cuda_device)
    want = plain(x)
    for shift in (0, 1, 2, 3):
        view = torch.empty(x.numel() + shift, dtype=torch.uint8,
                           device=cuda_device)[shift:]
        view.copy_(x)
        assert torch.equal(fn(view), want), shift
    for _ in range(20):
        assert torch.equal(fn(x), want)
    small = payload[:200_003]
    on_card = zstd_match.build_match_index_device(small, device=cuda_device)
    on_cpu = zstd_match.build_match_index_device(small, device="cpu")
    for got, ref in zip(on_card, on_cpu):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
def test_own_tpu_frames_match_cpu_on_card(cuda_device, monkeypatch):
    """VBZ_ZSTD_ENCODER=own-tpu through the batch API and the corpus driver
    on the card at (0,2,1,1): the frames of the same calls on the CPU, M's
    index launched once per chunk payload of 4 bytes or more."""
    monkeypatch.setenv("VBZ_ZSTD_ENCODER", "own-tpu")
    opts = CompressionOptions.from_cd_values((0, 2, 1, 1))
    reads = signals.pseudo_reads(6) + [np.zeros(0, np.int16),
                                       np.arange(3, dtype=np.int16)]
    before = dict(zstd_match.LAUNCHES)
    frames = api.vbz_compress_sized_batch(
        reads, opts, backend=TorchSvbBackend(cuda_device))
    assert zstd_match.LAUNCHES["match_index"] - before["match_index"] == 7
    assert zstd_match.LAUNCHES["match_scan"] == before["match_scan"]
    assert frames == api.vbz_compress_sized_batch(
        reads, opts, backend=TorchSvbBackend("cpu"))
    assert multihost.compress_signals(reads, opts, device=cuda_device) == \
        multihost.compress_signals(reads, opts, device="cpu")
    data = signals.clean_payload()[:300_000]
    assert zstd_seq.compress_frame(data, "device", cuda_device) == \
        zstd_seq.compress_frame(data, "device", "cpu")


def _native_counts():
    from vbz_compression_tpu_torch import native_backend

    return dict(native_backend.CALLS)


@pytest.mark.cuda
def test_own_tpu_native_branches_match_numpy_on_card(cuda_device,
                                                     monkeypatch):
    """own-tpu through the batch API and the corpus driver on the card at
    (0,2,1,1): with the native encoder branches (libvbz_native.so, built
    here from native/) the frames of the NumPy branches, M's index launched
    both times and the C sequence scan only the first."""
    monkeypatch.setenv("VBZ_ZSTD_ENCODER", "own-tpu")
    opts = CompressionOptions.from_cd_values((0, 2, 1, 1))
    reads = signals.pseudo_reads(6) + [np.zeros(0, np.int16),
                                       np.arange(3, dtype=np.int16)]
    backend = TorchSvbBackend(cuda_device)
    before, launches = _native_counts(), zstd_match.LAUNCHES["match_index"]
    frames = api.vbz_compress_sized_batch(reads, opts, backend=backend)
    corpus = multihost.compress_signals(reads, opts, device=cuda_device)
    after = _native_counts()
    assert after["vbz_lz_sequences"] > before["vbz_lz_sequences"]
    assert after["vbz_zstd_seq_bitstream"] > before["vbz_zstd_seq_bitstream"]
    assert zstd_match.LAUNCHES["match_index"] - launches == 14
    from vbz_compression_tpu_torch.ops import zstd_huff

    monkeypatch.setattr(zstd_seq, "_native_lz", lambda: None)
    monkeypatch.setattr(zstd_huff, "_native_bits", lambda: None)
    assert api.vbz_compress_sized_batch(reads, opts,
                                        backend=backend) == frames
    assert multihost.compress_signals(reads, opts,
                                      device=cuda_device) == corpus
    assert _native_counts() == after


@pytest.mark.cuda
def test_level1_frames_decode_natively_on_card(cuda_device, monkeypatch):
    """Level-1 frames (own-tpu on the card) decode through the native C
    ABI, which runs libzstd in C where no zstandard package is installed;
    the C ABI's own level-1 frames round-trip too."""
    from vbz_compression_tpu_torch import native_backend

    monkeypatch.setenv("VBZ_ZSTD_ENCODER", "own-tpu")
    opts = CompressionOptions.from_cd_values((0, 2, 1, 1))
    reads = signals.pseudo_reads(4) + [np.zeros(0, np.int16)]
    frames = api.vbz_compress_sized_batch(reads, opts,
                                          backend=TorchSvbBackend(cuda_device))
    for r, f in zip(reads, frames):
        assert native_backend.vbz_decompress_sized(f, opts) == r.tobytes()
        own = native_backend.vbz_compress_sized(r, opts)
        assert native_backend.vbz_decompress_sized(own, opts) == r.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("key,fn,plain,dtype", _WIDTHS,
                         ids=[w[0] for w in _WIDTHS])
def test_match_scan_from_threads_on_card(cuda_device, key, fn, plain, dtype):
    """M launched from more threads than cores at once, with a short switch
    interval, at both widths: every result equals the plain scan's and no
    launch is lost from the count (the batch API's zstd stage launches from
    a pool)."""
    import os
    import sys
    from concurrent.futures import ThreadPoolExecutor

    bufs = [torch.from_numpy(np.resize(b, 200_000 + 7 * i)).to(cuda_device)
            for i, (_, b, _) in enumerate(_match_cases()[:6]) if b.size]
    want = [plain(x) for x in bufs]
    calls = 8 * len(bufs)
    before = zstd_match.LAUNCHES[key]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(2 * (os.cpu_count() or 1)) as pool:
            futures = [pool.submit(fn, bufs[k % len(bufs)])
                       for k in range(calls)]
            got = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    for k, g in enumerate(got):
        assert torch.equal(g, want[k % len(bufs)]), k
    assert zstd_match.LAUNCHES[key] - before == calls


def _butterfly_lengths(stages: int) -> list:
    """Flat lengths around the butterfly kernel's tile edges (the tile
    depends on the stages) and below its halo of 2^stages - 1 values."""
    tile = _build.lib("probe").vbz_probe_butterfly_tile(stages, 1 << 40)
    halo = (1 << stages) - 1
    return sorted({1, 127, max(1, halo - 1), halo, halo + 1, tile - 1, tile,
                   tile + 1, 2 * tile + 3, 3 * tile + halo})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("stages", range(1, 16))
def test_butterfly_matches_plain_on_card(cuda_device, stages, dtype):
    """The butterfly kernel at every stage count and both widths equals its
    plain version on lengths around its tile edges and below its halo, on
    tokens and on values of the whole range (signs included); one launch a
    call."""
    key = f"butterfly_i{8 * np.dtype(dtype).itemsize}"
    rng = np.random.default_rng(stages)
    info = np.iinfo(dtype)
    for n in _butterfly_lengths(stages):
        tokens = (np.sort(rng.integers(0, min(1 << stages, 1 << 14), n))
                  << 1) | 1
        for a in (tokens.astype(dtype),
                  rng.integers(info.min, info.max, n, dtype=dtype,
                               endpoint=True)):
            x = torch.from_numpy(a.reshape(1, n)).to(cuda_device)
            before = probes.LAUNCHES[key]
            got = probes.butterfly(x, stages)
            assert probes.LAUNCHES[key] == before + 1
            assert torch.equal(got, probes.butterfly_plain(x, stages)), n


# chip_smoke.MAIN_PATHS' option sets and corpus contents, at zstd level 1.
_LEVEL1_PATHS = [
    ((0, 2, 1, 1), "int16"), ((0, 4, 1, 1), "int32_walk"),
    ((1, 1, 1, 1), "int8_walk"), ((0, 2, 0, 1), "adc_u16"),
    ((1, 1, 0, 1), "u8"), ((0, 1, 0, 1), "u8"), ((0, 4, 0, 1), "u32"),
]
_LEVEL1_LENGTHS = [0, 1, 4999, 70_001, 1_000_003]


@pytest.mark.cuda
@pytest.mark.parametrize("cd_values,content", _LEVEL1_PATHS,
                         ids=[str(c) for c, _ in _LEVEL1_PATHS])
def test_level1_main_paths_match_oracle_on_card(cuda_device, cd_values,
                                                content):
    """The batch API at level 1 on the card: frames equal the oracle
    backend's through the same zstd stage, every read back."""
    from vbz_compression_tpu_torch.utils import libzstd

    opts = CompressionOptions.from_cd_values(cd_values)
    if content == "int16":
        rng = np.random.default_rng(8)
        reads = [signals.walk_with_reads(rng, n) if n else
                 np.zeros(0, np.int16) for n in _LEVEL1_LENGTHS]
    else:
        reads = signals.corpus_of(content, _LEVEL1_LENGTHS)
    backend = TorchSvbBackend(cuda_device)
    before = libzstd.CALLS["ZSTD_compress2"]
    frames = api.vbz_compress_sized_batch(reads, opts, backend=backend)
    if api.zstd_route().startswith("libzstd.so"):
        assert libzstd.CALLS["ZSTD_compress2"] - before == len(reads)
    assert frames == api.vbz_compress_sized_batch(reads, opts,
                                                  backend=oracle)
    back = api.vbz_decompress_sized_batch(frames, opts, backend=backend)
    assert back == [r.tobytes() for r in reads]


@pytest.mark.cuda
def test_compress_signals_defaults_on_card(cuda_device):
    """The corpus driver at its default options (zstd level 1) on the
    card: the oracle's frames through the same zstd stage, reads back."""
    reads = signals.pseudo_reads(8)
    opts = CompressionOptions(True, 2, 1, 0)
    frames = multihost.compress_signals(reads, device=cuda_device)
    assert frames == [api.vbz_compress_sized(r, opts, backend=oracle)
                      for r in reads]
    back = api.vbz_decompress_sized_batch(
        frames, opts, backend=TorchSvbBackend(cuda_device))
    assert back == [r.tobytes() for r in reads]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.int8, np.uint16,
                                   np.uint8, np.uint32])
def test_numpy_api_default_options_on_card(cuda_device, dtype):
    """api.compress / decompress with no options (level 1, the dtype's
    flavor) on the card: the oracle backend's frame, the array back."""
    rng = np.random.default_rng(12)
    info = np.iinfo(dtype)
    arr = np.clip(500 + np.cumsum(rng.normal(0, 40, 300_001)), info.min,
                  info.max).astype(dtype)
    backend = TorchSvbBackend(cuda_device)
    frame = api.compress(arr, backend=backend)
    assert frame.tobytes() == api.compress(arr, backend=oracle).tobytes()
    np.testing.assert_array_equal(api.decompress(frame, dtype,
                                                 backend=backend), arr)
