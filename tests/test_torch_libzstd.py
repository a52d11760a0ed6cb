"""The port's zstd stage on ``libzstd.so.1`` through ctypes
(``vbz_compression_tpu_torch/utils/libzstd.py``), the route it takes where
the ``zstandard`` package is not installed.

The ctypes route is forced here by patching ``api._zstandard`` to return
None, with ``VBZ_BACKEND=torch``. Its frames are held to the ``zstandard``
route's and to the JAX package's api: they decode through both, the
level-1 header carries the tuned profile's window and flags, the frames are
byte for byte ``zstandard``'s where the two libraries are one version, and
every malformed frame gives the ``zstandard`` route's result or its
``VbzError`` code. Then the seven main option sets at level 1 through the
sized, batch and numpy entry points, the pool's threads and
``compress_signals`` at its defaults.
"""

import glob
import gc
import os
import struct
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import zstandard

from vbz_compression_tpu import api as jax_api
from vbz_compression_tpu.ops import scalar as jax_oracle
from vbz_compression_tpu_torch import (VBZ_DESTINATION_SIZE_ERROR,
                                       VBZ_ZSTD_ERROR, CompressionOptions,
                                       VbzError, api, oracle, signals)
from vbz_compression_tpu_torch.parallel import multihost
from vbz_compression_tpu_torch.utils import libzstd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.MAIN_PATHS' option sets and corpus contents, at zstd level 1.
MAIN_PATHS_L1 = [
    ((0, 2, 1, 1), "int16"), ((0, 4, 1, 1), "int32_walk"),
    ((1, 1, 1, 1), "int8_walk"), ((0, 2, 0, 1), "adc_u16"),
    ((1, 1, 0, 1), "u8"), ((0, 1, 0, 1), "u8"), ((0, 4, 0, 1), "u32"),
]
LENGTHS = [0, 1, 4999, 70_001]


@pytest.fixture
def ctypes_route(monkeypatch):
    monkeypatch.setenv("VBZ_BACKEND", "torch")
    monkeypatch.delenv("VBZ_ZSTD_ENCODER", raising=False)
    monkeypatch.setattr(api, "_zstandard", lambda: None)


def _payload(n: int = 600_000, seed: int = 0) -> bytes:
    """StreamVByte-like bytes: the oracle's zz16 stream of a signal walk."""
    rng = np.random.default_rng(seed)
    walk = np.clip(np.cumsum(rng.normal(0, 40, n // 2)), -30000,
                   30000).astype(np.int16)
    return oracle.svb_compress(walk, 2, True, 0)


def _outcome(fn):
    """("ok", result) or ("error", VbzError code)."""
    try:
        return "ok", fn()
    except VbzError as exc:
        return "error", exc.code


def _both_routes(monkeypatch, fn):
    """``fn()``'s outcome on the zstandard route, then on the ctypes
    route."""
    want = _outcome(fn)
    with monkeypatch.context() as m:
        m.setattr(api, "_zstandard", lambda: None)
        got = _outcome(fn)
    return want, got


def test_route_names_the_library(monkeypatch):
    assert api.zstd_route().startswith(f"zstandard {zstandard.__version__} ")
    monkeypatch.setattr(api, "_zstandard", lambda: None)
    version = libzstd.version()
    assert api.zstd_route() == f"libzstd.so.1 {libzstd.version_string()}"
    assert libzstd.version_string(10504) == "1.5.4"
    assert version >= 10400  # every declared function is in v1.4.0
    assert libzstd.call("ZSTD_minCLevel") <= -1
    assert libzstd.call("ZSTD_maxCLevel") == 22


def test_signatures_keep_size_t_results():
    """Error codes are size_t: a restype of int would cut them and
    ZSTD_isError would miss them."""
    so = libzstd.lib().so
    for name, (restype, _) in libzstd._SIGNATURES.items():
        assert getattr(so, name).restype is restype
        assert restype is not libzstd.ctypes.c_int or name in (
            "ZSTD_maxCLevel", "ZSTD_minCLevel")
    assert so.ZSTD_getFrameContentSize.restype is libzstd.ctypes.c_ulonglong
    err = libzstd.call("ZSTD_findFrameCompressedSize", b"nope", 4)
    assert err > 2**63 and libzstd.call("ZSTD_isError", err)
    assert libzstd.call("ZSTD_getFrameContentSize", b"nope", 4) == \
        libzstd.CONTENTSIZE_ERROR


@pytest.mark.parametrize("level", [1, 3, 22, 30, -5])
def test_round_trips_and_decodes_across_routes(ctypes_route, level):
    data = _payload(300_000, seed=level % 7)
    before = dict(libzstd.CALLS)
    frame = api.zstd_compress(data, level)
    assert libzstd.CALLS["ZSTD_compress2"] == before["ZSTD_compress2"] + 1
    assert api.zstd_frame_content_size(frame) == len(data)
    assert api.zstd_decompress(frame, len(data)) == data
    assert libzstd.CALLS["ZSTD_decompress"] == before["ZSTD_decompress"] + 1
    # The ctypes route's frame through zstandard and the JAX api ...
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert jax_api.zstd_frame_content_size(frame) == len(data)
    assert jax_api.zstd_decompress(frame, len(data)) == data
    # ... and theirs through the ctypes route.
    for other in (jax_api.zstd_compress(data, level),
                  zstandard.ZstdCompressor(
                      level=min(level, 22)).compress(data)):
        assert api.zstd_frame_content_size(other) == len(data)
        assert api.zstd_decompress(other, len(data)) == data
    if level > 22:  # clamped to the maximum, as the JAX api clamps
        assert frame == api.zstd_compress(data, 22)


def _frame_header(frame: bytes) -> dict:
    """The fields of a zstd frame header (RFC 8878, 3.1.1.1)."""
    assert frame[:4] == bytes.fromhex("28b52ffd")
    fhd = frame[4]
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    out = {"checksum": (fhd >> 2) & 1, "dict_id_flag": fhd & 3,
           "single_segment": single}
    pos = 5
    if not single:
        wd = frame[pos]
        exponent, mantissa = wd >> 3, wd & 7
        base = 1 << (10 + exponent)
        out["window_log"] = 10 + exponent
        out["window_size"] = base + (base // 8) * mantissa
        pos += 1
    fcs_bytes = {0: int(single), 1: 2, 2: 4, 3: 8}[fcs_flag]
    out["content_size_present"] = fcs_bytes > 0
    if fcs_bytes:
        size = int.from_bytes(frame[pos:pos + fcs_bytes], "little")
        out["content_size"] = size + 256 if fcs_bytes == 2 else size
    return out


@pytest.mark.parametrize("route", ["ctypes", "zstandard"])
def test_level1_header_holds_the_profile(monkeypatch, route):
    """Content size present, no checksum, no dictionary, and the window log
    19 of the tuned profile on a chunk over 512 KiB (a smaller window
    would show there), on both routes, whatever the library's version."""
    if route == "ctypes":
        monkeypatch.setattr(api, "_zstandard", lambda: None)
    big = _payload(1_500_000, seed=3)
    assert len(big) > 512 << 10
    head = _frame_header(api.zstd_compress(big, 1))
    assert head == {"checksum": 0, "dict_id_flag": 0, "single_segment": 0,
                    "window_log": 19, "window_size": 1 << 19,
                    "content_size_present": True, "content_size": len(big)}
    small = _frame_header(api.zstd_compress(big[:5000], 1))
    assert small["content_size"] == 5000 and small["checksum"] == 0
    for level in (3, -5):
        head = _frame_header(api.zstd_compress(big[:70_000], level))
        assert head["content_size"] == 70_000 and head["checksum"] == 0


def test_frames_equal_zstandard_where_the_versions_match(ctypes_route,
                                                         capsys):
    """This machine's libzstd.so.1 against zstandard's bundled libzstd:
    decoded bytes equal always; frame bytes equal where the two versions
    are one. Prints which of the two it checked."""
    same_version = (libzstd.version_string()
                    == ".".join(map(str, zstandard.ZSTD_VERSION)))
    sizes = {}
    for data in (_payload(400_000, seed=5), _payload(1_500_000, seed=3)):
        for level in (1, 3, -5):
            frame = api.zstd_compress(data, level)
            reference = jax_api.zstd_compress(data, level)
            assert zstandard.ZstdDecompressor().decompress(frame) == data
            assert api.zstd_decompress(reference, len(data)) == data
            if same_version:
                assert frame == reference
            sizes[len(data), level] = (len(frame), len(reference),
                                       frame == reference)
    checked = ("frame bytes and decoded bytes" if same_version
               else "decoded bytes only (the versions differ)")
    with capsys.disabled():
        print(f"\n  libzstd.so.1 {libzstd.version_string()}, zstandard's "
              f"{'.'.join(map(str, zstandard.ZSTD_VERSION))}: checked "
              f"{checked}; frame bytes by (payload bytes, level): "
              f"(libzstd.so.1, zstandard, equal) {sizes}")


def _zstandard_library() -> str:
    """zstandard's cffi extension, which carries its libzstd with the
    library's symbols exported."""
    found = glob.glob(os.path.join(os.path.dirname(zstandard.__file__),
                                   "_cffi*.so"))
    assert found, "zstandard's cffi extension is not installed"
    return found[0]


@pytest.mark.parametrize("level", [1, 3, -5, 19, 23])
def test_frames_equal_zstandard_on_its_own_library(ctypes_route, monkeypatch,
                                                   level):
    """The binding loaded against zstandard's own libzstd (one version on
    both sides) writes zstandard's frames byte for byte: the parameters of
    every level, the tuned level-1 profile among them, are the JAX api's."""
    monkeypatch.setattr(libzstd, "_NAMES", (_zstandard_library(),))
    libzstd.lib.cache_clear()
    try:
        assert libzstd.version() == int("%d%02d%02d" % zstandard.ZSTD_VERSION)
        data = _payload(300_000, seed=level % 5)
        frame = api.zstd_compress(data, level)
        assert frame == jax_api.zstd_compress(data, level)
        assert api.zstd_decompress(frame, len(data)) == data
    finally:
        libzstd.lib.cache_clear()


def _malformed() -> dict:
    good = jax_api.zstd_compress(_payload(6000, seed=9)[:3000], 1)
    corrupt = bytearray(good)
    corrupt[len(good) // 2] ^= 0xFF  # may still decode: no checksum
    reserved = bytearray(good)
    # magic, descriptor, a 2-byte content size (single segment), then the
    # first block's header: type 3 is reserved.
    assert good[4] >> 5 == 0b011
    reserved[7] |= 0b110
    checked = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(
        b"abc" * 1000)
    return {
        "valid": good,
        "truncated": good[:-3],
        "header only": good[:3],
        "corrupted": bytes(corrupt),
        "reserved block type": bytes(reserved),
        "trailing bytes": good + b"xyz",
        "two frames": good + good,
        "no content size": zstandard.ZstdCompressor(
            level=1, write_content_size=False).compress(b"abc" * 1000),
        "bad checksum": checked[:-1] + bytes([checked[-1] ^ 1]),
        "skippable": struct.pack("<II", 0x184D2A51, 5) + b"12345",
        "empty frame": jax_api.zstd_compress(b"", 1) + b"junk",
        "no bytes": b"",
        "not zstd": b"hello, world",
    }


@pytest.mark.parametrize("name", list(_malformed()))
def test_malformed_frames_match_the_zstandard_route(monkeypatch, name):
    """Each frame gives the zstandard route's bytes or its VbzError code:
    the content size, the decode at several expected sizes, and the sized
    api at integer_size 0 (the destination check: a content size above the
    destination is VBZ_DESTINATION_SIZE_ERROR) and 2."""
    frame = _malformed()[name]
    checks = {"content size": lambda: api.zstd_frame_content_size(frame)}
    for e in (3000, 7, 0):
        checks[f"decode {e}"] = lambda e=e: api.zstd_decompress(frame, e)
    for dst in (0, 2999, 3000, 3001, 6000):
        sized = struct.pack("<I", dst) + frame
        for size in (0, 2):
            opts = CompressionOptions(size == 2, size, 1, 0)
            checks[f"sized {size} {dst}"] = \
                lambda s=sized, o=opts: api.vbz_decompress_sized(
                    s, o, backend=oracle)
    outcomes = {}
    for key, check in checks.items():
        want, got = _both_routes(monkeypatch, check)
        assert got == want, key
        outcomes[key] = want
    if name in ("valid", "trailing bytes", "two frames"):
        assert outcomes["decode 7"] == ("ok", _payload(6000, seed=9)[:3000])
        assert outcomes["sized 0 3000"] == outcomes["decode 7"]
        assert outcomes["sized 0 2999"] == ("error",
                                            VBZ_DESTINATION_SIZE_ERROR)
    if name in ("truncated", "reserved block type", "bad checksum"):
        assert outcomes["decode 3000"] == ("error", VBZ_ZSTD_ERROR)
    if name in ("header only", "no content size", "no bytes", "not zstd"):
        assert outcomes["content size"] == ("error", VBZ_ZSTD_ERROR)


def _reads(content: str, lengths=LENGTHS) -> list:
    if content == "int16":
        rng = np.random.default_rng(31)
        return [signals.walk_with_reads(rng, n) if n else np.zeros(0, np.int16)
                for n in lengths]
    return signals.corpus_of(content, lengths)


@pytest.mark.parametrize("cd_values,content", MAIN_PATHS_L1,
                         ids=[str(c) for c, _ in MAIN_PATHS_L1])
def test_main_paths_at_level1(ctypes_route, cd_values, content):
    """Every entry point at the option set: frames equal across the sized,
    batch and numpy calls and the oracle backend, decoded equal to the
    input by the port and by the JAX api (through zstandard), round trips
    through the oracle."""
    opts = CompressionOptions.from_cd_values(cd_values)
    reads = _reads(content)
    before = dict(libzstd.CALLS)
    frames = api.vbz_compress_sized_batch(reads, opts)
    assert libzstd.CALLS["ZSTD_compress2"] - before["ZSTD_compress2"] == \
        len(reads)
    backs = api.vbz_decompress_sized_batch(frames, opts)
    assert libzstd.CALLS["ZSTD_decompress"] > before["ZSTD_decompress"]
    for r, f, b in zip(reads, frames, backs):
        raw = r.tobytes()
        assert b == raw
        assert api.vbz_compress_sized(r, opts) == f
        assert api.vbz_compress_sized(r, opts, backend=oracle) == f
        assert api.compress(r, opts).tobytes() == f
        np.testing.assert_array_equal(api.decompress(f, r.dtype, opts), r)
        assert api.vbz_decompress_sized(f, opts) == raw
        assert api.vbz_decompress_sized(f, opts, backend=oracle) == raw
        assert jax_api.vbz_decompress_sized(f, opts, backend=jax_oracle) == raw
        jf = jax_api.vbz_compress_sized(r, opts, backend=jax_oracle)
        assert api.vbz_decompress_sized(jf, opts) == raw


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.uint8, np.int8])
def test_numpy_api_default_options(ctypes_route, dtype):
    """api.compress / decompress with no options: level 1 and the dtype's
    flavor, decoded by the JAX api to the same array."""
    rng = np.random.default_rng(4)
    info = np.iinfo(dtype)
    arr = np.clip(np.cumsum(rng.normal(0, 30, 50_000)), info.min,
                  info.max).astype(dtype)
    frame = api.compress(arr)
    np.testing.assert_array_equal(api.decompress(frame, dtype), arr)
    np.testing.assert_array_equal(jax_api.decompress(frame.tobytes(), dtype,
                                                     backend=jax_oracle), arr)
    np.testing.assert_array_equal(
        api.decompress(jax_api.compress(arr, backend=jax_oracle).tobytes(),
                       dtype), arr)


def test_pool_threads_give_one_threads_frames(ctypes_route):
    """Many threads (more than cores), a short switch interval, two levels
    interleaved: every frame equals the one thread's, every decode its
    input, and each thread's contexts are freed when the thread ends."""
    chunks = [_payload(40_000 + 999 * k, seed=k) for k in range(12)]
    jobs = [(c, level) for c in chunks for level in (1, 3)] * 3
    want = [api.zstd_compress(c, level) for c, level in jobs]

    def one(job):
        c, level = job
        f = api.zstd_compress(c, level)
        return f, api.zstd_decompress(f, api.zstd_frame_content_size(f))

    created = libzstd.CALLS["ZSTD_createCCtx"]
    freed = libzstd.CALLS["ZSTD_freeCCtx"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(2 * (os.cpu_count() or 1)) as pool:
            got = [f.result(timeout=120) for f in
                   [pool.submit(one, job) for job in jobs]]
    finally:
        sys.setswitchinterval(interval)
    gc.collect()
    assert [f for f, _ in got] == want
    assert [b for _, b in got] == [c for c, _ in jobs]
    new = libzstd.CALLS["ZSTD_createCCtx"] - created
    assert new >= 2 and libzstd.CALLS["ZSTD_freeCCtx"] - freed >= new
    # The batch API's own pool: the same frames as one thread's.
    opts = CompressionOptions(True, 2, 1, 0)
    reads = _reads("int16", [3000 + 17 * k for k in range(24)])
    assert api.vbz_compress_sized_batch(reads, opts) == \
        [api.vbz_compress_sized(r, opts) for r in reads]


def test_compress_signals_at_its_defaults(ctypes_route):
    """The corpus driver's default options (zstd level 1) on the CPU:
    frames equal the batch API's through the same route and the oracle's,
    and decode through the JAX api."""
    reads = signals.pseudo_reads(6)
    opts = CompressionOptions(True, 2, 1, 0)
    before = libzstd.CALLS["ZSTD_compress2"]
    frames = multihost.compress_signals(reads, device="cpu")
    assert libzstd.CALLS["ZSTD_compress2"] - before == len(reads)
    assert frames == [api.vbz_compress_sized(r, opts, backend=oracle)
                      for r in reads]
    for r, f in zip(reads, frames):
        assert jax_api.vbz_decompress_sized(f, opts, backend=jax_oracle) == \
            r.tobytes()
    assert [bytes(b) for b in api.vbz_decompress_sized_batch(frames, opts)] \
        == [r.tobytes() for r in reads]


def test_stage_runs_where_zstandard_cannot_import():
    """A process where ``import zstandard`` fails, as on a machine without
    the package: the route is libzstd.so.1, the module imports neither
    zstandard nor JAX, and level 1 round-trips through api.compress."""
    code = (
        "import sys\n"
        "sys.modules['zstandard'] = None\n"
        "import numpy as np\n"
        "from vbz_compression_tpu_torch import api\n"
        "from vbz_compression_tpu_torch.utils import libzstd\n"
        "assert api.zstd_route().startswith('libzstd.so.1 '), "
        "api.zstd_route()\n"
        "s = (np.arange(99_999) % 700).astype(np.int16)\n"
        "f = api.compress(s)\n"
        "assert np.array_equal(api.decompress(f, np.int16), s)\n"
        "assert libzstd.CALLS['ZSTD_compress2'] == 1\n"
        "assert libzstd.CALLS['ZSTD_decompress'] == 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'vbz_compression_tpu') or (m == 'zstandard' and sys.modules[m])]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["VBZ_BACKEND"] = "torch"
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
