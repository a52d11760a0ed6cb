"""The port's native C++ runtime (``native_backend``, the own zstd encoder's
native branches, ``utils._native_build``) against the JAX package's and the
NumPy oracle, on the CPU.

- ``NativeSvbBackend`` streams equal the oracle's and JAX
  ``native_backend``'s over dtype x zig-zag x version (the grid of
  ``tests/test_native.py``); the sized C ABI equals JAX's at several option
  sets and reads the api's level-1 frames.
- Native-branch frames equal the NumPy branch's (``_native_lz`` and
  ``_native_bits`` patched to return None, as ``tests/test_zstd_seq.py::
  test_native_encoder_parity`` does) and JAX's, on every input of
  ``tests/test_torch_zstd.py``, with the host matcher and the device matcher
  (M's plain version on the CPU); ``native_backend.CALLS`` shows which
  branch ran.
- ``VBZ_BACKEND=native``, and the batch calls through ``NativeSvbBackend``
  (the ``gil_free_svb`` branches) against JAX's.
- The build: cached by content, safe from threads at once, and the
  declared-libzstd route (``native_include/zstd.h`` against
  ``libzstd.so.1``, for machines without the development header) gives the
  same library behaviour as the system header.

JAX's ``native_backend`` is pointed at the library the port built (the same
``native/`` sources and the Makefile's flags), so nothing here writes into
``native/``. The tests skip only where ``g++`` is missing. Exact: bytes.
"""

import ctypes
import shutil
import threading
import unittest.mock as mock

import numpy as np
import pytest
import torch

zstandard = pytest.importorskip("zstandard")

from tests.test_torch_zstd import (  # noqa: E402
    FRAME_INPUTS, PIPE_OPTIONS, _signals)
from vbz_compression_tpu import api as jax_api  # noqa: E402
from vbz_compression_tpu import native_backend as jax_nb  # noqa: E402
from vbz_compression_tpu.ops import scalar  # noqa: E402
from vbz_compression_tpu.ops import zstd_huff as jax_huff  # noqa: E402
from vbz_compression_tpu.ops import zstd_seq as jax_seq  # noqa: E402
from vbz_compression_tpu.options import CompressionOptions  # noqa: E402
from vbz_compression_tpu_torch import (  # noqa: E402
    CompressionOptions as PortOptions)
from vbz_compression_tpu_torch import api, native_backend, oracle  # noqa: E402
from vbz_compression_tpu_torch.models.codec import (  # noqa: E402
    TorchSvbBackend)
from vbz_compression_tpu_torch.ops import zstd_huff, zstd_seq  # noqa: E402
from vbz_compression_tpu_torch.parallel import multihost  # noqa: E402
from vbz_compression_tpu_torch.utils import _native_build  # noqa: E402

ENCODER_CALLS = ("vbz_lz_match_index", "vbz_lz_sequences",
                 "vbz_zstd_seq_bitstream", "vbz_own_zstd_frame",
                 "vbz_huff_build_codes", "vbz_bits_pack_backward")


@pytest.fixture(scope="module")
def port_lib():
    if shutil.which(_native_build.CXX) is None:
        pytest.skip("needs g++ to build the native runtime")
    return _native_build.library("vbz_native")


@pytest.fixture
def jax_native(port_lib):
    """JAX's ``native_backend`` over the library the port built."""
    with mock.patch.object(jax_nb, "_LIB_PATHS", [str(port_lib)]), \
            mock.patch.object(jax_nb, "_lib", None):
        yield jax_nb


def _numpy_branches(seq=zstd_seq, huff=zstd_huff):
    """The encoder's native branches off (``seq`` and ``huff`` the port's or
    JAX's modules)."""
    return (mock.patch.object(seq, "_native_lz", lambda: None),
            mock.patch.object(huff, "_native_bits", lambda: None))


def _calls() -> dict:
    return dict(native_backend.CALLS)


def _moved(before: dict) -> set:
    return {k for k, v in native_backend.CALLS.items() if v != before[k]}


# ---------------------------------------------------------------------------
# The codec and the sized C ABI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.uint16])
@pytest.mark.parametrize("zigzag", [False, True])
@pytest.mark.parametrize("version", [0, 1])
def test_native_svb_matches_jax_and_oracle(jax_native, dtype, zigzag,
                                           version):
    rng = np.random.default_rng(11)
    info = np.iinfo(dtype)
    data = rng.integers(info.min, info.max + 1, size=20_000, dtype=dtype)
    size = data.dtype.itemsize
    before = _calls()
    ours = native_backend.native_backend.svb_compress(data, size, zigzag,
                                                      version)
    assert ours == oracle.svb_compress(data, size, zigzag, version)
    assert ours == jax_native.native_backend.svb_compress(data, size, zigzag,
                                                          version)
    back = native_backend.native_backend.svb_decompress(
        ours, data.size, size, zigzag, version)
    assert back.dtype == scalar._SIGNED_FOR_SIZE[size]
    np.testing.assert_array_equal(back.view(dtype), data)
    np.testing.assert_array_equal(
        back, jax_native.native_backend.svb_decompress(ours, data.size, size,
                                                       zigzag, version))
    assert _moved(before) == {"vbz_max_compressed_size", "vbz_compress",
                              "vbz_decompress"}


SIZED_OPTIONS = [(0, 2, 1, 0), (0, 2, 1, 1), (1, 2, 1, 1), (1, 1, 1, 1),
                 (0, 4, 0, 1), (0, 0, 0, 1), (0, 0, 0, 0)]


@pytest.mark.parametrize("cd", SIZED_OPTIONS, ids=str)
def test_sized_c_abi_matches_jax(jax_native, cd):
    """The raw sized C ABI: the JAX binding's bytes, a round trip, and at
    zstd level 1 both ways across the api's libzstd stage (its tuned
    profile writes other bytes than the C ABI's stock level 1)."""
    rng = np.random.default_rng(sum(cd))
    sig = np.clip(500 + np.cumsum(rng.normal(0, 12, 50_000)), -2000,
                  2000).astype({0: np.int16, 1: np.int8, 2: np.int16,
                                4: np.int32}[cd[1]])
    ours, theirs = PortOptions.from_cd_values(cd), \
        CompressionOptions.from_cd_values(cd)
    frame = native_backend.vbz_compress_sized(sig, ours)
    assert frame == jax_native.vbz_compress_sized(sig, theirs)
    assert native_backend.vbz_decompress_sized(frame, ours) == sig.tobytes()
    api_frame = api.vbz_compress_sized(sig, ours, backend=oracle)
    assert native_backend.vbz_decompress_sized(api_frame, ours) == \
        sig.tobytes()
    assert api.vbz_decompress_sized(frame, ours, backend=oracle) == \
        sig.tobytes()
    if cd[3] == 0:
        assert frame == api_frame


def test_sized_c_abi_rejects_bad_input(port_lib):
    from vbz_compression_tpu_torch.errors import VbzError

    opts = PortOptions.from_cd_values((0, 2, 1, 1))
    with pytest.raises(VbzError):
        native_backend.vbz_decompress_sized(b"\x10\x00\x00\x00garbage", opts)
    with pytest.raises(VbzError):
        native_backend.vbz_compress_sized(np.zeros(3, np.uint8), opts)


# ---------------------------------------------------------------------------
# The own zstd encoder's native branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(FRAME_INPUTS))
def test_native_frames_match_numpy_and_jax(jax_native, name):
    """Huffman-only, host-matcher and device-matcher frames: the native
    branches' equal the NumPy branches' and JAX's (native branches on), and
    the native branches ran."""
    data = FRAME_INPUTS[name]

    def ours():
        return {"huff": zstd_huff.compress_frame(data),
                "host": zstd_seq.compress_frame(data, matcher="host"),
                "device": zstd_seq.compress_frame(data, matcher="device",
                                                  device="cpu")}

    before = _calls()
    native = ours()
    moved = _moved(before)
    a, b = _numpy_branches()
    with a, b:
        before = _calls()
        numpy_path = ours()
        assert not _moved(before)
    assert native == numpy_path
    assert native == {"huff": jax_huff.compress_frame(data),
                      "host": jax_seq.compress_frame(data, matcher="host"),
                      "device": jax_seq.compress_frame(data, matcher="tpu")}
    if len(data) >= 256:
        assert "vbz_own_zstd_frame" in moved
    if len(set(data)) > 1:
        assert "vbz_huff_build_codes" in moved
    back = zstandard.ZstdDecompressor()
    for frame in native.values():
        assert back.decompress(frame, max_output_size=max(len(data), 1)) \
            == data


def test_device_matcher_feeds_the_native_scan(port_lib):
    """With the device matcher, M's candidates go to vbz_lz_sequences and
    the sequences to vbz_zstd_seq_bitstream; the host matcher's index is
    the C hash index."""
    data = FRAME_INPUTS["seq svb_signal"]
    before = _calls()
    zstd_seq.compress_frame(data, matcher="device", device="cpu")
    moved = _moved(before)
    assert {"vbz_lz_sequences", "vbz_zstd_seq_bitstream",
            "vbz_bits_pack_backward"} <= moved
    assert not moved & {"vbz_lz_match_index", "vbz_own_zstd_frame"}
    buf = np.frombuffer(data, np.uint8)
    before = _calls()
    prev, v4 = zstd_seq.build_match_index(buf)
    assert _moved(before) == {"vbz_lz_match_index"} and v4 is None
    a, b = _numpy_branches()
    with a, b:
        prev_np, _ = zstd_seq.build_match_index(buf)
    np.testing.assert_array_equal(prev, prev_np)


@pytest.mark.parametrize("encoder", ["own", "own-tpu"])
@pytest.mark.parametrize("cd,dtype", PIPE_OPTIONS, ids=str)
def test_pipeline_native_frames(jax_native, monkeypatch, encoder, cd, dtype):
    """The batch API and the corpus driver on the CPU backend: native
    frames equal the NumPy branches' and JAX's."""
    monkeypatch.setenv("VBZ_ZSTD_ENCODER", encoder)
    ours, theirs = PortOptions.from_cd_values(cd), \
        CompressionOptions.from_cd_values(cd)
    chunks = _signals(dtype, seed=sum(cd) + 1)
    backend = TorchSvbBackend("cpu")
    before = _calls()
    frames = api.vbz_compress_sized_batch(chunks, ours, backend=backend)
    assert _moved(before) & set(ENCODER_CALLS)
    a, b = _numpy_branches()
    with a, b:
        assert api.vbz_compress_sized_batch(chunks, ours,
                                            backend=backend) == frames
    assert frames == [jax_api.vbz_compress_sized(c, theirs,
                                                 backend=jax_api.scalar)
                      for c in chunks]
    if cd == (0, 2, 1, 1):
        got = multihost.compress_signals(chunks, ours, device="cpu")
        with a, b:
            assert multihost.compress_signals(chunks, ours,
                                              device="cpu") == got
        assert got == frames


# ---------------------------------------------------------------------------
# The api
# ---------------------------------------------------------------------------


def test_native_backend_resolves(port_lib, monkeypatch):
    """VBZ_BACKEND=native is the C++ codec; as a host codec it has no device,
    so own-tpu's scan and the corpus driver's rows go to the card, and
    without one they raise."""
    monkeypatch.setenv("VBZ_BACKEND", "native")
    backend = api.default_backend()
    assert isinstance(backend, native_backend.NativeSvbBackend)
    assert backend.gil_free_svb
    sig = np.arange(-999, 999, dtype=np.int16)
    opts = PortOptions.from_cd_values((0, 2, 1, 1))
    assert api.vbz_compress_sized(sig, opts) == \
        api.vbz_compress_sized(sig, opts, backend=oracle)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="VBZ_BACKEND=native"):
        api.scan_device(backend)
    with pytest.raises(RuntimeError):
        multihost.compress_signals([sig])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert api.scan_device(backend) == torch.device("cuda")
    assert api.scan_device(TorchSvbBackend("cpu")) == torch.device("cpu")


@pytest.mark.parametrize("cd", [(0, 2, 1, 1), (1, 1, 1, 1), (0, 4, 1, 1),
                                (0, 2, 1, 0)], ids=str)
def test_batch_api_native_matches_jax(jax_native, cd):
    """vbz_*_sized_batch through NativeSvbBackend: JAX's frames through its
    NativeSvbBackend (the gil_free_svb branch at zstd level 1, the loop at
    level 0), one C codec call per chunk, and back."""
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[cd[1]]
    chunks = _signals(dtype, seed=3) + _signals(dtype, seed=4)
    ours, theirs = PortOptions.from_cd_values(cd), \
        CompressionOptions.from_cd_values(cd)
    before = _calls()
    frames = api.vbz_compress_sized_batch(
        chunks, ours, backend=native_backend.native_backend)
    assert native_backend.CALLS["vbz_compress"] - \
        before["vbz_compress"] == len(chunks)
    assert frames == jax_api.vbz_compress_sized_batch(
        chunks, theirs, backend=jax_native.NativeSvbBackend())
    assert frames == api.vbz_compress_sized_batch(chunks, ours,
                                                  backend=oracle)
    before = _calls()
    back = api.vbz_decompress_sized_batch(
        frames, ours, backend=native_backend.native_backend)
    assert native_backend.CALLS["vbz_decompress"] - \
        before["vbz_decompress"] == len(chunks)
    for c, b in zip(chunks, back):
        np.testing.assert_array_equal(np.frombuffer(b, dtype), c)


def test_batch_decode_native_checks_the_destination(port_lib):
    """The gil_free_svb decode raises as the other path does on a size that
    the integer width does not divide."""
    from vbz_compression_tpu_torch.errors import VbzError

    opts = PortOptions.from_cd_values((0, 2, 1, 1))
    frame = bytearray(api.vbz_compress_sized(np.arange(8, dtype=np.int16),
                                             opts, backend=oracle))
    frame[0] = 15  # an odd original size
    for backend in (native_backend.native_backend, oracle):
        with pytest.raises(VbzError):
            api.vbz_decompress_sized_batch([bytes(frame)] * 2, opts,
                                           backend=backend)


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------


def test_build_is_cached_and_safe_from_threads(port_lib, tmp_path,
                                               monkeypatch):
    """Into an empty build root, six threads building every library at once
    all get the same loadable files; a second build compiles nothing."""
    monkeypatch.setattr(_native_build, "BUILD_ROOT", tmp_path)
    results, errors = [], []

    def run():
        try:
            results.append(_native_build.build())
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    paths = {name: p for name, (p, _s) in results[0].items()}
    assert all({n: p for n, (p, _s) in r.items()} == paths for r in results)
    for name, path in paths.items():
        assert path.parent.parent == tmp_path
        assert [f.name for f in path.parent.iterdir()] == [f"lib{name}.so"]
        ctypes.CDLL(str(path))
    assert all(s == 0.0 for _p, s in _native_build.build().values())
    assert paths["vbz_native"].read_bytes() == port_lib.read_bytes()


def test_declared_zstd_route(port_lib, tmp_path):
    """The route for machines without zstd.h: the port's declarations,
    linked against libzstd.so.1, give the library that the system header
    gives, call for call."""
    import subprocess

    out = tmp_path / "libvbz_native.so"
    cmd = _native_build.command("vbz_native", out, route="declared")
    assert "-l:libzstd.so.1" in cmd
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert not proc.stderr  # no warning under -Wall -Wextra
    with mock.patch.object(jax_nb, "_LIB_PATHS", [str(out)]), \
            mock.patch.object(jax_nb, "_lib", None):
        declared = jax_nb.lib()
        rng = np.random.default_rng(0)
        sig = np.clip(np.cumsum(rng.normal(0, 12, 40_000)), -2000,
                      2000).astype(np.int16)
        for cd in ((0, 2, 1, 1), (0, 0, 0, 1), (1, 2, 1, 3)):
            opts = CompressionOptions.from_cd_values(cd)
            frame = jax_nb.vbz_compress_sized(sig, opts)
            assert frame == native_backend.vbz_compress_sized(
                sig, PortOptions.from_cd_values(cd))
            assert jax_nb.vbz_decompress_sized(frame, opts) == sig.tobytes()
        assert hasattr(declared, "vbz_own_zstd_frame")
    assert _native_build.zstd_route() in _native_build.ZSTD_ROUTES
