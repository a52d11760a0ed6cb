"""The port's sized pipeline (``vbz_compression_tpu_torch.api``) as a whole,
against the JAX package's pipeline on its XLA backend: identical sized
frames at zstd levels 0 and 1 for every flavor of the v0/v1 option lattice,
frames from either side decoding on the other, the backend choice, and a
port that imports nothing of the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vbz_compression_tpu import api as jax_api
from vbz_compression_tpu.models.codec import JaxSvbBackend
from vbz_compression_tpu.options import CompressionOptions
from vbz_compression_tpu_torch import CompressionOptions as PortOptions
from vbz_compression_tpu_torch import api, oracle, signals, stage_profile
from vbz_compression_tpu_torch.models.codec import TorchSvbBackend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BACKEND = JaxSvbBackend()


@pytest.fixture
def torch_cpu(monkeypatch):
    monkeypatch.setenv("VBZ_BACKEND", "torch")


def _chunks(dtype, seed):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    out = [np.clip(np.cumsum(rng.normal(0, info.max / 150, n)), info.min,
                   info.max).astype(dtype) for n in (4000, 1)]
    out.append(rng.integers(info.min, info.max + 1, 2501).astype(dtype))
    out.append(np.zeros(0, dtype))
    return out


@pytest.mark.parametrize("dtype,size", [(np.int16, 2), (np.int8, 1)])
@pytest.mark.parametrize("level", [0, 1])
def test_frames_match_jax_pipeline(torch_cpu, dtype, size, level):
    opts = CompressionOptions(True, size, level, 0)
    chunks = _chunks(dtype, seed=size + level)
    frames = api.vbz_compress_sized_batch(chunks, opts)
    for c, f in zip(chunks, frames):
        jf = jax_api.vbz_compress_sized(c, opts, backend=JAX_BACKEND)
        assert f == jf
        assert api.vbz_compress_sized(c, opts) == jf
        back = np.frombuffer(api.vbz_decompress_sized(jf, opts), dtype)
        np.testing.assert_array_equal(back, c)
    backs = api.vbz_decompress_sized_batch(frames, opts)
    for c, b in zip(chunks, backs):
        np.testing.assert_array_equal(np.frombuffer(b, dtype), c)
        assert jax_api.vbz_decompress_sized(
            api.vbz_compress_sized(c, opts), opts, backend=JAX_BACKEND) == b


def test_cross_decoding_numpy_api(torch_cpu):
    """pyvbz-style entry points: each side reads the other's frames."""
    sig = np.clip(np.cumsum(np.random.default_rng(2).normal(0, 40, 3000)),
                  -32768, 32767).astype(np.int16)
    ours = api.compress(sig)
    theirs = jax_api.compress(sig, backend=JAX_BACKEND)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(api.decompress(theirs, np.int16), sig)
    np.testing.assert_array_equal(
        jax_api.decompress(ours, np.int16, backend=JAX_BACKEND), sig)


def test_explicit_backend_is_used():
    opts = CompressionOptions(True, 2, 0, 1)   # v1 at width 2 is v0
    sig = np.arange(0, 3000, 7, dtype=np.int16)
    frame = api.vbz_compress_sized(sig, opts, backend=TorchSvbBackend("cpu"))
    assert frame == jax_api.vbz_compress_sized(sig, opts, backend=JAX_BACKEND)


def test_oracle_backend_through_port_api():
    """The re-exported NumPy oracle is a backend of the port's api, and its
    frames are the port's."""
    opts = CompressionOptions.from_cd_values((0, 2, 1, 0))
    sig = np.clip(np.cumsum(np.random.default_rng(6).normal(0, 90, 3333)),
                  -32768, 32767).astype(np.int16)
    frame = api.vbz_compress_sized(sig, opts, backend=oracle)
    assert frame == api.vbz_compress_sized(sig, opts,
                                           backend=TorchSvbBackend("cpu"))
    assert frame == jax_api.vbz_compress_sized(sig, opts, backend=JAX_BACKEND)


def test_stage_replays_match_api():
    """The profiler's stage-by-stage replays return what the batch api
    returns, so their stage times are the api's."""
    backend = TorchSvbBackend("cpu")
    opts = CompressionOptions.from_cd_values((0, 2, 1, 0))
    reads = signals.corpus(reads=6, shortest=1, longest=9000, seed=3)
    reads.insert(2, np.zeros(0, np.int16))
    frames, enc_ms = stage_profile.replay_encode(backend, reads, opts)
    assert frames == api.vbz_compress_sized_batch(reads, opts, backend=backend)
    back, dec_ms = stage_profile.replay_decode(backend, frames, opts)
    assert back == api.vbz_decompress_sized_batch(frames, opts,
                                                  backend=backend)
    for r, b in zip(reads, back):
        np.testing.assert_array_equal(np.frombuffer(b, np.int16), r)
    assert "kernel E" in enc_ms and "kernel D" in dec_ms
    assert all(v >= 0 for v in [*enc_ms.values(), *dec_ms.values()])


def test_default_backend_choice(monkeypatch):
    """torch is the CPU, native the C++ codec, any other name raises; unset,
    the card, and without one it raises."""
    from vbz_compression_tpu_torch.native_backend import NativeSvbBackend

    monkeypatch.setenv("VBZ_BACKEND", "torch")
    assert api.default_backend().device == torch.device("cpu")
    monkeypatch.setenv("VBZ_BACKEND", "native")
    assert isinstance(api.default_backend(), NativeSvbBackend)
    for other in ("cuda", "jax", "scalar"):
        monkeypatch.setenv("VBZ_BACKEND", other)
        with pytest.raises(ValueError, match="torch or native"):
            api.default_backend()
    monkeypatch.delenv("VBZ_BACKEND")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="VBZ_BACKEND=torch"):
        api.default_backend()
    with pytest.raises(RuntimeError):
        api.vbz_compress_sized(np.zeros(4, np.int16), CompressionOptions())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert api.default_backend().device.type == "cuda"


# cd_values (at zstd level 0) of the W4 flavors and v1 int8, with the
# content the pipeline gets for each.
_NEW_OPTIONS = [((0, 4, 1), np.int32), ((0, 4, 0), np.uint32),
                ((0, 2, 0), np.uint16), ((0, 1, 0), np.uint8),
                ((1, 1, 1), np.int8), ((1, 1, 0), np.uint8)]


@pytest.mark.parametrize("cd,dtype", _NEW_OPTIONS)
@pytest.mark.parametrize("level", [0, 1])
def test_new_flavor_frames_match_jax_pipeline(torch_cpu, cd, dtype, level):
    """W4 flavors and v1 int8 through the batch and single-chunk entry
    points: the JAX pipeline's frames, and each side decodes the other's."""
    ours = PortOptions.from_cd_values((*cd, level))
    theirs = CompressionOptions.from_cd_values((*cd, level))
    chunks = _chunks(dtype, seed=sum(cd) + level)
    frames = api.vbz_compress_sized_batch(chunks, ours)
    for c, f in zip(chunks, frames):
        jf = jax_api.vbz_compress_sized(c, theirs, backend=JAX_BACKEND)
        assert f == jf
        assert api.vbz_compress_sized(c, ours) == jf
        np.testing.assert_array_equal(
            np.frombuffer(api.vbz_decompress_sized(jf, ours), dtype), c)
        np.testing.assert_array_equal(
            np.frombuffer(jax_api.vbz_decompress_sized(
                f, theirs, backend=JAX_BACKEND), dtype), c)
    for c, b in zip(chunks, api.vbz_decompress_sized_batch(frames, ours)):
        np.testing.assert_array_equal(np.frombuffer(b, dtype), c)


@pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.uint8, np.uint32])
def test_dtype_inferred_flavors_match_jax(torch_cpu, dtype):
    """``compress(arr)`` infers the flavor from the dtype as pyvbz does
    (int32 is zz32, the unsigned dtypes the none flavors) at zstd level 1."""
    sig = _chunks(dtype, seed=9)[0]
    ours = api.compress(sig)
    np.testing.assert_array_equal(ours,
                                  jax_api.compress(sig, backend=JAX_BACKEND))
    np.testing.assert_array_equal(api.decompress(ours, dtype), sig)


def test_sizes_and_encoder_choice(monkeypatch):
    for cd in [(0, 2, 1, 1), (0, 4, 0, 0), (1, 1, 1, 1), (0, 0, 0, 1)]:
        assert api.vbz_max_compressed_size(
            12345 * 4, PortOptions.from_cd_values(cd)) == \
            jax_api.vbz_max_compressed_size(
                12345 * 4, CompressionOptions.from_cd_values(cd))
    monkeypatch.setenv("VBZ_BACKEND", "torch")
    for encoder in ("own", "own-tpu"):
        monkeypatch.setenv("VBZ_ZSTD_ENCODER", encoder)
        frame = api.zstd_compress(b"abc" * 99, 1)
        assert frame != api.zstd_compress(b"abc" * 99, 1, "libzstd")
        assert api.zstd_decompress(frame, 297) == b"abc" * 99
    monkeypatch.setenv("VBZ_ZSTD_ENCODER", "libzstd")
    assert api.zstd_decompress(api.zstd_compress(b"abc" * 99, 1), 297) == \
        b"abc" * 99


def test_import_leaves_jax_out():
    """Every module of the port, found by walking the package, and
    chip_smoke.py import nothing of JAX or of the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import chip_smoke\n"
            "import vbz_compression_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "want = {'bench', 'stage_profile', 'ops.probes', 'utils.roofline', "
            "'utils.profiling', 'tools.capability_probe', 'models.codec', "
            "'parallel.sharded', 'parallel.multihost', 'parallel.dryrun', "
            "'utils.hdf5_chunks', 'tools.fast5vbz', 'tools.multihost_smoke', "
            "'tools.corpus_times', 'ops.fse', 'ops.zstd_huff', "
            "'ops.zstd_seq', 'ops.zstd_match', 'native_backend', "
            "'utils._native_build', 'utils.native_fast5', "
            "'utils.h5py_helpers', 'tools.h5repack_vbz', "
            "'tools.benchmark_hdf5', 'utils.libzstd'}\n"
            "missing = {pkg.__name__ + '.' + w for w in want} - set(names)\n"
            "assert not missing, missing\n"
            "chip_smoke.Port()\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'vbz_compression_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'vbz_compression_tpu.')))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
