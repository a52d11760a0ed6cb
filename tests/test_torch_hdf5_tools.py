"""The port's HDF5 tooling against the JAX package's, on the CPU, on files
written here with h5py (never the reference corpus):

- ``utils.native_fast5`` reads the raw chunks, filter ids and cd_values
  that h5py and JAX's reader read, from fast5 files compressed through the
  port's plugin (vbz, v0 and v1) and through gzip; its vbz chunks decode to
  the signals; libhdf5 is h5py's bundled copy, else the system's;
- ``utils.h5py_helpers``: the plugin round trip, its directory and options;
- ``tools.h5repack_vbz``: the chunks, filters and attributes that JAX's
  repack writes, the CLI needing no ``HDF5_PLUGIN_PATH``;
- ``tools.benchmark_hdf5`` at one small block size: JAX's keys, cases and
  storage ratios, without importing matplotlib;
- ``tools.fast5vbz --backend native``: the JAX tool's datasets.

JAX's native reader and codec are pointed at the libraries the port built
from the same ``native/`` sources (nothing is written into ``native/``).
Exact: bytes and values.
"""

import json
import os
import subprocess
import sys
import unittest.mock as mock

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from vbz_compression_tpu import native_backend as jax_nb  # noqa: E402
from vbz_compression_tpu.tools import fast5vbz as jax_fast5vbz  # noqa: E402
from vbz_compression_tpu.tools import h5repack_vbz as jax_repack  # noqa: E402
from vbz_compression_tpu.utils import native_fast5 as jax_f5  # noqa: E402
from vbz_compression_tpu_torch import (  # noqa: E402
    CompressionOptions, api, native_backend, oracle)
from vbz_compression_tpu_torch.tools import (  # noqa: E402
    fast5vbz, h5repack_vbz)
from vbz_compression_tpu_torch.utils import (  # noqa: E402
    _native_build, h5py_helpers, hdf5_chunks, native_fast5)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def plugin():
    if not h5py_helpers.register_plugin():
        pytest.fail("the port's plugin directory holds no plugin")
    return h5py_helpers.plugin_dir()


@pytest.fixture
def jax_native(plugin):
    """JAX's codec and reader over the libraries the port built."""
    with mock.patch.object(jax_nb, "_LIB_PATHS", [str(
            _native_build.library("vbz_native"))]), \
            mock.patch.object(jax_nb, "_lib", None), \
            mock.patch.object(jax_f5, "_LIB_PATH", str(
                _native_build.library("fast5_reader"))), \
            mock.patch.object(jax_f5, "_lib", None):
        yield


def _reads() -> dict:
    rng = np.random.default_rng(5)
    walk = np.clip(500 + np.cumsum(rng.normal(0, 12, 50_000)), -2000,
                   2000).astype(np.int16)
    return {"read_0001": walk,
            "read_0002": rng.integers(-30000, 30000, 4097, dtype=np.int16),
            "read_0003": np.array([5, -7, 1], np.int16)}


def _fast5(path, **dataset_kwargs) -> str:
    with h5py.File(path, "w") as f:
        f.attrs["file_version"] = b"2.2"
        for name, sig in _reads().items():
            grp = f.create_group(name)
            grp.attrs["run_id"] = name.encode()
            grp.create_group("Raw").create_dataset(
                "Signal", data=sig, chunks=(sig.size,), **dataset_kwargs)
    return str(path)


COMPRESSIONS = {
    "vbz v0": lambda: h5py_helpers.dataset_opts(),
    "vbz v1 level 0": lambda: h5py_helpers.dataset_opts(zstd_level=0,
                                                        version=1),
    "gzip": lambda: {"compression": "gzip", "compression_opts": 1},
}


@pytest.mark.parametrize("compression", list(COMPRESSIONS))
def test_native_reader_matches_h5py_and_jax(jax_native, tmp_path,
                                            compression):
    path = _fast5(tmp_path / "reads.fast5", **COMPRESSIONS[compression]())
    assert native_fast5._find_hdf5() == jax_f5._find_hdf5()
    with native_fast5.Fast5File(path) as f, jax_f5.Fast5File(path) as g, \
            h5py.File(path, "r") as hf:
        names = f.signal_names()
        assert names == g.signal_names() == [
            f"{n}/Raw/Signal" for n in _reads()]
        for name in names:
            ds = hf[name]
            info = f.dataset_info(name)
            assert vars(info) == vars(g.dataset_info(name))
            assert info.nelems == ds.shape[0]
            assert f.chunk_count(name) == g.chunk_count(name) == 1
            raw, loff, mask = f.read_chunk(name, 0)
            fm, want = ds.id.read_direct_chunk((0,))
            assert (raw, loff, mask) == (want, 0, fm) == g.read_chunk(name, 0)
            vbz = hdf5_chunks.dataset_vbz_options(ds)
            if vbz is None:
                assert info.filter_id == 1  # deflate
                continue
            assert info.filter_id == hdf5_chunks.VBZ_FILTER_ID
            assert native_fast5.options_from_cd(info.cd_values) == vbz
    got = list(native_fast5.iter_signal_chunks(path))
    assert [(n, vars(i), r) for n, i, r in got] == [
        (n, vars(i), r) for n, i, r in jax_f5.iter_signal_chunks(path)]
    if compression != "gzip":
        for (name, info, raw), sig in zip(got, _reads().values()):
            opts = native_fast5.options_from_cd(info.cd_values)
            np.testing.assert_array_equal(np.frombuffer(
                api.vbz_decompress_sized(raw, opts, backend=oracle),
                np.int16), sig)


def test_find_hdf5_falls_back_to_the_system(monkeypatch):
    """Without h5py, the system's libhdf5 (ctypes.util.find_library)."""
    import builtins
    import ctypes.util

    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    monkeypatch.setattr(ctypes.util, "find_library",
                        lambda name: f"lib{name}.so.310")
    assert native_fast5._find_hdf5() == "libhdf5.so.310"
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    assert native_fast5._find_hdf5() is None


def test_options_from_cd_matches_jax():
    for cd in ((0, 2, 1), (0, 2, 1, 1), (1, 1, 0, 0, 9), (0, 4, 1, 3)):
        assert native_fast5.options_from_cd(cd).cd_values == \
            jax_f5.options_from_cd(cd).cd_values


def test_h5py_helpers_roundtrip(plugin, tmp_path):
    """As ``tests/test_native.py::test_h5py_helpers_roundtrip``, through the
    port's plugin, whose directory holds that library alone."""
    assert os.listdir(plugin) == ["libvbz_hdf_plugin.so"]
    assert os.path.dirname(plugin) == str(_native_build.BUILD_ROOT)
    assert h5py_helpers.register_plugin()
    assert not h5py_helpers.register_plugin(str(tmp_path))
    sig = np.arange(-5000, 5000, dtype=np.int16)
    path = str(tmp_path / "helper.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("s", data=sig, chunks=(sig.size,),
                         **h5py_helpers.dataset_opts())
        f.create_dataset("v1", data=sig.astype(np.int8), chunks=(sig.size,),
                         **h5py_helpers.dataset_opts(np.int8, version=1))
        f.create_dataset("plain", data=sig)
    with h5py.File(path) as f:
        np.testing.assert_array_equal(f["s"][...], sig)
        np.testing.assert_array_equal(f["v1"][...], sig.astype(np.int8))
        opts = h5py_helpers.options_of(f["s"])
        assert opts.integer_size == 2 and opts.perform_delta_zig_zag
        assert h5py_helpers.options_of(f["v1"]).cd_values == (1, 1, 1, 1)
        assert h5py_helpers.options_of(f["plain"]) is None
        _, raw = f["s"].id.read_direct_chunk((0,))
        assert raw == api.vbz_compress_sized(sig, opts, backend=oracle)
    assert h5py_helpers.dataset_opts(np.uint16, zigzag=True) == {
        "compression": 32020, "compression_opts": (0, 2, 1, 1)}


@pytest.mark.parametrize("spec", ["UD=32020,0,4,0,2,1,1",
                                  "UD=32020,1,4,1,1,1,0", "UD=1,0,1,6",
                                  "UD=32020,0,3,0,2", "GZIP=6", "UD=32020"])
def test_parse_ud_matches_jax(spec):
    try:
        want = jax_repack.parse_ud(spec)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)[:20]):
            h5repack_vbz.parse_ud(spec)
        return
    assert h5repack_vbz.parse_ud(spec) == want


def _chunks_and_filters(path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                raw = None
                if obj.chunks and obj.size:
                    raw = obj.id.read_direct_chunk((0,) * obj.ndim)[1]
                out[name] = (obj.chunks, dict(obj._filters), raw,
                             dict(obj.attrs))
        f.visititems(visit)
        out["/"] = dict(f.attrs)
    return out


@pytest.mark.parametrize("spec,chunk", [("UD=32020,0,4,0,2,1,1", 65536),
                                        ("UD=32020,0,4,0,2,1,0", 1000)])
def test_h5repack_matches_jax(plugin, tmp_path, spec, chunk):
    """The port's CLI, in a process of its own with no HDF5_PLUGIN_PATH,
    writes the file that JAX's repack writes through the same plugin: a
    contiguous and a chunked signal, an int32 and a scalar dataset, groups
    and attributes."""
    src = str(tmp_path / "in.h5")
    sig = np.arange(0, 50000, dtype=np.int16)
    with h5py.File(src, "w") as f:
        f.attrs["kind"] = b"test"
        f.create_dataset("s", data=sig)
        g = f.create_group("read_1/Raw")
        g.attrs["n"] = 3
        g.create_dataset("Signal", data=sig[::-1], chunks=(4096,))
        f.create_dataset("i32", data=np.arange(-70000, 70000, 7, np.int32),
                         chunks=(5000,))
        f.create_dataset("scalar", data=5)
    port_out, jax_out = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    env = {k: v for k, v in os.environ.items() if k != "HDF5_PLUGIN_PATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "vbz_compression_tpu_torch.tools.h5repack_vbz",
         "-f", spec, "--chunk", str(chunk), src, port_out],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert jax_repack.main(["-f", spec, "--chunk", str(chunk), src,
                            jax_out]) == 0
    got = _chunks_and_filters(port_out)
    assert got == _chunks_and_filters(jax_out)
    assert "32020" in got["s"][1] and "32020" in got["read_1/Raw/Signal"][1]
    with h5py.File(port_out) as f:
        np.testing.assert_array_equal(f["s"][...], sig)
        np.testing.assert_array_equal(f["read_1/Raw/Signal"][...], sig[::-1])
    assert h5repack_vbz.main(["-f", "UD=32020,0,9,1", src,
                              str(tmp_path / "x.h5")]) == 1


def test_benchmark_hdf5_lines_match_jax():
    """One 1 MiB int16 block: the port's and JAX's JSON lines have the same
    keys, cases and storage ratios (the same filters on the same data), and
    the port's run imports no matplotlib."""
    code = (
        "import json, sys\n"
        "from vbz_compression_tpu_torch.tools import benchmark_hdf5 as b\n"
        "import numpy as np\n"
        "ours = b.run([1], [np.dtype('int16')])\n"
        "assert 'matplotlib' not in sys.modules\n"
        "from vbz_compression_tpu.tools import benchmark_hdf5 as j\n"
        "theirs = j.run([1], [np.dtype('int16')])\n"
        "print(json.dumps([ours, theirs]))\n")
    env = {k: v for k, v in os.environ.items() if k != "HDF5_PLUGIN_PATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ours, theirs = json.loads(proc.stdout.splitlines()[-1])
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    assert [(r["case"], r["dtype"], r["block_mb"], r["ratio"])
            for r in ours] == [(r["case"], r["dtype"], r["block_mb"],
                                r["ratio"]) for r in theirs]
    assert {r["case"] for r in ours} == {"uncompressed", "gzip1", "lzf",
                                         "vbz_z0", "vbz_z1"}


@pytest.mark.parametrize("version,level", [(0, 1), (0, 0), (1, 1)])
def test_fast5vbz_native_matches_jax(jax_native, tmp_path, version, level):
    """``--backend native`` writes the datasets of the JAX tool's
    ``--backend native``, and ``-d --backend native`` reads them back."""
    src = _fast5(tmp_path / "zip.fast5", compression="gzip")
    args = ["--vbz-version", str(version), "--zstd-level", str(level),
            "--backend", "native"]
    port_out, jax_out = str(tmp_path / "port.fast5"), \
        str(tmp_path / "jax.fast5")
    before = dict(native_backend.CALLS)
    assert fast5vbz.main([src, port_out, *args]) == 0
    assert native_backend.CALLS["vbz_compress"] - \
        before["vbz_compress"] == len(_reads())
    assert jax_fast5vbz.main([src, jax_out, *args]) == 0
    assert _chunks_and_filters(port_out) == _chunks_and_filters(jax_out)
    opts = CompressionOptions(True, 2, level, version)
    with h5py.File(port_out, "r") as f:
        for name, sig in _reads().items():
            _, raw = f[name]["Raw/Signal"].id.read_direct_chunk((0,))
            assert raw == api.vbz_compress_sized(sig, opts, backend=oracle)
    back = str(tmp_path / "back.fast5")
    assert fast5vbz.main([port_out, back, "-d", "--backend", "native"]) == 0
    got = hdf5_chunks.read_gzip_signals(back)
    for name, sig in _reads().items():
        np.testing.assert_array_equal(got[name], sig)
    assert fast5vbz.backend_of("native") is native_backend.native_backend
