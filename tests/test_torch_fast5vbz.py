"""The port's ``utils/hdf5_chunks.py`` and ``tools/fast5vbz.py`` against the
JAX package's, on fast5 files written here with h5py: the same read names,
signals, vbz options and raw chunks; and ``fast5vbz`` in both directions
(``--backend torch``) writing the chunk bytes, cd_values and attributes that
the JAX tool writes with ``--backend scalar``.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from vbz_compression_tpu.tools import fast5vbz as jax_fast5vbz  # noqa: E402
from vbz_compression_tpu.utils import hdf5_chunks as jax_chunks  # noqa: E402
from vbz_compression_tpu_torch import (  # noqa: E402
    CompressionOptions, api, oracle)
from vbz_compression_tpu_torch.tools import fast5vbz  # noqa: E402
from vbz_compression_tpu_torch.utils import hdf5_chunks  # noqa: E402


def _reads() -> dict:
    rng = np.random.default_rng(5)
    walk = np.clip(500 + np.cumsum(rng.normal(0, 12, 50_000)), -2000,
                   2000).astype(np.int16)
    return {"read_0001": walk,
            "read_0002": rng.integers(-30000, 30000, 4097, dtype=np.int16),
            "read_0003": np.array([5, -7, 1], np.int16)}


@pytest.fixture
def gzip_fast5(tmp_path):
    """A multi-read gzip fast5: file and read attributes, a non-signal
    group per read and a top-level group."""
    path = str(tmp_path / "zip.fast5")
    with h5py.File(path, "w") as f:
        f.attrs["file_version"] = b"2.2"
        f.create_group("UniqueGlobalKey").attrs["sample"] = b"x"
        for name, sig in _reads().items():
            grp = f.create_group(name)
            grp.attrs["run_id"] = name.encode()
            grp.create_group("channel_id").attrs["digitisation"] = 8192.0
            ds = grp.create_group("Raw").create_dataset(
                "Signal", data=sig, chunks=(sig.size,), compression="gzip",
                compression_opts=1)
            ds.attrs["read_number"] = int(name[-4:])
    return path


def _signals(path) -> dict:
    """{read name: (raw chunk bytes, cd_values or None, attributes)}."""
    out = {}
    with h5py.File(path, "r") as f:
        for name, ds in hdf5_chunks.iter_signal_datasets(f):
            opts = hdf5_chunks.dataset_vbz_options(ds)
            chunks = hdf5_chunks.read_raw_chunks(ds)
            out[name] = (chunks, opts and opts.cd_values, dict(ds.attrs))
    return out


def _tree(path) -> dict:
    """Every group's attributes, and every non-signal dataset, by path."""
    items = {}
    with h5py.File(path, "r") as f:
        items["/"] = dict(f.attrs)

        def visit(name, obj):
            if not name.endswith("Raw/Signal"):
                items[name] = dict(obj.attrs)
        f.visititems(visit)
    return items


def test_reads_match_jax(gzip_fast5):
    with h5py.File(gzip_fast5, "r") as f:
        got = [n for n, _ in hdf5_chunks.iter_signal_datasets(f)]
        ref = [n for n, _ in jax_chunks.iter_signal_datasets(f)]
        assert got == ref == sorted(_reads())
        for name, ds in hdf5_chunks.iter_signal_datasets(f):
            assert hdf5_chunks.dataset_vbz_options(ds) is None
            assert hdf5_chunks.read_raw_chunks(ds) == \
                jax_chunks.read_raw_chunks(f[name]["Raw/Signal"])
    got = hdf5_chunks.read_gzip_signals(gzip_fast5)
    ref = jax_chunks.read_gzip_signals(gzip_fast5)
    assert list(got) == list(ref)
    for name, sig in _reads().items():
        np.testing.assert_array_equal(got[name], ref[name])
        np.testing.assert_array_equal(got[name], sig)


@pytest.mark.parametrize("version,level", [(0, 1), (0, 0), (1, 1)])
def test_fast5vbz_compress_matches_jax(gzip_fast5, tmp_path, version, level):
    args = ["--vbz-version", str(version), "--zstd-level", str(level)]
    port_out = str(tmp_path / "port.fast5")
    jax_out = str(tmp_path / "jax.fast5")
    assert fast5vbz.main([gzip_fast5, port_out, "--backend", "torch",
                          *args]) == 0
    assert jax_fast5vbz.main([gzip_fast5, jax_out, "--backend", "scalar",
                              *args]) == 0
    got, ref = _signals(port_out), _signals(jax_out)
    assert got == ref
    opts = CompressionOptions(True, 2, level, version)
    for name, sig in _reads().items():
        chunks, cd_values, _attrs = got[name]
        assert cd_values == opts.cd_values
        assert [c for _off, c in chunks] == [
            api.vbz_compress_sized(sig, opts, backend=oracle)]
    assert _tree(port_out) == _tree(jax_out)


def test_vbz_chunks_match_jax(gzip_fast5, tmp_path):
    """The vbz-side readers on a file that ``fast5vbz`` wrote."""
    vbz = str(tmp_path / "vbz.fast5")
    fast5vbz.main([gzip_fast5, vbz, "--backend", "torch"])
    got = list(hdf5_chunks.iter_vbz_signal_chunks(vbz))
    ref = list(jax_chunks.iter_vbz_signal_chunks(vbz))
    assert [(n, o.cd_values, c, k) for n, o, c, k in got] == \
        [(n, o.cd_values, c, k) for n, o, c, k in ref]
    assert [k for _n, _o, _c, k in got] == [s.size for s in _reads().values()]


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_fast5vbz_decompress_matches_jax(gzip_fast5, tmp_path, backend):
    """vbz -> gzip (``-d``): the port decodes the raw chunks itself, and
    writes the gzip chunks, signals and attributes the JAX tool writes."""
    vbz = str(tmp_path / "vbz.fast5")
    jax_fast5vbz.main([gzip_fast5, vbz, "--backend", "scalar"])
    port_out = str(tmp_path / "port.fast5")
    jax_out = str(tmp_path / "jax.fast5")
    assert fast5vbz.main([vbz, port_out, "-d", "--backend", backend]) == 0
    assert jax_fast5vbz.main([vbz, jax_out, "-d", "--backend", "scalar"]) == 0
    assert _signals(port_out) == _signals(jax_out)
    got = hdf5_chunks.read_gzip_signals(port_out)
    for name, sig in _reads().items():
        np.testing.assert_array_equal(got[name], sig)
    assert _tree(port_out) == _tree(jax_out) == _tree(gzip_fast5)


def test_fast5vbz_backend_choices(monkeypatch):
    """``auto`` is the api's default (the card, or the CPU under
    ``VBZ_BACKEND=torch``); ``torch`` the plain versions on the CPU;
    ``oracle`` the NumPy codec. There is no JAX choice."""
    monkeypatch.setenv("VBZ_BACKEND", "torch")
    assert str(fast5vbz.backend_of("auto").device) == "cpu"
    assert str(fast5vbz.backend_of("torch").device) == "cpu"
    assert fast5vbz.backend_of("oracle") is oracle
    with pytest.raises(SystemExit):
        fast5vbz.main(["a", "b", "--backend", "jax"])
