"""The port's corpus driver (``vbz_compression_tpu_torch.parallel.multihost``)
against the JAX driver (``vbz_compression_tpu.parallel.multihost``) and the
port's NumPy oracle, byte for byte.

``compress_signals`` runs on the inputs of ``tests/test_multihost.py``
(uniform reads of 5000, 12000, 130000 and 7 samples, seed 0; five rows of
20,000 uniform in +-30000, seed 3; walks of 30000, 70000 and 16384, seed 1)
at four option sets, against JAX's XLA plane. ``compress_corpus`` runs in a
gloo group of two processes (``tools/multihost_smoke.py``) over two gzip
fast5 files written here, against JAX's ``compress_corpus`` output files
and stats.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from vbz_compression_tpu import CompressionOptions as JaxOptions
from vbz_compression_tpu.parallel import multihost as jax_multihost
from vbz_compression_tpu_torch import CompressionOptions, api, oracle, signals
from vbz_compression_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120

OPTIONS = [(True, 2, 1, 0), (True, 2, 0, 0), (False, 2, 0, 0),
           (True, 2, 0, 1)]


def _uniform():
    rng = np.random.default_rng(0)
    return [rng.integers(-3000, 3000, n, dtype=np.int16)
            for n in (5000, 12_000, 130_000, 7)]


def _dense():
    rng = np.random.default_rng(3)
    return [rng.integers(-30000, 30000, 20_000, dtype=np.int16)
            for _ in range(5)]


def _walks():
    rng = np.random.default_rng(1)
    return [np.clip(500 + np.cumsum(rng.normal(0, 12, n)), -2000,
                    2000).astype(np.int16) for n in (30_000, 70_000, 16_384)]


INPUTS = {"uniform": _uniform, "dense": _dense, "walks": _walks}


@pytest.mark.parametrize("options", OPTIONS, ids=str)
@pytest.mark.parametrize("inputs", list(INPUTS))
def test_compress_signals_matches_jax_and_oracle(inputs, options):
    sigs = INPUTS[inputs]()
    got = multihost.compress_signals(sigs, CompressionOptions(*options),
                                     device="cpu")
    assert got == jax_multihost.compress_signals(
        sigs, JaxOptions(*options), plane="xla")
    assert got == [api.vbz_compress_sized(s, CompressionOptions(*options),
                                          backend=oracle) for s in sigs]


def test_compress_signals_buckets_and_edges():
    """Reads of 0-7 samples, on bucket edges and of a whole bucket: each
    frame the oracle's, in input order."""
    rng = np.random.default_rng(11)
    sigs = [rng.integers(-3000, 3000, n, dtype=np.int16)
            for n in (0, 1, 2, 3, 4, 5, 6, 7, 4095, 4096, 4097, 8192, 1)]
    opts = CompressionOptions(True, 2, 0, 0)
    got = multihost.compress_signals(sigs, opts, device="cpu")
    assert got == [api.vbz_compress_sized(s, opts, backend=oracle)
                   for s in sigs]
    assert [multihost.bucket_of(s.size) for s in sigs[7:12]] == [
        4096, 4096, 4096, 8192, 8192]


@pytest.mark.parametrize("options", [(True, 4, 0, 0), (True, 1, 0, 0)],
                         ids=str)
def test_compress_signals_refuses_other_widths(options):
    """The driver is int16 only: the JAX driver casts to int16 and writes
    frames that count the uncast bytes; the port raises."""
    sig = np.arange(100, dtype=np.int32)
    with pytest.raises(ValueError):
        multihost.compress_signals([sig], CompressionOptions(*options),
                                   device="cpu")
    with pytest.raises(ValueError):
        multihost.compress_signals([sig], CompressionOptions(True, 2, 0, 0),
                                   device="cpu")


def test_compress_signals_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.delenv("VBZ_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        multihost.compress_signals([np.zeros(8, np.int16)])
    monkeypatch.setenv("VBZ_BACKEND", "torch")
    assert len(multihost.compress_signals([np.zeros(8, np.int16)])) == 1


def _load_check_corpus_chip():
    """``tools/check_corpus_chip.py``, loaded by path with the JAX settings
    it changes put back."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "check_corpus_chip", os.path.join(REPO, "tools",
                                          "check_corpus_chip.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def test_pseudo_reads_match_make_corpus():
    ref = _load_check_corpus_chip().make_corpus()
    got = signals.pseudo_reads()
    assert len(got) == len(ref) == 256
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert sum(g.nbytes for g in got) == 40_528_974


def test_initialize_single_process_is_a_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize() is None
    assert multihost._local_share(["b", "a", "c"]) == ["a", "b", "c"]


def _write_gzip_fast5(path, reads: dict) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["file_version"] = b"2.0"
        for name, sig in reads.items():
            grp = f.create_group(name)
            grp.attrs["run_id"] = b"run0"
            grp.create_group("Raw").create_dataset(
                "Signal", data=sig, chunks=(sig.size,), compression="gzip",
                compression_opts=1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two gzip fast5 files of pseudo-reads (and a 7-sample read), the JAX
    driver's output and stats on them, and the port's from two gloo
    ranks."""
    tmp = tmp_path_factory.mktemp("corpus")
    reads = signals.pseudo_reads(6)
    reads[2] = reads[2][:7]
    paths = []
    for k in range(2):
        path = str(tmp / f"part{k}.fast5")
        _write_gzip_fast5(path, {f"read_{i:04d}": reads[i]
                                 for i in range(k, len(reads), 2)})
        paths.append(path)
    jax_dir, port_dir = tmp / "jax", tmp / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    jax_stats = jax_multihost.compress_corpus(paths, out_dir=str(jax_dir),
                                              plane="xla")

    env = dict(os.environ, PYTHONPATH=REPO, VBZ_BACKEND="torch")
    init = "file://" + str(tmp / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "vbz_compression_tpu_torch.tools.multihost_smoke", init, "2",
         str(r), str(port_dir), *paths, "--backend", "gloo"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    deadline = time.monotonic() + RANK_TIMEOUT
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads([ln for ln in out.splitlines()
                                    if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {"paths": paths, "reads": reads, "jax_dir": jax_dir,
            "port_dir": port_dir, "jax_stats": jax_stats, "port": outs}


def test_two_rank_corpus_stats_match_jax(corpus):
    """Both ranks report the same global stats, which are JAX's."""
    ref = corpus["jax_stats"]
    want = {"files": ref.files, "reads": ref.reads,
            "raw_bytes": ref.raw_bytes,
            "compressed_bytes": ref.compressed_bytes}
    assert want["files"] == 2 and want["reads"] == 6
    assert want["raw_bytes"] == sum(r.nbytes for r in corpus["reads"])
    for rank, o in enumerate(corpus["port"]):
        assert o["rank"] == rank and o["world"] == 2
        assert {k: o[k] for k in want} == want


def test_two_rank_corpus_files_match_jax(corpus):
    """Each rank wrote its file, byte for byte JAX's (a u32 length, then
    the sized frame, per read)."""
    for path in corpus["paths"]:
        name = os.path.basename(path) + ".vbz"
        got = (corpus["port_dir"] / name).read_bytes()
        assert got == (corpus["jax_dir"] / name).read_bytes()
        assert len(got) > 0


def test_compress_corpus_in_process_reads_through_read(tmp_path):
    """``read`` in place of fast5 files, no group: the same layout of the
    oracle's frames, stats of this process alone."""
    files = {"b": {"r0": np.arange(5000, dtype=np.int16)},
             "a": {"r0": np.full(9, -3, np.int16),
                   "r1": np.arange(40_000, dtype=np.int16) % 700}}
    opts = CompressionOptions(True, 2, 1, 0)
    stats = multihost.compress_corpus(list(files), str(tmp_path), opts,
                                      device="cpu", read=files.__getitem__)
    assert (stats.files, stats.reads) == (2, 3)
    for name, reads in files.items():
        frames = [api.vbz_compress_sized(s, opts, backend=oracle)
                  for s in reads.values()]
        assert (tmp_path / f"{name}.vbz").read_bytes() == b"".join(
            np.uint32(len(f)).tobytes() + f for f in frames)
    assert stats.raw_bytes == 2 * (5000 + 9 + 40_000)
