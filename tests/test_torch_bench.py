"""The port's bench (``vbz_compression_tpu_torch.bench``), its workload and
its instrumentation on the CPU: ``signals.gen_signal`` byte for byte against
``native/gen_signal``, the bench's tiers against the root ``bench.py``'s,
the round trip of every tier through the plain versions, the shape and
metric names of its JSON lines, ``utils.profiling``'s chrome trace, and the
measurement paths raising without a card."""

import json
import os
import re
import subprocess

import numpy as np
import pytest
import torch

import bench as jax_bench
from vbz_compression_tpu_torch import api, bench, signals
from vbz_compression_tpu_torch.models.codec import TorchSvbBackend
from vbz_compression_tpu_torch.ops import _build, svb_w2
from vbz_compression_tpu_torch.utils import profiling, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")


@pytest.fixture(scope="module")
def gen_signal_binary(tmp_path_factory):
    """native/gen_signal.cpp built with the Makefile's CXXFLAGS into a
    directory of this test's own."""
    with open(os.path.join(NATIVE, "Makefile")) as f:
        flags = re.search(r"^CXXFLAGS \?= (.*)$", f.read(), re.M).group(1)
    out = str(tmp_path_factory.mktemp("gen_signal") / "gen_signal")
    subprocess.run(["g++", *flags.split(), "-o", out,
                    os.path.join(NATIVE, "gen_signal.cpp")], check=True,
                   timeout=300)
    return out


@pytest.mark.parametrize("args", [(12, 0, 2000, 42), (50, -30000, 30000, 7),
                                  (12, 0, 200, 5)])
def test_gen_signal_matches_native(gen_signal_binary, tmp_path, args):
    path = str(tmp_path / "signal.bin")
    subprocess.run([gen_signal_binary, path, "1", *map(str, args)],
                   check=True, timeout=120)
    want = np.fromfile(path, np.int16)
    got = signals.gen_signal(1, *args)
    assert got.dtype == np.int16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_glibc_logf_matches_libm():
    logf = signals._libm_logf()
    bits = np.random.default_rng(5).integers(0x00800000, 0x3F800001, 20000)
    x = np.concatenate([bits.astype(np.uint32).view(np.float32),
                        np.float32([1.0, 0.5, 2.0 ** -126, 0.999999])])
    want = np.array([logf(float(v)) for v in x], np.float32)
    np.testing.assert_array_equal(signals.glibc_logf(x).view(np.uint32),
                                  want.view(np.uint32))


def test_tiers_are_bench_py_tiers():
    B, N = 2, 4096
    rows = bench.tier_rows(B, N)
    assert list(rows) == list(bench.TIERS) == ["clean", "mixed", "pure",
                                               "hard"]
    for t, r in rows.items():
        assert r.shape == (B, N) and r.dtype == np.int16, t
    assert signals.CLEAN_ARGS == jax_bench.CLEAN_ARGS[1:]
    assert signals.MIXED_ARGS == jax_bench.MIXED_ARGS[1:]
    np.testing.assert_array_equal(
        rows["clean"].reshape(-1), signals.gen_signal(1, *signals.CLEAN_ARGS[
            1:])[:B * N])
    np.testing.assert_array_equal(
        rows["mixed"].reshape(-1), signals.gen_signal(1, *signals.MIXED_ARGS[
            1:])[:B * N])
    np.testing.assert_array_equal(rows["pure"], jax_bench.pure_signal(B, N))
    np.testing.assert_array_equal(rows["hard"], np.random.default_rng(
        13).integers(-32768, 32767, (B, N), dtype=np.int16))
    assert set(signals.tiers(B, N)) == {"realistic", *bench.TIERS}


@pytest.mark.parametrize("tier", bench.TIERS)
def test_round_trip_of_each_tier_on_the_cpu(tier):
    x = torch.from_numpy(bench.tier_rows(2, 4096)[tier])
    before = svb_w2.ENCODE_LAUNCHES, svb_w2.DECODE_LAUNCHES
    lens, keys, data, data_len = bench.round_trip(x)
    assert lens.tolist() == [4096, 4096]
    assert (svb_w2.ENCODE_LAUNCHES, svb_w2.DECODE_LAUNCHES) == before
    enc, dec = roofline.codec_bytes(x, keys, data_len)
    assert enc == x.nbytes + 16 + keys.numel() + int(data_len.sum())


def test_round_trip_raises_on_a_wrong_row(monkeypatch):
    real = svb_w2.decode_w2_rows

    def broken(*args):
        out = real(*args)
        out[1, 7] += 1
        return out

    monkeypatch.setattr(svb_w2, "decode_w2_rows", broken)
    with pytest.raises(RuntimeError, match=r"\[0, 1\]"):
        bench.round_trip(torch.from_numpy(bench.tier_rows(2, 64)["hard"]))


def _fake_tiers():
    """A record per tier with the keys measure_tiers fills (numbers made up;
    a CPU has no device time to give)."""
    tiers = {}
    for i, t in enumerate(bench.TIERS):
        enc, dec = 100.0 + i, 50.0 + i
        tiers[t] = {"input_bytes": 1000, "enc_bytes": 1600 + i,
                    "dec_bytes": 1590 + i, "enc_samples": [enc - 1, enc],
                    "dec_samples": [dec, dec - 1], "enc_cold": enc - 2,
                    "dec_cold": dec - 2, "enc": enc, "dec": dec,
                    "combined": bench._hm(enc, dec)}
    return tiers


def test_json_lines_carry_bench_py_metric_names():
    tiers = _fake_tiers()
    bench.roofline_shares(tiers, 2000.0)
    clean = tiers["clean"]
    assert clean["pct_of_roofline_enc"] == pytest.approx(
        100 * 100.0 * 1.6 / 2000.0)
    assert clean["pct_of_peak_dec"] == pytest.approx(
        100 * 50.0 * 1.59 / roofline.HBM_PEAK_GB_S)
    line = bench.codec_line(tiers, 2000.0, "a card")
    assert line["metric"] == "int16_signal_codec_encdec_throughput"
    assert line["unit"] == "GB/s" and line["value"] == clean["combined"]
    for t in ("mixed", "pure", "hard"):
        for k in ("gb_s", "encode_gb_s", "decode_gb_s"):
            assert f"{t}_{k}" in line
    for t in bench.TIERS:
        assert line[f"{t}_enc_samples"] == tiers[t]["enc_samples"]
        for k in ("pct_of_roofline_enc", "pct_of_roofline_dec",
                  "pct_of_peak_enc", "pct_of_peak_dec",
                  "encode_cold_gb_s", "decode_cold_gb_s"):
            assert f"{t}_{k}" in line
    assert line["hbm_copy_gb_s"] == 2000.0
    assert line["hbm_peak_gb_s"] == 3350.0
    assert line["sol_enc_gb_s"] == pytest.approx(2000.0 / 1.6)
    pipe = bench.pipeline_line({"enc": 1.0, "dec": 0.5, "combined": 2 / 3,
                                "bytes": 625, "input_bytes": 1000,
                                "zstd_level": 0, "zstd_route": None})
    assert pipe["metric"] == "int16_signal_pipeline_encdec_throughput"
    assert pipe["zstd_level"] == 0 and pipe["ratio"] == 0.625
    assert pipe["zstd_route"] is None
    assert set(bench.NOT_MEASURED) == {"int16_signal_pipeline_own_encoder",
                                       "vs_baseline"}
    for obj in (line, pipe, {"not_measured": bench.NOT_MEASURED}):
        assert json.loads(json.dumps(obj)) == obj


def test_own_encoder_line_follows_the_installed_package(monkeypatch):
    """The own encoder's line has the root bench.py's metric name and
    keys; it is measured at level 1 (the api's zstd stage decodes its
    frames) and listed as not measured, with the reason, at level 0."""
    own = {"enc": 0.02, "dec": 0.5, "combined": bench._hm(0.02, 0.5),
           "bytes": 630, "input_bytes": 1000, "zstd_level": 1}
    pipe = dict(own, bytes=600)
    line = bench.own_line(own, pipe)
    assert line["metric"] == "int16_signal_pipeline_own_encoder"
    assert line["value"] == own["combined"] and line["unit"] == "GB/s"
    assert line["size_vs_libzstd"] == pytest.approx(1.05)
    assert json.loads(json.dumps(line)) == line
    assert set(bench.not_measured(1)) == {"vs_baseline"}
    assert bench.not_measured(0) == bench.NOT_MEASURED
    assert "libzstd.so.1" in bench.not_measured(0)[bench.OWN_LINE]
    monkeypatch.setenv("VBZ_ZSTD_ENCODER", "own-tpu")
    with bench.encoder_env("own"):
        assert os.environ["VBZ_ZSTD_ENCODER"] == "own"
    assert os.environ["VBZ_ZSTD_ENCODER"] == "own-tpu"
    monkeypatch.delenv("VBZ_ZSTD_ENCODER")
    with bench.encoder_env("own"):
        pass
    with bench.encoder_env(None):
        assert "VBZ_ZSTD_ENCODER" not in os.environ
    assert "VBZ_ZSTD_ENCODER" not in os.environ


def test_zstd_level_follows_the_installed_package(monkeypatch):
    """Level 1 wherever the api's zstd stage runs: through zstandard, or
    through libzstd.so.1 where zstandard is missing; 0 where neither
    loads."""
    import ctypes.util

    from vbz_compression_tpu_torch.utils import libzstd

    assert bench.zstd_level() == 1
    monkeypatch.setattr(api, "_zstandard", lambda: None)
    assert bench.zstd_level() == 1
    monkeypatch.setattr(libzstd, "_NAMES", ("libzstd-absent.so.0",))
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    libzstd.lib.cache_clear()
    try:
        assert bench.zstd_level() == 0
    finally:
        libzstd.lib.cache_clear()


def test_measurements_need_a_card(monkeypatch):
    rows = bench.tier_rows(2, 64)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.measure_tiers(rows, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.pipeline_gbps(rows["clean"], TorchSvbBackend("cpu"), 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.run(rows)
    assert bench.main([]) == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.from_numpy(bench.tier_rows(1, 1024)["pure"])
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("round trip pure"):
            bench.round_trip(x)
    names = {e.key for e in prof.key_averages()}
    assert "round trip pure" in names
    with open(tmp_path / "trace.json") as f:
        assert "round trip pure" in f.read()


def test_trace_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace() as prof:
        with profiling.annotate("round trip hard"):
            bench.round_trip(torch.from_numpy(bench.tier_rows(1, 256)["hard"]))
    assert "round trip hard" in {e.key for e in prof.key_averages()}
    assert list(tmp_path.iterdir()) == []


def test_every_kernel_source_is_built_and_bound():
    """Each csrc/*.cu has a library, and each ctypes signature names an
    entry point of that source with as many parameters."""
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCES.values()) == sources
    assert set(_build.NAMES) == set(_build.SOURCES)
    paths = {_build.library_path(name) for name in _build.NAMES}
    assert len(paths) == len(_build.NAMES)
    for name, entries in _build._SIGNATURES.items():
        text = (_build.CSRC / _build.SOURCES[name]).read_text()
        for entry, argtypes in entries.items():
            m = re.search(rf"\bint {entry}\(([^)]*)\)", text)
            assert m, entry
            params = [p for p in m.group(1).split(",") if p.strip()]
            assert len(params) == len(argtypes), entry
