"""Every metric reader of BENCHMARK.json on a synthetic window: spans,
device ops and counts whose shares are known."""

import json

import pytest

from benchmark.harness import cell as cell_mod, devtrace, runner, spans

BENCH = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
NAMES = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
         if m["name"] != "setup_s"]

S = 10**9  # one second in ns; the trace's clock in us, offset 0


def synthetic(with_layers=True) -> runner.Run:
    sp = spans.Spans()
    sp.records += [
        ("api.zstd_decompress", 0, S // 5, 1),
        ("api.zstd_decompress", S // 10, 3 * S // 10, 2),  # overlaps
        ("api.zstd_compress", S // 2, S, 1),
        ("backend.svb_compress_batch", 0, S // 4, 1),
        ("codec._check_stream", 0, S // 10, 1),
        ("codec._check_stream", S // 10, S // 5, 1),
    ]
    ops = [("void (anonymous namespace)::decode_w2<short, true>(...)",
            100_000.0, 200_000.0),
           ("void (anonymous namespace)::encode_w2<short, true>(...)",
            500_000.0, 520_000.0),
           ("Memcpy HtoD (Pageable -> Device)", 300_000.0, 350_000.0),
           ("gather", 340_000.0, 400_000.0)]
    trace = devtrace.DeviceTrace(ops, 0)
    return runner.Run(lo_ns=0, hi_ns=S, raw_bytes=2 * 10**9,
                      counts={"d_bytes": 335 * 10**8, "e_bytes": 67 * 10**8},
                      calls=10, spans=sp if with_layers else None,
                      trace=trace if with_layers else None,
                      call_ns=list(range(1, 101)) if with_layers else [])


EXPECTED = {
    "decode_gb_s": 2.0, "encode_gb_s": 2.0, "resident_decode_gb_s": 2.0,
    "zstd_pct.read": 30.0, "zstd_pct.write": 50.0,
    "backend_pct.write": 25.0, "validate_pct.read": 20.0,
    "d_roofline.read": 10.0, "d_roofline.resident": 10.0,
    "e_roofline.write": 10.0,
    "plane_ops_pct.resident": 100.0 * 0.13 / 0.23,
    "device_idle_pct.read": 78.0, "device_idle_pct.write": 78.0,
    "device_idle_pct.resident": 78.0,
    "call_p95_ms.read": 95.95e-6, "call_p95_ms.write": 95.95e-6,
}


def reader(name):
    return cell_mod.load_module(cell_mod.reader_path(name))


def test_every_metric_has_an_expectation():
    assert sorted(NAMES) == sorted(EXPECTED)


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_a_synthetic_window(name):
    assert reader(name).read(synthetic()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_reader_without_spans_or_trace_reads_nothing(name):
    assert reader(name).read(synthetic(with_layers=False)) is None


def test_spans_union_and_clip():
    sp = synthetic().spans
    assert sp.intervals("api.zstd_decompress", 0, S) == [(0, 3 * S // 10)]
    assert sp.share("api.zstd_decompress", S // 10, S // 5) == 1.0
    assert sp.share("nothing", 0, S) is None


def test_trace_busy_gaps_and_names():
    t = synthetic().trace
    assert t.busy_s(0, 1e6) == pytest.approx(0.22)
    assert t.gaps(0, 1e6)[0] == (0, 100_000.0)
    assert t.seconds_of(("decode_w2",)) == pytest.approx(0.1)
    assert t.by_name(1)[0][1] == pytest.approx(0.1)


def test_idle_gaps_split_by_the_covering_spans():
    run = synthetic()
    gaps = dict(runner._gaps(run))
    # Idle: [0, 0.1], [0.2, 0.3], [0.4, 0.5], [0.52, 1.0] s.
    assert gaps == pytest.approx({
        "api.zstd_compress": 0.48, "api.zstd_decompress": 0.2,
        "backend.svb_compress_batch": 0.15, "codec._check_stream": 0.1,
        "no span": 0.1})


def test_trace_file_round_trip(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({
        "baseTimeNanoseconds": 5_000_000, "traceEvents": [
            {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5},
            {"ph": "X", "cat": "cpu_op", "name": "aten::x", "ts": 0,
             "dur": 50},
            {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 20,
             "dur": 1}]}))
    t = devtrace.load(str(path), 0)
    assert [op[0] for op in t.ops] == ["k", "m"]
    assert t.ops[0][1] == 5_010.0


def test_a_part_reads_its_quantitys_file_unless_it_has_its_own():
    metrics = cell_mod.BENCH / "metrics"
    assert cell_mod.reader_path("device_idle_pct.write") == \
        metrics / "device_idle_pct.py"
    assert cell_mod.reader_path("zstd_pct.read") == metrics / "zstd_pct.read.py"
