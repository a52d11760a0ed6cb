"""Every metric reader of BENCHMARK.json on a synthetic window: the
harness's spans, the program's own spans (``benchmark/harness/program.py``),
device ops and counts whose shares are known; the merge of the program
spans' own time, and that the readers of the harness's wrappers read the
same after it."""

import json

import pytest

from benchmark.harness import cell as cell_mod, devtrace, program, runner, \
    spans
from vbz_compression_tpu_torch.utils.profiling import Span

BENCH = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
NAMES = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
         if m["name"] != "setup_s"]

S = 10**9  # one second in ns; the trace's clock in us, offset 0


def _span(name, a, b, thread, id_, parent, call, nbytes=0):
    return Span(name, int(a * S), int(b * S), thread, id_, parent, call,
                nbytes)


# The program's own spans (seconds): a batch decode whose zstd stage runs
# on two pool threads, a per-read encode, and a plane call.
PROGRAM = [
    _span("api.decompress_batch", 0.0, 0.5, 1, 1, 0, 1, 1000),
    _span("zstd.pool", 0.05, 0.25, 1, 2, 1, 1),
    _span("zstd.decompress", 0.05, 0.15, 2, 3, 2, 1, 500),
    _span("zstd.decompress", 0.10, 0.20, 3, 4, 2, 1, 500),
    _span("backend.decode", 0.25, 0.45, 1, 5, 1, 1),
    _span("backend.validate", 0.25, 0.30, 1, 6, 5, 1, 2 * 10**8),
    _span("backend.h2d", 0.30, 0.32, 1, 7, 5, 1, 2 * 10**7),
    _span("backend.launch", 0.32, 0.33, 1, 8, 5, 1),
    _span("backend.wait", 0.33, 0.36, 1, 9, 5, 1),
    _span("backend.d2h", 0.36, 0.40, 1, 10, 5, 1, 10**8),
    _span("api.compress", 0.6, 0.7, 1, 11, 0, 11, 100),
    _span("plane.decode", 0.8, 0.9, 1, 12, 0, 12),
    _span("plane.launch", 0.82, 0.85, 1, 13, 12, 12),
]


def synthetic(with_layers=True, program_spans=PROGRAM) -> runner.Run:
    """The window; ``program_spans`` stand for the recorder's records."""
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
    sp.program = program_spans
    return runner.Run(lo_ns=0, hi_ns=S, raw_bytes=2 * 10**9,
                      counts={"d_bytes": 335 * 10**8, "e_bytes": 67 * 10**8},
                      calls=10, spans=sp if with_layers else None,
                      trace=trace if with_layers else None,
                      call_ns=list(range(1, 101)) if with_layers else [])


EXPECTED = {
    "encode_gb_s": 2.0, "resident_decode_gb_s": 2.0,
    "zstd_pct.write": 50.0, "backend_pct.write": 25.0,
    "d_roofline.resident": 10.0, "e_roofline.write": 10.0,
    "plane_ops_pct.resident": 100.0 * 0.13 / 0.23,
    "device_idle_pct.write": 78.0, "device_idle_pct.resident": 78.0,
    "call_p95_ms.write": 95.95e-6,
    # The program's spans. Own time of the roots: [0, 0.05] and [0.45, 0.5]
    # s of the batch decode, all of the encode.
    "api_own_pct.write": 20.0, "copy_pct.write": 6.0,
    "copy_gb_s.write": 2.0, "device_wait_pct.write": 3.0,
    "plane_host_pct.resident": 10.0,
    # Idle 0.78 s; the spans cover 0.5 s of it (all but [0.5, 0.6],
    # [0.7, 0.8] and [0.9, 1.0]).
    "idle_unexplained_pct.write": 100.0 * 0.28 / 0.78,
    "idle_unexplained_pct.resident": 100.0 * 0.28 / 0.78,
}


def reader(name):
    return cell_mod.load_module(cell_mod.reader_path(name))


PROGRAM_NAMES = [n for n in NAMES if hasattr(reader(n), "program")]
HARNESS_NAMES = [n for n in NAMES if n not in PROGRAM_NAMES]
HARNESS_LABELS = {"api.zstd_decompress", "api.zstd_compress",
                  "backend.svb_compress_batch", "codec._check_stream"}


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
    assert cell_mod.reader_path("zstd_pct.write") == \
        metrics / "zstd_pct.write.py"


@pytest.mark.parametrize("name", HARNESS_NAMES)
def test_existing_reader_reads_the_same_after_the_merge(name):
    run = synthetic()
    before = reader(name).read(run)
    assert program.window(run) == PROGRAM
    assert reader(name).read(run) == before


def test_merge_adds_own_time_under_program_labels_once():
    run = synthetic()
    harness = list(run.spans.records)
    program.window(run)
    added = run.spans.records[len(harness):]
    assert run.spans.records[:len(harness)] == harness
    assert {r[0] for r in added} == {r.name for r in PROGRAM}
    assert not {r[0] for r in added} & HARNESS_LABELS
    assert run.spans.intervals("api.decompress_batch", 0, S) == [
        (0, S // 20), (9 * S // 20, S // 2)]
    # The pool's own time: its interval less its two threads' work.
    assert run.spans.intervals("zstd.pool", 0, S) == [(S // 5, S // 4)]
    program.window(run)
    assert len(run.spans.records) == len(harness) + len(added)


def test_merged_gaps_go_to_the_innermost_span():
    sp = spans.Spans()
    sp.program = PROGRAM
    # The device idle in [0.2, 0.3] and [0.33, 0.36] s only.
    ops = [("k", 0.0, 200_000.0), ("k", 300_000.0, 330_000.0),
           ("k", 360_000.0, 1e6)]
    run = runner.Run(lo_ns=0, hi_ns=S, raw_bytes=1, counts={}, calls=1,
                     spans=sp, trace=devtrace.DeviceTrace(ops, 0))
    program.window(run)
    # The pool's own time, then validation, then the wait: never their
    # parents, the decode and the batch call's root.
    assert dict(runner._gaps(run)) == pytest.approx({
        "zstd.pool": 0.05, "backend.validate": 0.05, "backend.wait": 0.03})


@pytest.mark.parametrize("name", PROGRAM_NAMES)
def test_program_reader_without_program_spans_reads_nothing(name):
    assert reader(name).read(synthetic(program_spans=[])) is None
