"""The readers of the program's own spans (``benchmark/harness/program.py``)
on the synthetic window of ``test_metrics.py`` with program spans attached:
their values, the merge of the spans' own time, and that the readers of the
harness's wrappers read the same after the merge."""

import pytest

from benchmark.harness import devtrace, program, runner, spans
from test_metrics import NAMES, S, reader, synthetic as harness_window
from vbz_compression_tpu_torch.utils.profiling import Span

PROGRAM_NAMES = [n for n in NAMES if hasattr(reader(n), "program")]
HARNESS_NAMES = [n for n in NAMES if n not in PROGRAM_NAMES]
HARNESS_LABELS = {"api.zstd_decompress", "api.zstd_compress",
                  "backend.svb_compress_batch", "codec._check_stream"}


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

EXPECTED = {
    # Own time of the roots: [0, 0.05] and [0.45, 0.5] s of the batch
    # decode, all of the encode.
    "api_own_pct.read": 20.0, "api_own_pct.write": 20.0,
    "copy_pct.read": 6.0, "copy_pct.write": 6.0,
    "copy_gb_s.read": 2.0, "copy_gb_s.write": 2.0,
    "device_wait_pct.read": 3.0, "device_wait_pct.write": 3.0,
    "validate_gb_s.read": 4.0, "plane_host_pct.resident": 10.0,
    # Idle 0.78 s; the spans cover 0.5 s of it (all but [0.5, 0.6],
    # [0.7, 0.8] and [0.9, 1.0]).
    "idle_unexplained_pct.read": 100.0 * 0.28 / 0.78,
    "idle_unexplained_pct.write": 100.0 * 0.28 / 0.78,
    "idle_unexplained_pct.resident": 100.0 * 0.28 / 0.78,
}


def synthetic(program_spans=PROGRAM) -> runner.Run:
    """``test_metrics.py``'s window, with ``program_spans`` standing for
    the recorder's records."""
    run = harness_window()
    run.spans.program = program_spans
    return run


def test_every_program_metric_has_an_expectation():
    assert sorted(PROGRAM_NAMES) == sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_program_reader_on_a_synthetic_window(name):
    assert reader(name).read(synthetic()) == pytest.approx(EXPECTED[name])


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

