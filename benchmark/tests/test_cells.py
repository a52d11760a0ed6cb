"""Every cell of BENCHMARK.json at a tiny size on the CPU: the program's run
is correct, and the control and each planted fault are not; and so for a
cell added as new files only."""

import contextlib
import json
import shutil
from pathlib import Path

import pytest

from benchmark.harness import cell as cell_mod, controls, faults, runner
from conftest import TINY_READS, tiny_traffic

BENCH = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def traffic_of(workload):
    cell = cell_mod.Cell.load(workload, 0, "cpu")
    return cell.traffic


def tiny_run(workload, trace=False, program=None, reads=TINY_READS,
             seed=2**31 + 5):
    return runner.run(workload, seed, 0.2, trace, "cpu", program=program,
                      config_override=reads,
                      traffic_override=tiny_traffic(traffic_of(workload)))


@pytest.mark.parametrize("workload", CELLS)
def test_program_run_is_correct(workload):
    out = tiny_run(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    e2e = [m["name"] for m in runner.metric_specs(BENCH, workload, False)]
    assert set(out["metrics"]) == {"setup_s", *e2e}
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_its_span_metrics(workload):
    out = tiny_run(workload, trace=True)
    assert out["correct"]
    spans = [m["name"] for m in runner.metric_specs(BENCH, workload, True)
             if m["source"] == "program_span"]
    assert set(spans) <= set(out["metrics"])
    assert "setup_s" not in out["metrics"]
    assert out["device"]["window_s"] > 0


BOUNDED = [w for w in CELLS if "traced_calls" in traffic_of(w)]


@pytest.mark.parametrize("workload", BOUNDED)
def test_a_traced_window_ends_after_its_traced_calls(workload):
    traffic = {**tiny_traffic(traffic_of(workload)), "traced_calls": 3}
    runs = {trace: runner.run(workload, 2**31 + 7, 3.0 if trace else 0.2,
                              trace, "cpu", config_override=TINY_READS,
                              traffic_override=traffic)
            for trace in (True, False)}
    assert runs[True]["correct"] and runs[False]["correct"]
    assert runs[True]["calls"] == 3
    assert runs[True]["attempted"] == 3 * traffic["reads_per_call"]
    assert runs[True]["device"]["window_s"] < 3.0
    assert runs[False]["calls"] > 3


# The write control needs reads long enough for libzstd's level-1 tables
# to differ from the stated parameters'.
LONG_READS = {"reads": {"count": 3, "shortest": 30_000, "longest": 36_000}}


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = cell_mod.Cell.load(workload, 9, "cpu",
                              config_override=LONG_READS)
    program = controls.for_entry(cell.traffic["entry"], cell)
    out = tiny_run(workload, program=program, reads=LONG_READS, seed=9)
    assert not out["correct"], out["checks"]


FAULT_CASES = [(w, f) for w in CELLS for f in faults.FAULTS
               if not (f == "half_batch_left_out"
                       and traffic_of(w)["reads_per_call"] == 1)]


@pytest.mark.parametrize("workload,fault", FAULT_CASES)
def test_planted_fault_is_not_correct(workload, fault):
    with faults.planted(fault, traffic_of(workload)["entry"]):
        out = tiny_run(workload)
    assert not out["correct"], out["checks"]


def test_an_entry_without_a_control_file_names_the_path():
    cell = cell_mod.Cell.load(CELLS[0], 0, "cpu")
    with pytest.raises(FileNotFoundError, match="controls/no_such_entry.py"):
        controls.for_entry("no_such_entry", cell)


# A throwaway cell whose program decodes through a stand-in for a ragged
# plane (``added_entry/stand_in_ragged_plane.py``), not the backend's W2
# pair: its entry, traffic, control and fault site are the files under
# ``added_entry/benchmark``, new to the benchmark, and ``BENCHMARK.json``
# gains the cell and names it in the metric it reports.
ADDED = Path(__file__).parent / "added_entry"
ADDED_CELL = "resident_zstd0.ragged_decode"


@pytest.fixture
def added_cell(tmp_path, monkeypatch):
    new = [p.relative_to(ADDED / "benchmark")
           for p in (ADDED / "benchmark").rglob("*") if p.is_file()]
    assert not any((cell_mod.BENCH / p).exists() for p in new)
    shutil.copytree(cell_mod.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copytree(ADDED / "benchmark", tmp_path / "benchmark",
                    dirs_exist_ok=True)
    bench = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": ADDED_CELL, "config": "resident_zstd0",
        "traffic": "ragged_decode", "chips": 1,
        "why": "a stand-in for a ragged plane"})
    for m in bench["end_to_end"]:
        if m["name"] == "resident_decode_gb_s":
            m["workloads"].append(ADDED_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(cell_mod, "ROOT", tmp_path)
    monkeypatch.setattr(cell_mod, "BENCH", tmp_path / "benchmark")
    monkeypatch.syspath_prepend(str(ADDED))


@pytest.mark.parametrize("mode", ["program", "control", *faults.FAULTS])
def test_an_entry_added_as_files_only(added_cell, mode):
    cell = cell_mod.Cell.load(ADDED_CELL, 0, "cpu")
    entry = cell.traffic["entry"]
    program = controls.for_entry(entry, cell) if mode == "control" else None
    planted = faults.planted(mode, entry) if mode in faults.FAULTS \
        else contextlib.nullcontext()
    with planted:
        out = tiny_run(ADDED_CELL, program=program)
    assert out["correct"] == (mode == "program"), out["checks"]
    assert set(out["metrics"]) == {"setup_s", "resident_decode_gb_s"}
