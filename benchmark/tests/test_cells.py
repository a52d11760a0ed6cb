"""Every cell of BENCHMARK.json at a tiny size on the CPU: the program's run
is correct, and the control and each planted fault are not."""

import json

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
    with faults.planted(fault):
        out = tiny_run(workload)
    assert not out["correct"], out["checks"]
