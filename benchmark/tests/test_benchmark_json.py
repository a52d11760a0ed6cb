"""BENCHMARK.json against the shape the benchmark's contract gives it, and
the harness driven by it alone: every named file exists, and no harness
file names a cell."""

import json
import re

import pytest

from benchmark.harness import cell as cell_mod

ROOT = cell_mod.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for x in ALL_METRICS + BENCH["workloads"]
             + BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in ALL_METRICS)
    for text in [w["why"] for w in BENCH["workloads"] + BENCH["configs"]] \
            + [c["source"] for c in BENCH["configs"]] \
            + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text


def test_named_files_exist():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        traffic = json.loads((cell_mod.BENCH / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (cell_mod.BENCH / "entries"
                / f"{traffic['entry']}.py").is_file()
    for m in ALL_METRICS:
        if m["name"] != "setup_s":
            assert cell_mod.reader_path(m["name"]).is_file()


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_states_source_assumptions_and_guarantees(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["source"] == config["source"]
    assert data["assumed"] and data["guarantees"]
    assert config["reduced"] == []


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_enough(w):
    def reported(kind):
        return [m["name"] for m in BENCH[kind]
                if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in reported("end_to_end")
    assert len(reported("end_to_end")) >= 2
    assert reported("per_layer")
    e2e = set(reported("end_to_end"))
    for m in BENCH["per_layer"]:
        if w["name"] in m["workloads"]:
            assert m["moves"] in e2e
    assert w["chips"] == 1


def test_harness_names_no_cell():
    cells = [w["name"] for w in BENCH["workloads"]]
    files = [cell_mod.BENCH / "run.py", cell_mod.BENCH / "control.py",
             *(cell_mod.BENCH / "harness").glob("*.py"),
             *(cell_mod.BENCH / "entries").glob("*.py"),
             *(cell_mod.BENCH / "controls").glob("*.py"),
             *(cell_mod.BENCH / "faults").glob("*.py")]
    for path in files:
        text = path.read_text()
        assert not any(c in text for c in cells), path
