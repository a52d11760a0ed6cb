"""``run.py`` fails, and prints no result, without a card or without the
program, and tells a run that loaded JAX or the JAX package; no module of
the benchmark loads JAX or the JAX package."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.harness import cell as cell_mod

ROOT = cell_mod.ROOT
ARGS = ["--workload", "fast5_zstd1.write_per_read", "--seed", "1",
        "--seconds", "1", "--trace", "0"]


def run_py(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_no_card_fails_without_a_result():
    p = run_py(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "does not fall back" in p.stderr


def test_checkout_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_py(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


PROBE = r"""
import glob, json, os, sys
sys.path.insert(0, ".")
os.environ["VBZ_BACKEND"] = "torch"
import benchmark.run, benchmark.control
from benchmark.harness import (cell, controls, counting, devtrace, faults,
                               reads, reference, runner, sample, spans, zstd)
for path in glob.glob("benchmark/entries/*.py") + glob.glob(
        "benchmark/metrics/*.py"):
    cell.load_module(cell.Path(path))
from vbz_compression_tpu_torch import api
api._zstandard = lambda: None
runner.run("fast5_zstd1.write_per_read", 1, 0.1, True, "cpu",
           config_override={"reads": {"count": 4, "shortest": 100,
                                      "longest": 900}},
           traffic_override={"reads_per_call": 1, "sample_calls": 2,
                             "warmup_calls": 1})
print(json.dumps(sorted(m for m in sys.modules if m == "jax"
      or m.startswith("jax.") or m == "vbz_compression_tpu"
      or m.startswith("vbz_compression_tpu."))))
"""


def test_no_module_loads_jax_or_the_jax_package():
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("modules,found", [
    (["os", "torch", "vbz_compression_tpu_torch.api", "jax_like"], []),
    (["jax.numpy", "torch"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["vbz_compression_tpu.api", "vbz_compression_tpu_torch"],
     ["vbz_compression_tpu"]),
])
def test_forbidden_modules_by_whole_top_level_name(modules, found):
    assert run.forbidden_loaded(modules) == found
