"""CPU tests of the benchmark: the plain PyTorch versions of the program
(``VBZ_BACKEND=torch``), the api's zstd stage on ``libzstd.so.1`` as on the
card's machine, tiny read sets.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_READS = {"reads": {"count": 9, "shortest": 300, "longest": 3000}}


def tiny_traffic(cell_traffic: dict) -> dict:
    """Calls of a few reads and a small sample, for any traffic mix."""
    b = min(cell_traffic["reads_per_call"], 4)
    return {"reads_per_call": b, "sample_calls": min(
        cell_traffic["sample_calls"], 4), "warmup_calls": 1}


@pytest.fixture(autouse=True)
def plain_program(monkeypatch):
    monkeypatch.setenv("VBZ_BACKEND", "torch")
    from vbz_compression_tpu_torch import api

    monkeypatch.setattr(api, "_zstandard", lambda: None)
