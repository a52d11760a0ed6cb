"""A cell as one run sees it, and the files it is made of.

``BENCHMARK.json`` names a cell's configuration and traffic mix; the
configuration is ``configs/<name>.json`` (its read set's length
distribution ``lengths/<kind>.py``, ``reads.multiset``), the mix
``traffic/<name>.json``, the mix's entry module ``entries/<entry>.py``, and
each metric's reader
``metrics/<metric>.py``, or for a metric split by the end-to-end metric it
moves (``<quantity>.<part>``), ``metrics/<quantity>.py`` where the parts
read alike. Nothing here names a cell.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import torch

from . import reads, reference

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_module(path: Path):
    """A module of the benchmark's named files, loaded from its path (names
    may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader_path(metric: str) -> Path:
    """The reader of ``metric``: its own file, else its quantity's."""
    own = BENCH / "metrics" / f"{metric}.py"
    return own if own.is_file() else \
        BENCH / "metrics" / f"{metric.split('.')[0]}.py"


def _merged(base: dict, override: dict | None) -> dict:
    out = dict(base)
    for key, value in (override or {}).items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _merged(out[key], value)
        else:
            out[key] = value
    return out


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    device: torch.device

    @classmethod
    def load(cls, workload: str, seed: int, device, *,
             config_override: dict | None = None,
             traffic_override: dict | None = None) -> "Cell":
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        w = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        return cls(name=workload,
                   config=_merged(config, config_override),
                   traffic=_merged(traffic, traffic_override),
                   seed=int(seed), device=torch.device(device))

    # -- what set-up makes from the seed -------------------------------------

    @functools.cached_property
    def reads(self) -> reads.ReadSet:
        return reads.make(self.config["reads"], self.seed, self.device)

    @functools.cached_property
    def streams(self) -> reference.Streams:
        """The reference's v0 stream of every read."""
        rs = self.reads
        return reference.encode(rs.values, rs.starts, rs.lengths)

    @property
    def zstd_params(self) -> dict | None:
        """The zstd stage's parameters, None at level 0."""
        level = self.config["options"][3]
        return self.config["zstd"]["parameters"] if level else None

    def batch(self, k: int) -> np.ndarray:
        """The reads of call ``k``: the next ``reads_per_call`` of the set,
        cycling through it in its order."""
        b = self.traffic["reads_per_call"]
        return (k * b + np.arange(b)) % self.reads.count

    @property
    def period(self) -> int:
        """The number of calls after which ``batch`` repeats."""
        count = self.reads.count
        return count // math.gcd(count, self.traffic["reads_per_call"])

    @functools.cached_property
    def host_reads(self) -> list[np.ndarray]:
        return self.reads.host()

    @functools.cached_property
    def frames(self) -> list[bytes]:
        """The reference's sized frame of every read, at the configuration's
        options (the zstd calls spread over a few threads)."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(8) as pool:
            return reference.frames(self.streams.host(), self.reads.lengths,
                                    self.zstd_params, pool)

    def zstd_stage(self, stream: bytes) -> bytes:
        params = self.zstd_params
        return stream if params is None else reference.zstd.compress(
            stream, params)
