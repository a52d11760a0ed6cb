"""HDF5 end-to-end write-speed benchmark — counterpart of the reference's
``python/benchmark/benchmark.py`` (which produced the README result images)
and of ``vbz_plugin/perf/vbz_hdf_perf.cpp``.

The port's copy of ``vbz_compression_tpu.tools.benchmark_hdf5``; the vbz
cases write through the port's native plugin
(:func:`..utils.h5py_helpers.register_plugin`, built at first use). It
measures the host: h5py, libhdf5 and the C++ filter, no kernel of the port.

Times h5py dataset writes for {vbz (no zstd), vbz+zstd, gzip, lzf,
uncompressed} × {int8, int16, int32} over block sizes from 1 MiB up, and
reports MB/s + storage ratio as JSON lines, and optionally renders the
reference-README-style result images (``--plot DIR``: write-speed curves
per block size + compression-ratio bars, reference ``images/
vbz_x86_compression.png`` / ``vbz_compression_ratio.png``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def _signal_block(nbytes: int, dtype, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = nbytes // np.dtype(dtype).itemsize
    walk = np.cumsum(rng.normal(0, 12, n))
    info = np.iinfo(dtype)
    walk = np.clip(walk, info.min / 2, info.max / 2)
    return walk.astype(dtype)


def time_dataset(path, data, **dset_kwargs):
    import h5py

    t0 = time.perf_counter()
    with h5py.File(path, "w") as f:
        d = f.create_dataset("data", data=data, chunks=(data.size,),
                             **dset_kwargs)
        f.flush()
        storage = d.id.get_storage_size()
    dt = time.perf_counter() - t0
    os.remove(path)
    return dt, storage


def run(block_mb_list, dtypes, vbz_levels=(0, 1)):
    from ..utils import h5py_helpers

    h5py_helpers.register_plugin()  # the plugin path is set before use

    results = []
    tmp = tempfile.mkdtemp()
    for dtype in dtypes:
        for mb in block_mb_list:
            data = _signal_block(mb << 20, dtype)
            cases = {
                "uncompressed": {},
                "gzip1": {"compression": "gzip", "compression_opts": 1},
                "lzf": {"compression": "lzf"},
            }
            for lvl in vbz_levels:
                cases[f"vbz_z{lvl}"] = {
                    "compression": 32020,
                    "compression_opts": (0, np.dtype(dtype).itemsize, 1, lvl),
                }
            for name, kw in cases.items():
                path = os.path.join(tmp, "bench.h5")
                try:
                    dt, storage = time_dataset(path, data, **kw)
                except Exception as exc:  # filter unavailable etc.
                    print(json.dumps({"case": name, "error": str(exc)}))
                    continue
                rec = {
                    "case": name,
                    "dtype": np.dtype(dtype).name,
                    "block_mb": mb,
                    "write_mb_s": round(data.nbytes / dt / 1e6, 1),
                    "ratio": round(storage / data.nbytes, 4),
                }
                results.append(rec)
                print(json.dumps(rec))
    return results


def plot(results, out_dir):
    """Render write-speed curves + ratio bars (matplotlib, Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    dtypes = sorted({r["dtype"] for r in results})
    cases = sorted({r["case"] for r in results})
    for dtype in dtypes:
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for case in cases:
            pts = sorted((r["block_mb"], r["write_mb_s"]) for r in results
                         if r["dtype"] == dtype and r["case"] == case)
            if pts:
                ax.plot([x for x, _ in pts], [y for _, y in pts],
                        marker="o", label=case)
        ax.set_xlabel("block size (MiB)")
        ax.set_ylabel("write speed (MB/s)")
        ax.set_title(f"HDF5 write speed, {dtype}")
        ax.legend()
        fig.tight_layout()
        path = os.path.join(out_dir, f"hdf5_write_speed_{dtype}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        print(json.dumps({"plot": path}))

        fig, ax = plt.subplots(figsize=(7, 4.5))
        ratios = [(case, np.mean([r["ratio"] for r in results
                                  if r["dtype"] == dtype
                                  and r["case"] == case]))
                  for case in cases]
        ratios = [(c, v) for c, v in ratios if np.isfinite(v)]
        ax.bar([c for c, _ in ratios], [v for _, v in ratios])
        ax.set_ylabel("stored / raw")
        ax.set_title(f"Compression ratio, {dtype}")
        fig.tight_layout()
        path = os.path.join(out_dir, f"hdf5_ratio_{dtype}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        print(json.dumps({"plot": path}))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--blocks", type=int, nargs="+", default=[1, 4, 16])
    p.add_argument("--dtypes", nargs="+", default=["int16"],
                   choices=["int8", "int16", "int32"])
    p.add_argument("--plot", metavar="DIR", default=None,
                   help="render result images into DIR")
    args = p.parse_args(argv)
    results = run(args.blocks, [np.dtype(d) for d in args.dtypes])
    if args.plot:
        plot(results, args.plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
