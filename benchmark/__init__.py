"""The benchmark of ``vbz_compression_tpu_torch`` on NVIDIA cards.

``run.py`` runs one cell of ``BENCHMARK.json``; ``control.py`` runs a cell
with the program replaced by the control or broken by a planted fault.
Configurations, traffic mixes, entry modules and metric readers are found by
name under ``configs/``, ``traffic/``, ``entries/`` and ``metrics/``."""
