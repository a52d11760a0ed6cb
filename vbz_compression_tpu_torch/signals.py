"""Test signals for the port's smoke run and profiles, made with numpy from
a seed: the four ``bench.py`` tiers as B rows of N int16, and a corpus of
reads of log-uniform length."""

from __future__ import annotations

import numpy as np


def walk_with_reads(rng, total: int) -> np.ndarray:
    """sigma=12 walk on [0, 2000] that jumps to a new level at every read
    boundary (every 2000-8000 samples)."""
    steps = rng.normal(0, 12, total)
    walk = np.cumsum(steps)
    starts = np.cumsum(rng.integers(2000, 8000, total // 2000 + 1))
    starts = np.concatenate([[0], starts[starts < total]])
    seg = np.zeros(total, np.int64)
    seg[starts[1:]] = 1
    seg = np.cumsum(seg)
    level = rng.uniform(0, 2000, starts.size)
    sig = level[seg] + walk - (walk[starts] - steps[starts])[seg]
    return np.clip(sig, 0, 2000).astype(np.int16)


def tiers(B: int, N: int) -> dict:
    """The four content tiers, each [B, N] int16: realistic (walk with read
    boundaries), mixed (sigma=50 on +-30000), pure (the bench.py walk) and
    hard (uniform int16)."""
    pure = np.clip(500 + np.cumsum(np.random.default_rng(11).normal(
        0, 12, (B, N)), axis=1), -2000, 2000).astype(np.int16)
    realistic = walk_with_reads(np.random.default_rng(42), B * N).reshape(B, N)
    w = np.cumsum(np.random.default_rng(7).normal(0, 50, (B, N)), axis=1)
    mixed = ((w + 30000) % 60000 - 30000).astype(np.int16)
    hard = np.random.default_rng(13).integers(-32768, 32767, (B, N),
                                              dtype=np.int16)
    return {"realistic": realistic, "mixed": mixed, "pure": pure,
            "hard": hard}


def corpus(reads: int = 64, shortest: int = 2_000, longest: int = 4_000_000,
           seed: int = 2024) -> list:
    """``reads`` int16 reads of realistic content, lengths log-uniform on
    [shortest, longest]."""
    rng = np.random.default_rng(seed)
    lengths = np.exp(rng.uniform(np.log(shortest), np.log(longest),
                                 reads)).astype(np.int64)
    return [walk_with_reads(rng, int(n)) for n in lengths]
