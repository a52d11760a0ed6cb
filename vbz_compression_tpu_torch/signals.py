"""Test signals for the port's smoke run and profiles, made with numpy from
a seed: the four ``bench.py`` tiers as B rows of N int16, a corpus of reads
of log-uniform length, and content for the other flavors (int32, int8 and
unsigned signals, uniform noise, the v1 odd-nibble pattern)."""

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


def int32_walk(rng, n: int) -> np.ndarray:
    """int32 walk 5e4 + cumsum(normal(0, 3e3)), as in the zz32 tests."""
    return (5e4 + np.cumsum(rng.normal(0, 3e3, n))).astype(np.int32)


def int8_walk(rng, n: int) -> np.ndarray:
    """sigma=3 int8 walk clipped to +-100."""
    return np.clip(np.cumsum(rng.normal(0, 3, n)), -100, 100).astype(np.int8)


def uniform(rng, n: int, dtype) -> np.ndarray:
    """Uniform noise over the whole range of a signed integer dtype."""
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=np.int64,
                        endpoint=True).astype(dtype)


def adc_counts(rng, n: int) -> np.ndarray:
    """uint16 counts of a 12-bit ADC: a sigma=12 walk around 500 clipped to
    [0, 4095]."""
    return np.clip(500 + np.cumsum(rng.normal(0, 12, n)), 0,
                   4095).astype(np.uint16)


def v1_odd_nibbles(n: int = 2048, seed: int = 3) -> np.ndarray:
    """int8 values that take every v1 code (0, 1, 2, 4 nibbles) and put
    values on odd nibble offsets across 4-value and 1024-value boundaries;
    at n=2048 it is ``test_v1_all_codes_and_odd_nibbles``'s input."""
    rng = np.random.default_rng(seed)
    sig = np.zeros(n, np.int8)
    sig[1::4] = 1
    sig[2::4] = rng.integers(-128, 128, n // 4)
    sig[3::4] = rng.integers(-8, 8, n // 4)
    return sig


# Content of each corpus kind: (generator of n values from rng, dtype).
CORPUS_KINDS = {
    "int32_walk": int32_walk,
    "int8_walk": int8_walk,
    "adc_u16": adc_counts,
    "u8": lambda rng, n: (int8_walk(rng, n).astype(np.int16)
                          + 128).astype(np.uint8),
    "u32": lambda rng, n: adc_counts(rng, n).astype(np.uint32) * 4099,
}


def corpus_of(kind: str, lengths, seed: int = 2025) -> list:
    """One read of ``kind`` content (``CORPUS_KINDS``) per length."""
    rng = np.random.default_rng(seed)
    return [CORPUS_KINDS[kind](rng, int(n)) for n in lengths]
