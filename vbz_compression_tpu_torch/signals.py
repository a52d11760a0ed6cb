"""Test signals for the port's smoke run, bench and profiles, made with
numpy from a seed: the ``bench.py`` tiers as B rows of N int16 (its
``clean`` and ``mixed`` tiers byte for byte, through :func:`gen_signal`),
a corpus of reads of log-uniform length, content for the other flavors
(int32, int8 and unsigned signals, uniform noise, the v1 odd-nibble
pattern), the inputs that carry the look-back of W2, W4 and v1 across
tile edges, and the match scan's cases and the clean chunk's payload."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .ops import scalar

# bench.py's workload arguments (bench.py:75-76): MB, sigma, lo, hi, seed.
CLEAN_ARGS = (32, 12, 0, 2000, 42)
MIXED_ARGS = (32, 50, -30000, 30000, 7)

# glibc's logf (sysdeps/ieee754/flt-32/e_logf.c and e_logf_data.c): 16
# (1/c, log c) pairs, ln 2 and the log1p polynomial, in double.
_LOGF_TABLE = np.array([float.fromhex(h) for h in (
    "0x1.661ec79f8f3bep+0", "-0x1.57bf7808caadep-2",
    "0x1.571ed4aaf883dp+0", "-0x1.2bef0a7c06ddbp-2",
    "0x1.49539f0f010b0p+0", "-0x1.01eae7f513a67p-2",
    "0x1.3c995b0b80385p+0", "-0x1.b31d8a68224e9p-3",
    "0x1.30d190c8864a5p+0", "-0x1.6574f0ac07758p-3",
    "0x1.25e227b0b8ea0p+0", "-0x1.1aa2bc79c8100p-3",
    "0x1.1bb4a4a1a343fp+0", "-0x1.a4e76ce8c0e5ep-4",
    "0x1.12358f08ae5bap+0", "-0x1.1973c5a611cccp-4",
    "0x1.0953f419900a7p+0", "-0x1.252f438e10c1ep-5",
    "0x1.0000000000000p+0", "0x0.0p+0",
    "0x1.e608cfd9a47acp-1", "0x1.aa5aa5df25984p-5",
    "0x1.ca4b31f026aa0p-1", "0x1.c5e53aa362eb4p-4",
    "0x1.b2036576afce6p-1", "0x1.526e57720db08p-3",
    "0x1.9c2d163a1aa2dp-1", "0x1.bc2860d224770p-3",
    "0x1.886e6037841edp-1", "0x1.1058bc8a07ee1p-2",
    "0x1.767dcf5534862p-1", "0x1.4043057b6ee09p-2")]).reshape(16, 2)
_LOGF_LN2 = float.fromhex("0x1.62e42fefa39efp-1")
_LOGF_POLY = [float.fromhex(h) for h in (
    "-0x1.00ea348b88334p-2", "0x1.5575b0be00b6ap-2", "-0x1.ffffef20a4123p-2")]
_PAIRS_PER_CHUNK = 1 << 21


@functools.cache
def _libm_logf():
    fn = ctypes.CDLL("libm.so.6").logf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def glibc_logf(x: np.ndarray) -> np.ndarray:
    """glibc's ``logf`` of positive normal float32 values, vectorised.

    glibc evaluates a table lookup and a degree-3 polynomial in double and
    rounds once to float; this does the same in numpy. Where the double
    result lies so near a float32 rounding boundary that the fused
    multiply-adds of glibc's build could round it the other way, the value
    is asked of ``libm`` itself (a few in 10^5).
    """
    ix = x.view(np.uint32).astype(np.int64)
    tmp = ix - 0x3F330000
    i = (tmp >> 19) & 15
    k = tmp >> 23
    z = (ix - (tmp & ~0x7FFFFF)).astype(np.uint32).view(np.float32).astype(
        np.float64)
    r = z * _LOGF_TABLE[i, 0] - 1
    y0 = _LOGF_TABLE[i, 1] + k * _LOGF_LN2
    r2 = r * r
    y = _LOGF_POLY[1] * r + _LOGF_POLY[2]
    y = _LOGF_POLY[0] * r2 + y
    y = y * r2 + (y0 + r)
    f = y.astype(np.float32)
    fd = f.astype(np.float64)
    toward = np.where(y > fd, np.float32(np.inf), np.float32(-np.inf))
    mid = 0.5 * (fd + np.nextafter(f, toward).astype(np.float64))
    near = np.nonzero(np.abs(y - mid)
                      <= 2.0 ** -40 * (np.abs(y0) + np.abs(r) + np.abs(y)))[0]
    if near.size:
        logf = _libm_logf()
        f[near] = [logf(float(v)) for v in x[near]]
    return f


def _f32_sum_once(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32(a + b) with a single rounding (a fused multiply-add's), for
    float64 ``a`` and ``b``: the double sum is made round-to-odd from its
    exact error term, then rounded to float32."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    even = (s.view(np.uint64) & 1) == 0
    toward = np.where(err > 0, np.inf, -np.inf)
    s = np.where((err != 0) & even, np.nextafter(s, toward), s)
    return s.astype(np.float32)


def _normals(seed: int, n: int) -> np.ndarray:
    """The first ``n`` draws of libstdc++'s ``normal_distribution<float>``
    (mean 0, sigma 1) on ``std::mt19937(seed)``: the polar method, pairs of
    words per attempt, y * mult returned first and x * mult kept for the
    next draw."""
    bits = np.random.MT19937()
    bits._legacy_seeding(seed)                      # std::mt19937(seed)
    below_one = np.nextafter(np.float32(1), np.float32(0))
    want = (n + 1) // 2
    out = []
    while want:
        tries = min(int(want / 0.78) + 64, _PAIRS_PER_CHUNK)
        words = bits.random_raw(2 * tries).astype(np.uint32)
        # generate_canonical<float>: float(word) / 2^32, kept below 1.
        u = np.minimum(words.astype(np.float32) * np.float32(2.0 ** -32),
                       below_one)
        v = ((2 * u).astype(np.float64) - 1.0).astype(np.float32)
        x, y = v[0::2], v[1::2]
        # r2 = x * x + y * y, contracted by the compiler to fma(x, x, y * y).
        r2 = _f32_sum_once(x.astype(np.float64) ** 2,
                           (y * y).astype(np.float64))
        keep = np.nonzero((r2 <= 1.0) & (r2 != 0.0))[0][:want]
        x, y, r2 = x[keep], y[keep], r2[keep]
        mult = np.sqrt(np.float32(-2) * glibc_logf(r2) / r2)
        out.append(np.stack([y * mult, x * mult], axis=1).reshape(-1))
        want -= keep.size
    return np.concatenate(out)[:n]


def _reset_walk(steps: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """acc = mid; for each step: acc += step (float32), back to mid when
    outside [lo, hi]; int16 of acc (truncated). Runs between resets are
    summed by np.add.accumulate, which adds in order."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    mid = np.float32(0.5) * np.float32(lo + hi)
    out = np.empty(steps.size, np.float32)
    acc, p, window = mid, 0, 4096
    while p < steps.size:
        seg = np.concatenate([[acc], steps[p:p + window]]).astype(np.float32)
        run = np.add.accumulate(seg, dtype=np.float32)[1:]
        out_of = np.nonzero((run < lo32) | (run > hi32))[0]
        if out_of.size == 0:
            out[p:p + run.size] = run
            acc, p = run[-1], p + run.size
            window = min(2 * window, 1 << 20)
            continue
        j = int(out_of[0])
        out[p:p + j] = run[:j]
        out[p + j] = acc = mid
        p += j + 1
        window = max(4096, 4 * (j + 1))
    return out.astype(np.int16)


def gen_signal(mb: int, sigma: float, lo: int, hi: int,
               seed: int) -> np.ndarray:
    """The ``mb`` MiB of int16 that ``native/gen_signal OUT mb sigma lo hi
    seed`` writes, byte for byte, without building or running it: a float32
    walk of ``normal_distribution<float>(0, sigma)`` steps from
    ``(lo + hi) / 2`` that resets there when it leaves [lo, hi]."""
    n = (mb << 20) // 2
    steps = _normals(seed, n) * np.float32(sigma)
    return _reset_walk(steps, lo, hi)


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


def _bench_tier(args, B: int, N: int) -> np.ndarray:
    """The first B*N values of a ``gen_signal`` workload, as [B, N]."""
    mb = max(1, -(-B * N * 2 // (1 << 20)))
    return gen_signal(mb, *args[1:])[:B * N].reshape(B, N)


# Each content tier, [B, N] int16 from (B, N). clean and mixed are
# bench.py's workload files (at [4, 4M] the whole 32 MiB of each); pure is
# bench.py's in-process walk, hard its uniform int16; realistic is a walk
# with read boundaries made here.
TIERS = {
    "realistic": lambda B, N: walk_with_reads(
        np.random.default_rng(42), B * N).reshape(B, N),
    "clean": lambda B, N: _bench_tier(CLEAN_ARGS, B, N),
    "mixed": lambda B, N: _bench_tier(MIXED_ARGS, B, N),
    "pure": lambda B, N: np.clip(500 + np.cumsum(np.random.default_rng(
        11).normal(0, 12, (B, N)), axis=1), -2000, 2000).astype(np.int16),
    "hard": lambda B, N: np.random.default_rng(13).integers(
        -32768, 32767, (B, N), dtype=np.int16),
}


def tiers(B: int, N: int) -> dict:
    """Every tier of ``TIERS`` as [B, N] int16."""
    return {name: make(B, N) for name, make in TIERS.items()}


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


def w2_tile_cases(tile: int) -> list:
    """(name, flavor, rows [B, N], lens [B]) that carry W2's byte offset and
    un-delta sum across tiles of ``tile`` values: unlike rows whose lengths
    sit on tile edges (N = 1,000,004, so every row after the first starts
    off 16-byte alignment), all-code-0 and all-code-1 content (zig-zag values
    >= 256 everywhere; zz8 after the first value, which cannot reach 256),
    and the int16 wrap extremes."""
    rng = np.random.default_rng(41)
    lens = np.array([1, tile - 1, tile, tile + 1, 3 * tile + 5, 1_000_003],
                    np.int32)
    width = -(-int(lens.max()) // 4) * 4
    n = 3 * tile + 8
    full = np.full(3, n, np.int32)
    swing = np.arange(3)[:, None]
    cases = []
    for flavor, dtype, big in (("zz16", np.int16, 300),
                               ("zz8", np.int8, -100)):
        walk = np.cumsum(rng.integers(-300, 301, (lens.size, width)), axis=1)
        cases.append(("tile edges", flavor, walk.astype(dtype), lens))
        small = np.clip(np.cumsum(rng.integers(-60, 61, (3, n)), axis=1),
                        -100, 100)
        cases.append(("all code 0", flavor, small.astype(dtype), full))
        code1 = (np.tile(np.array([big, -big]), (3, n // 2))
                 + np.sign(big) * swing)
        cases.append(("all code 1", flavor, code1.astype(dtype), full))
    wrap = np.tile(np.array([-32768, 32767], np.int16), (3, 2 * tile + 2))
    cases.append(("wrap extremes", "zz16", wrap,
                  np.full(3, wrap.shape[1], np.int32)))
    return cases


def _wrap32(a: np.ndarray) -> np.ndarray:
    """int64 values wrapped to int32 (mod 2^32)."""
    return ((a + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def w4_tile_cases(tile: int) -> list:
    """(name, flavor, rows [B, N], lens [B]) that carry W4 decode's byte
    offset (and zz32's un-delta sum) across tiles of ``tile`` values, for
    every W4 flavor: unlike rows whose lengths sit on tile edges (N =
    1,000,004, so rows after the first start off 16-byte alignment),
    all-code-0 and all-code-3 rows, codes cycling 0-3 (a nonnegative int16
    takes codes 0-1 and a nonnegative int8 code 0, a negative one code 3, so
    none16 cycles 0, 1, 3 and none8 0, 3), the int32 wrap extremes (zz32)
    and the sign-extension extremes of none16 and none8."""
    rng = np.random.default_rng(43)
    lens = np.array([1, tile - 1, tile, tile + 1, 3 * tile + 5, 1_000_003],
                    np.int32)
    width = -(-int(lens.max()) // 4) * 4
    n = 3 * tile + 8
    full = np.full(3, n, np.int32)
    swing = np.arange(3)[:, None]
    big = 1 << 25  # a zz32 delta or none32 value of code 3
    cycles = {"zz32": [5, 300, 70000, big], "none32": [5, 300, 70000, big],
              "none16": [5, 300, -7], "none8": [5, -7]}
    cases = []
    for flavor, dtype in (("zz32", np.int32), ("none32", np.int32),
                          ("none16", np.int16), ("none8", np.int8)):
        info = np.iinfo(dtype)
        if flavor == "zz32":
            edges = _wrap32(np.cumsum(rng.integers(-70000, 70001,
                                                   (lens.size, width)),
                                      axis=1))
            code0 = np.cumsum(rng.integers(-127, 128, (3, n)), axis=1)
            code3 = np.tile(np.array([big, -big]), (3, n // 2)) + swing
            # zig-zag values 5, 300, 70000, 2^25 in turn, as deltas
            z = np.resize(np.array(cycles[flavor], np.int64), (3, n))
            cycle = _wrap32(np.cumsum((z >> 1) ^ -(z & 1), axis=1))
        else:
            edges = uniform(rng, lens.size * width, dtype).reshape(
                lens.size, width)
            code0 = rng.integers(0, min(256, info.max + 1), (3, n))
            code3 = (rng.integers(info.min, 0, (3, n)) if dtype != np.int32
                     else np.where(rng.integers(0, 2, (3, n)) == 1,
                                   rng.integers(big, info.max, (3, n)),
                                   rng.integers(info.min, 0, (3, n))))
            cycle = np.resize(np.array(cycles[flavor]), (3, n))
        cases.append(("tile edges", flavor, edges.astype(dtype), lens))
        cases.append(("all code 0", flavor, code0.astype(dtype), full))
        cases.append(("all code 3", flavor, code3.astype(dtype), full))
        cases.append(("codes cycling", flavor, cycle.astype(dtype), full))
    wrap = np.tile(np.array([-(1 << 31), (1 << 31) - 1], np.int64),
                   (3, n // 2))
    cases.append(("wrap extremes", "zz32", wrap.astype(np.int32), full))
    for flavor, dtype in (("none16", np.int16), ("none8", np.int8)):
        info = np.iinfo(dtype)
        signs = np.array([info.min, -1, info.max, 0, -2], np.int64)
        cases.append(("negative", flavor,
                      np.resize(signs, (3, n)).astype(dtype), full))
    return cases


# none8 values of v1 codes 0-3 (3: negative, sign-extended to 32 bits).
_V1_NONE8 = np.array([0, 5, 100, -7], np.int8)


def v1_rows_of_codes(codes: np.ndarray, flavor: str) -> np.ndarray:
    """int8 rows [B, n] whose v1 codes are ``codes`` [B, n] (0-3). none8
    maps each code to a value; zz8 takes a 32-bit delta per code from the
    sample before (0, 1 or 50 toward 0, or to the far end of the int8
    range), except a code 3 asked for at sample 0, which no int8 delta
    reaches: it takes +127 (code 2)."""
    if flavor == "none8":
        return _V1_NONE8[codes]
    out = np.empty(codes.shape, np.int8)
    for b, row in enumerate(codes.tolist()):
        x, vals = 0, []
        for c in row:
            if c == 1:
                x += -1 if x > 0 else 1
            elif c == 2:
                x += -50 if x > 0 else 50
            elif c == 3:
                x = -128 if x > 0 else 127
            vals.append(x)
        out[b] = vals
    return out


def v1_tile_cases(tile: int) -> list:
    """(name, flavor, rows [B, N], lens [B]) that carry v1's nibble offset,
    V1E's shared half-byte and V1D's un-delta sum across tiles of ``tile``
    values, for zz8 and none8: unlike rows whose lengths sit on tile edges
    (N = 1,000,004), all-code-0 rows (constant for zz8, zeros for none8),
    all-code-3 rows, codes cycling 0-3, odd nibble offsets carried across
    empty tiles (an odd nibble count, then code-0 runs of exactly one tile,
    two tiles and one value short of a tile, each followed by values again,
    and a run to the row's end), the none8 sign extremes and the zz8 delta
    extremes (zig-zag values 509 and 510)."""
    rng = np.random.default_rng(47)
    lens = np.array([1, tile - 1, tile, tile + 1, 3 * tile + 5, 1_000_003],
                    np.int32)
    width = -(-int(lens.max()) // 4) * 4
    n = 3 * tile + 8
    full = np.full(3, n, np.int32)
    # Code runs of the odd-offset rows, (code, values): tile 0 ends on an
    # odd count, tile 1 is empty, tile 2 starts on an odd offset; tiles 3-4
    # are empty and tile 5 starts odd; a run one value short of a tile puts
    # a code-0 value first in tile 6, again at an odd offset.
    runs = [(1, tile - 1), (0, tile + 1), (1, tile - 2), (0, 2 * tile + 2),
            (1, 2), (0, tile - 1), (3, 1), (2, 5), (1, 3), (0, tile - 11),
            (1, 1), (0, 2 * tile + 4)]
    odd = np.concatenate([np.full(k, c) for c, k in runs])
    mixed = rng.integers(0, 4, odd.size)
    cases = []
    for flavor in ("zz8", "none8"):
        pick = rng.integers(0, 3, (lens.size, width))
        edges = np.where(pick == 0, 0, np.where(
            pick == 1, rng.integers(-8, 9, (lens.size, width)),
            uniform(rng, lens.size * width, np.int8).reshape(lens.size,
                                                             width)))
        cases.append(("tile edges", flavor, edges.astype(np.int8), lens))
        code0 = (np.array([[0], [5], [-100]]) * np.ones(n, np.int64)
                 if flavor == "zz8" else np.zeros((3, n)))
        cases.append(("all code 0", flavor, code0.astype(np.int8), full))
        cases.append(("all code 3", flavor,
                      v1_rows_of_codes(np.full((3, n), 3), flavor), full))
        cases.append(("codes cycling", flavor, v1_rows_of_codes(
            np.resize(np.arange(4), (3, n)), flavor), full))
        rows = v1_rows_of_codes(np.stack([odd, odd, np.where(
            np.arange(odd.size) < 5 * tile, odd, mixed)]), flavor)
        cases.append(("odd offsets across empty tiles", flavor, rows,
                      np.array([odd.size, 6 * tile + 1, odd.size - 2],
                               np.int32)))
    signs = np.array([-128, -1, 127, 0, -2, 15, 16, 1], np.int64)
    cases.append(("negative", "none8",
                  np.resize(signs, (3, n)).astype(np.int8), full))
    cases.append(("extremes", "zz8", np.resize(
        np.array([-128, 127], np.int8), (3, n)), full))
    return cases


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


def pseudo_reads(n_reads: int = 256, seed: int = 21) -> list:
    """The corpus driver's pseudo-read corpus, as ``make_corpus`` of the JAX
    package's ``tools/check_corpus_chip.py`` makes it (after the reference
    perf SignalGenerator, reference vbz/perf/test_data_generator.h:28-74):
    int16 reads of 30,000-125,000 samples, a sigma-12 walk from 500 clipped
    to +-2000. At the defaults: 40,528,974 raw bytes in buckets of 32768 (5
    reads), 65536 (79) and 131072 (172)."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n_reads):
        n = int(rng.integers(30_000, 125_000))
        reads.append(np.clip(500 + np.cumsum(rng.normal(0, 12, n)),
                             -2000, 2000).astype(np.int16))
    return reads


def clean_payload() -> bytes:
    """The StreamVByte payload (zz16, v0) of the clean tier's first 8 MiB
    chunk, the first chunk of the bench's pipeline: 5,243,482 bytes, the
    input the zstd stage's match scan gets there."""
    return scalar.svb_compress(TIERS["clean"](1, 4 << 20)[0], 2, True, 0)


def match_cases(tile: int, halo: int) -> list:
    """(name, buf uint8 [n], offsets, None for the default list) for the
    bounded-offset match scan, whose kernel takes positions in tiles of
    ``tile`` and holds ``halo`` bytes behind a tile: the svb payload of the JAX
    match tests (seed 5, 30,000 samples) and the three inputs of their frame
    round trip; random bytes, where almost nothing matches; an all-zero
    buffer, where every position from 1 on matches at offset 1; lengths just
    below and above o + 4 for o = 1 and 1024 (a 1024-byte random period, so
    only offset 1024 matches), on tile edges and below 4; an unsorted offset
    list whose first too-large offset stops the list before later small ones,
    a list that repeats offsets, and offsets past the halo on a 5000-byte
    period."""
    rng = np.random.default_rng(5)
    sig = np.clip(500 + np.cumsum(rng.normal(0, 12, 30000)), -2000,
                  2000).astype(np.int16)
    svb = np.frombuffer(scalar.svb_compress(sig, 2, True, 0), np.uint8)
    rng = np.random.default_rng(8)
    period = rng.integers(0, 256, 1024).astype(np.uint8)
    far = rng.integers(0, 256, 5000).astype(np.uint8)
    cases = [
        ("svb payload", svb, None),
        ("small repeat", np.frombuffer(b"abcabcabcabc", np.uint8),
         None),
        ("text", np.frombuffer(
            b"the quick brown fox jumps over the lazy dog. " * 1000,
            np.uint8), None),
        ("periodic", np.tile(np.arange(64, dtype=np.uint8), 1500),
         None),
        ("random", rng.integers(0, 256, 3 * tile + 5).astype(np.uint8),
         None),
        ("all zero", np.zeros(2 * tile + 7, np.uint8), None),
    ]
    for n in (0, 1, 3, 4, 5, 6, 1027, 1028, 1029, tile - 1, tile + 1,
              2 * tile + 3):
        cases.append((f"period 1024, n={n}",
                      np.resize(period, n).astype(np.uint8), None))
    too_far = 3 * tile + halo
    cases.append(("unsorted offsets", svb[:3 * tile].copy(),
                  (7, 3, halo + 904, 1, too_far, 2, 4)))
    cases.append(("repeated offsets", svb[:2 * tile + 5].copy(),
                  (3, 1, 3, 2, 1, 8, 2)))
    cases.append(("offsets past the halo",
                  np.resize(far, 3 * tile + halo).astype(np.uint8),
                  (2, 5000, 1, halo + 4, 3)))
    return cases
