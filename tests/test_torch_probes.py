"""The capability probe's plain versions (``vbz_compression_tpu_torch.ops
.probes``) against the Pallas probe kernels of ``tools/probe_*.py`` in
interpret mode, on the probes' own inputs, exactly. The probe files are
loaded by path and their ``pallas_call``s built here at small grids; the
port's wrappers on CPU tensors run the plain versions and count nothing."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vbz_compression_tpu_torch.ops import probes
from vbz_compression_tpu_torch.tools import capability_probe

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
LANES = 128
# Two of the probe files set a compilation cache at import; keep the test
# process's settings.
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


def _load(name):
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            f"_probe_{name}", os.path.join(TOOLS, f"probe_{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def dynroll():
    return _load("dynroll")


def _pallas(kernel, args, out_shape, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(kernel, out_shape=out_shape,
                                         **kw)(*args))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# dynroll
# ---------------------------------------------------------------------------


def _x16():
    return np.arange(16 * LANES, dtype=np.int32).reshape(16, LANES)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("a", [0, 5, 15, 127])
def test_rolls_match_pallas(dynroll, axis, a):
    x = _x16()
    kernel = dynroll._kernel_dynsub if axis == 0 else dynroll._kernel_dynlane
    want = _pallas(kernel, (jnp.asarray(x), jnp.asarray(np.array([a],
                                                                 np.int32))),
                   jax.ShapeDtypeStruct(x.shape, jnp.int32))
    np.testing.assert_array_equal(want, np.roll(x, a, axis=axis))
    wrapper = probes.roll_rows if axis == 0 else probes.roll_lanes
    np.testing.assert_array_equal(wrapper(_t(x), a).numpy(), want)


@pytest.mark.parametrize("a", [0, 1, 127, 128, 129, 1023])
def test_flat_shift_matches_pallas(dynroll, a):
    x = _x16()
    want = _pallas(dynroll._kernel_flatdyn,
                   (jnp.asarray(x), jnp.asarray(np.array([a], np.int32))),
                   jax.ShapeDtypeStruct(x.shape, jnp.int32))
    np.testing.assert_array_equal(
        probes.flat_shift_right(_t(x), a).numpy(), want)


def test_prefix_sum_matches_pallas(dynroll):
    xr = np.random.default_rng(0).integers(0, 2, (256, LANES), dtype=np.int32)
    want = _pallas(dynroll._kernel_mxu_psum, (jnp.asarray(xr),),
                   jax.ShapeDtypeStruct(xr.shape, jnp.int32))
    np.testing.assert_array_equal(want, np.cumsum(xr).reshape(xr.shape))
    np.testing.assert_array_equal(probes.prefix_sum(_t(xr)).numpy(), want)


def test_prefix_sum_wraps_at_32_bits():
    x = np.random.default_rng(1).integers(-2 ** 31, 2 ** 31, (40, LANES),
                                          dtype=np.int64)
    want = (np.cumsum(x) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    got = probes.prefix_sum(_t(x.astype(np.int32))).numpy().reshape(-1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 5])
def test_prefix_sum_plain_at_tile_edges(n):
    """Lengths around the kernel's 4096-value tiles, full int32 range:
    numpy's cumsum mod 2^32."""
    x = np.random.default_rng(n).integers(-2 ** 31, 2 ** 31, (1, n),
                                          dtype=np.int64)
    want = (np.cumsum(x) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    got = probes.prefix_sum_plain(_t(x.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got.reshape(-1), want)


# ---------------------------------------------------------------------------
# i8dma
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("off", [4096, 8192])
def test_byte_store_and_load_match_pallas(off):
    mod = _load("i8dma")
    R = 64
    rng = np.random.default_rng(0)
    x = rng.integers(-120, 120, (R, LANES), dtype=np.int32)
    window = slice(off, off + R * LANES)
    wrote = _pallas(
        mod._wr_kernel, (jnp.asarray(x), jnp.asarray(np.array([off],
                                                              np.int32))),
        jax.ShapeDtypeStruct((65536,), jnp.int8),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        scratch_shapes=[pltpu.VMEM((R * LANES,), jnp.int8),
                        pltpu.SemaphoreType.DMA],
        compiler_params=pltpu.CompilerParams(has_side_effects=True))
    buf = probes.store_bytes(_t(x), torch.zeros(65536, dtype=torch.int8),
                             off).numpy()
    # The Pallas output outside the window is unspecified; the port leaves
    # the buffer there as it was.
    np.testing.assert_array_equal(buf[window], wrote[window])
    assert not buf[:off].any() and not buf[window.stop:].any()

    data = rng.integers(-128, 128, 65536, dtype=np.int8)
    read = _pallas(
        mod._rd_kernel, (jnp.asarray(np.array([off], np.int32)),
                         jnp.asarray(data)),
        jax.ShapeDtypeStruct((R, LANES), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((R * LANES,), jnp.int8),
                        pltpu.SemaphoreType.DMA],
        compiler_params=pltpu.CompilerParams(has_side_effects=True))
    np.testing.assert_array_equal(
        probes.load_bytes(_t(data), off, (R, LANES)).numpy(), read)


@pytest.mark.parametrize("off", [0, 1, 4097, 8195, 65536 - 64 * LANES])
def test_bytes_at_unaligned_offsets(off):
    """The card needs no 4096-byte alignment (pallas_codec5.AG is
    Mosaic's): any byte offset works."""
    rng = np.random.default_rng(off)
    x = rng.integers(-2 ** 31, 2 ** 31, (64, LANES), dtype=np.int64).astype(
        np.int32)
    base = rng.integers(-128, 128, 65536, dtype=np.int8)
    buf = probes.store_bytes(_t(x), _t(base.copy()), off).numpy()
    want = base.copy()
    want[off:off + x.size] = x.reshape(-1).astype(np.int8)
    np.testing.assert_array_equal(buf, want)
    np.testing.assert_array_equal(
        probes.load_bytes(_t(buf), off, (64, LANES)).numpy(),
        x.astype(np.int8).astype(np.int32))


# ---------------------------------------------------------------------------
# keypack
# ---------------------------------------------------------------------------


def test_key_pack_and_unpack_match_pallas():
    mod = _load("keypack")
    RV = 256
    rng = np.random.default_rng(0)
    c = rng.integers(0, 2, (RV, LANES), dtype=np.int32)
    packed = _pallas(mod._pack_kernel, (jnp.asarray(c),),
                     jax.ShapeDtypeStruct((RV // 4, LANES), jnp.uint8))
    np.testing.assert_array_equal(probes.pack_keys(_t(c)).numpy(), packed)
    keys = rng.integers(0, 256, (RV // 4, LANES), dtype=np.uint8)
    unpacked = _pallas(mod._unpack_kernel, (jnp.asarray(keys),),
                       jax.ShapeDtypeStruct((RV, LANES), jnp.int32))
    np.testing.assert_array_equal(probes.unpack_keys(_t(keys)).numpy(),
                                  unpacked)


def test_keys_round_trip_all_codes():
    codes = np.random.default_rng(2).integers(0, 4, (64, LANES),
                                              dtype=np.int32)
    keys = probes.pack_keys(_t(codes))
    np.testing.assert_array_equal(probes.unpack_keys(keys).numpy(), codes)


# ---------------------------------------------------------------------------
# widen
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def widen():
    return _load("widen")


@pytest.mark.parametrize("kind", ["k_i32", "k_i8", "k_i8_2d"])
def test_widening_fetches_match_pallas(widen, kind):
    nb = 3   # grid steps (the probe runs 128)
    n = nb * widen.BLOCK
    rng = np.random.default_rng(0)
    if kind == "k_i32":
        data = rng.integers(0, 256, n + widen.FW, dtype=np.int32)
        stage = pltpu.VMEM((widen.FW,), jnp.int32)
    elif kind == "k_i8":
        data = rng.integers(-128, 128, n + widen.FW, dtype=np.int8)
        stage = pltpu.VMEM((widen.FW,), jnp.int8)
    else:
        data = rng.integers(-128, 128, n + widen.FW, dtype=np.int8)
        stage = pltpu.VMEM((widen.FW // LANES, LANES), jnp.int8)
    args = jnp.asarray(data if kind != "k_i8_2d"
                       else data.reshape(-1, LANES))
    want = _pallas(
        getattr(widen, kind), (args,),
        jax.ShapeDtypeStruct((n // LANES, LANES), jnp.int32), grid=(nb,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((widen.BLOCK // LANES, LANES),
                               lambda i: (i, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[stage, pltpu.SemaphoreType.DMA],
        compiler_params=pltpu.CompilerParams(has_side_effects=True))
    fetch = probes.fetch_i32 if kind == "k_i32" else probes.fetch_i8_widen
    np.testing.assert_array_equal(fetch(_t(data), n).numpy(), want)


# ---------------------------------------------------------------------------
# i16roll
# ---------------------------------------------------------------------------


# (stages, rows of 128): the probe's ten stages on its [528, 128], the
# range's ends and a middle, and flat lengths below 2^stages (the Pallas
# kernel's row shift needs at least 2^(stages-1) / 128 rows).
BUTTERFLY_CASES = [(10, None), (1, None), (4, None), (15, None), (10, 5),
                   (15, 200)]


@pytest.mark.parametrize("stages,rows", BUTTERFLY_CASES)
def test_butterfly_matches_pallas_at_both_widths(stages, rows):
    mod = _load("i16roll")
    R = rows or mod.R
    # Tokens: occupancy bit 0, displacement bits 1..; the probe's draw at
    # ten stages, displacements reaching bit `stages` (within int16) else.
    top = 600 if stages == 10 and rows is None else min(1 << stages,
                                                        1 << 14)
    E = np.sort(np.random.default_rng(stages).integers(
        0, top, R * LANES)).reshape(R, LANES)
    got = {}
    for name, dt, jdt in (("int32", np.int32, jnp.int32),
                          ("int16", np.int16, jnp.int16)):
        x = ((E << 1) | 1).astype(name)
        want = _pallas(
            mod.kernel_factory(jdt, stages),
            (jnp.asarray(x),), jax.ShapeDtypeStruct((R, LANES), jdt),
            grid=(2,),
            in_specs=[pl.BlockSpec((R, LANES), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((R, LANES), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM))
        got[name] = probes.butterfly(_t(x), stages).numpy()
        np.testing.assert_array_equal(got[name], want)
        assert got[name].dtype == dt
    np.testing.assert_array_equal(got["int16"].astype(np.int32),
                                  got["int32"])


# ---------------------------------------------------------------------------
# The wrappers on the CPU, and the probe's cases
# ---------------------------------------------------------------------------


def test_cpu_wrappers_count_nothing():
    before = dict(probes.LAUNCHES)
    for case in capability_probe.cases("cpu"):
        assert capability_probe.max_abs_err(case.kernel(), case.plain()) == 0
    assert probes.LAUNCHES == before
    assert set(before) == {c.key for c in capability_probe.cases("cpu")}


@pytest.mark.parametrize("call", [
    lambda: probes.roll_rows(torch.zeros(4, 8, dtype=torch.int64), 1),
    lambda: probes.flat_shift_right(torch.zeros(4, 8, dtype=torch.int32), -1),
    lambda: probes.store_bytes(torch.zeros(2, 8, dtype=torch.int32),
                               torch.zeros(20, dtype=torch.int8), 5),
    lambda: probes.load_bytes(torch.zeros(20, dtype=torch.int8), 8, (2, 8)),
    lambda: probes.pack_keys(torch.zeros(6, 8, dtype=torch.int32)),
    lambda: probes.unpack_keys(torch.zeros(6, 8, dtype=torch.int32)),
    lambda: probes.fetch_i32(torch.zeros(256, dtype=torch.int32), 100),
    lambda: probes.fetch_i8_widen(torch.zeros(128, dtype=torch.int8), 256),
    lambda: probes.butterfly(torch.zeros(4, 8, dtype=torch.int8)),
    lambda: probes.butterfly(torch.zeros(4, 8, dtype=torch.int16), 16),
])
def test_wrappers_reject_bad_arguments(call):
    with pytest.raises(ValueError):
        call()


def test_probe_run_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        capability_probe.run("cpu")
