"""The capability probe's kernels: what the TPU probes in ``tools/probe_*.py``
asked of Mosaic, asked of the card.

Each TPU probe lowered one operation the codec wanted (a roll by a runtime
amount, a byte-granular DMA, a key pack, a widening fetch, a 16-bit
butterfly) and checked it against NumPy. Here each is a small CUDA kernel in
``csrc/probe.cu`` with a plain PyTorch version beside it:

=================  ==========================================  ===========
wrapper            replaces                                    LAUNCHES key
=================  ==========================================  ===========
roll_rows          probe_dynroll.py ``_kernel_dynsub`` :27      roll_rows
roll_lanes         probe_dynroll.py ``_kernel_dynlane`` :22     roll_lanes
flat_shift_right   probe_dynroll.py ``_kernel_flatdyn`` :50     flat_shift_right
prefix_sum         probe_dynroll.py ``_kernel_mxu_psum`` :54    prefix_sum
store_bytes        probe_i8dma.py ``_wr_kernel`` :17            store_bytes
load_bytes         probe_i8dma.py ``_rd_kernel`` :28            load_bytes
pack_keys          probe_keypack.py ``_pack_kernel`` :15        pack_keys
unpack_keys        probe_keypack.py ``_unpack_kernel`` :29      unpack_keys
fetch_i32          probe_widen.py ``k_i32`` :32                 fetch_i32
fetch_i8_widen     probe_widen.py ``k_i8`` :40, ``k_i8_2d`` :49  fetch_i8_widen
butterfly          probe_i16roll.py ``kernel_factory`` :51      butterfly_i16,
                                                               butterfly_i32
=================  ==========================================  ===========

On a CUDA tensor each wrapper launches its kernel and adds one to its
``LAUNCHES`` entry; on a CPU tensor it runs the plain version; any other
device raises. All are exact integer functions.
"""

from __future__ import annotations

import torch

from . import _rows

LANES = 128
BUTTERFLY_STAGES = 10
LAUNCHES = dict.fromkeys(
    ("roll_rows", "roll_lanes", "flat_shift_right", "prefix_sum",
     "store_bytes", "load_bytes", "pack_keys", "unpack_keys", "fetch_i32",
     "fetch_i8_widen", "butterfly_i16", "butterfly_i32"), 0)
_KEY_SHIFTS = (0, 2, 4, 6)


def _check(t: torch.Tensor, dtype: torch.dtype, dims: int, name: str) -> None:
    if t.dtype != dtype or t.dim() != dims:
        raise ValueError(f"{name}: want {dims}-D {dtype}, got {t.dim()}-D "
                         f"{t.dtype}")


def _launch(entry: str, key: str, *args) -> None:
    from . import _build

    for a in args:
        if isinstance(a, torch.Tensor) and not a.is_contiguous():
            raise ValueError(f"{key}: kernel arguments must be contiguous")
    _rows.launch(getattr(_build.lib("probe"), entry), key, *args)
    LAUNCHES[key] += 1


def _check_aligned(key: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{key}: the kernel reads 16-byte vectors; "
                             "pass a 16-byte aligned tensor")


# ---------------------------------------------------------------------------
# dynroll: rolls by a runtime amount, a flat shift, a prefix sum
# ---------------------------------------------------------------------------


def roll_plain(x: torch.Tensor, a_rows: int, a_lanes: int) -> torch.Tensor:
    """x rolled by ``a_rows`` along axis 0 and ``a_lanes`` along axis 1
    (``np.roll`` semantics), by index arithmetic."""
    R, L = x.shape
    r = (torch.arange(R, device=x.device) - a_rows) % R
    l = (torch.arange(L, device=x.device) - a_lanes) % L
    return x[r[:, None], l[None, :]]


def _roll(x: torch.Tensor, a_rows: int, a_lanes: int, key: str):
    _check(x, torch.int32, 2, key)
    R, L = x.shape
    a_rows, a_lanes = a_rows % max(R, 1), a_lanes % max(L, 1)
    if _rows.on_cpu(x, key):
        return roll_plain(x, a_rows, a_lanes)
    out = torch.empty_like(x)
    if x.numel():
        _launch("vbz_probe_roll", key, x, out, R, L, a_rows, a_lanes)
    return out


def roll_rows(x: torch.Tensor, a: int) -> torch.Tensor:
    """``np.roll(x, a, axis=0)`` of a 2-D int32 tensor, a known at run
    time."""
    return _roll(x, a, 0, "roll_rows")


def roll_lanes(x: torch.Tensor, a: int) -> torch.Tensor:
    """``np.roll(x, a, axis=1)`` of a 2-D int32 tensor."""
    return _roll(x, 0, a, "roll_lanes")


def flat_shift_right_plain(x: torch.Tensor, a: int) -> torch.Tensor:
    flat = x.reshape(-1)
    src = torch.arange(flat.numel(), device=x.device) - a
    out = torch.where(src >= 0, flat[src.clamp(min=0)], 0)
    return out.view(x.shape)


def flat_shift_right(x: torch.Tensor, a: int) -> torch.Tensor:
    """Shift a 2-D int32 tensor right by ``a >= 0`` slots in row-major
    order, filling with zeros."""
    _check(x, torch.int32, 2, "flat_shift_right")
    if a < 0:
        raise ValueError(f"shift {a} < 0")
    if _rows.on_cpu(x, "flat_shift_right"):
        return flat_shift_right_plain(x, a)
    out = torch.empty_like(x)
    if x.numel():
        _launch("vbz_probe_flat_shift_right", "flat_shift_right", x, out,
                x.numel(), a)
    return out


def prefix_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the flat tensor, wrapping at 32 bits, by
    doubling: log2(n) steps of out[i] += out[i - d]."""
    out = x.reshape(-1).clone()
    d = 1
    while d < out.numel():
        out[d:] = out[d:] + out[:-d]
        d *= 2
    return out.view(x.shape)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum (mod 2^32) of a 2-D int32 tensor in row-major
    order; on the card one launch over tiles of 4096 values. Up to 32768
    values the tiles run as one thread block cluster and need no state;
    above, they carry from tile to tile by a decoupled look-back whose state
    takes one fill."""
    _check(x, torch.int32, 2, "prefix_sum")
    if _rows.on_cpu(x, "prefix_sum"):
        return prefix_sum_plain(x)
    out = torch.empty_like(x)
    if x.numel():
        from . import _build

        lib = _build.lib("probe")
        scratch = (_rows.lookback_scratch(lib.vbz_probe_prefix_sum_tile(), 1,
                                          x.numel(), 1, x.device)
                   if x.numel() > lib.vbz_probe_prefix_sum_cluster_values()
                   else None)
        _launch("vbz_probe_prefix_sum", "prefix_sum", x, out, x.numel(),
                scratch)
    return out


# ---------------------------------------------------------------------------
# i8dma: int32 -> int8 bytes at any offset, and back
# ---------------------------------------------------------------------------


def _check_window(buf: torch.Tensor, off: int, n: int, ref: torch.Tensor):
    _check(buf, torch.int8, 1, "buf")
    if off < 0 or off + n > buf.numel():
        raise ValueError(f"window [{off}, {off + n}) outside a buffer of "
                         f"{buf.numel()} bytes")
    if buf.device != ref.device:
        raise ValueError(f"buffer on {buf.device}, values on {ref.device}")


def store_bytes_plain(x: torch.Tensor, buf: torch.Tensor,
                      off: int) -> torch.Tensor:
    buf[off:off + x.numel()] = (x.reshape(-1) & 0xFF).to(torch.uint8).view(
        torch.int8)
    return buf


def store_bytes(x: torch.Tensor, buf: torch.Tensor, off: int) -> torch.Tensor:
    """Write the low byte of each int32 of ``x`` (row-major) into the int8
    ``buf`` at byte offset ``off``, any offset, in place; returns ``buf``.
    The rest of ``buf`` is left as it was."""
    _check(x, torch.int32, 2, "store_bytes")
    _check_window(buf, off, x.numel(), x)
    if _rows.on_cpu(x, "store_bytes"):
        return store_bytes_plain(x, buf, off)
    if x.numel():
        _launch("vbz_probe_store_bytes", "store_bytes", x, buf, off,
                x.numel())
    return buf


def load_bytes_plain(buf: torch.Tensor, off: int, shape) -> torch.Tensor:
    n = shape[0] * shape[1]
    return buf[off:off + n].to(torch.int32).view(shape)


def load_bytes(buf: torch.Tensor, off: int, shape) -> torch.Tensor:
    """The ``shape[0] * shape[1]`` bytes of ``buf`` from ``off`` on, as
    int32 sign-extended, shaped ``shape``."""
    shape = (int(shape[0]), int(shape[1]))
    _check_window(buf, off, shape[0] * shape[1], buf)
    if _rows.on_cpu(buf, "load_bytes"):
        return load_bytes_plain(buf, off, shape)
    out = torch.empty(shape, dtype=torch.int32, device=buf.device)
    if out.numel():
        _launch("vbz_probe_load_bytes", "load_bytes", buf, out, off,
                out.numel())
    return out


# ---------------------------------------------------------------------------
# keypack: four flat 2-bit codes per byte
# ---------------------------------------------------------------------------


def pack_keys_plain(codes: torch.Tensor) -> torch.Tensor:
    shifts = torch.tensor(_KEY_SHIFTS, dtype=torch.int32, device=codes.device)
    keys = ((codes.reshape(-1, 4) & 3) << shifts).sum(dim=1)
    return keys.to(torch.uint8).view(codes.shape[0] // 4, codes.shape[1])


def pack_keys(codes: torch.Tensor) -> torch.Tensor:
    """[RV, L] int32 codes (low two bits used) -> [RV/4, L] uint8 keys: key
    byte j holds flat codes 4j..4j+3, code 4j+m at bits 2m. RV % 4 == 0."""
    _check(codes, torch.int32, 2, "pack_keys")
    if codes.shape[0] % 4:
        raise ValueError(f"{codes.shape[0]} rows are not a multiple of 4")
    if _rows.on_cpu(codes, "pack_keys"):
        return pack_keys_plain(codes)
    keys = torch.empty(codes.shape[0] // 4, codes.shape[1],
                       dtype=torch.uint8, device=codes.device)
    if keys.numel():
        _check_aligned("pack_keys", codes)
        _launch("vbz_probe_pack_keys", "pack_keys", codes, keys, keys.numel())
    return keys


def unpack_keys_plain(keys: torch.Tensor) -> torch.Tensor:
    shifts = torch.tensor(_KEY_SHIFTS, dtype=torch.int32, device=keys.device)
    codes = (keys.reshape(-1, 1).to(torch.int32) >> shifts) & 3
    return codes.view(keys.shape[0] * 4, keys.shape[1])


def unpack_keys(keys: torch.Tensor) -> torch.Tensor:
    """[K, L] uint8 keys -> [4K, L] int32 codes, the inverse of
    :func:`pack_keys`."""
    _check(keys, torch.uint8, 2, "unpack_keys")
    if _rows.on_cpu(keys, "unpack_keys"):
        return unpack_keys_plain(keys)
    codes = torch.empty(keys.shape[0] * 4, keys.shape[1], dtype=torch.int32,
                        device=keys.device)
    if keys.numel():
        _launch("vbz_probe_unpack_keys", "unpack_keys", keys, codes,
                keys.numel())
    return codes


# ---------------------------------------------------------------------------
# widen: fetch int32, or int8 widened with & 0xFF
# ---------------------------------------------------------------------------


def _fetch_args(data: torch.Tensor, dtype: torch.dtype, n: int,
                key: str) -> None:
    _check(data, dtype, 1, key)
    if n % LANES or not 0 <= n <= data.numel():
        raise ValueError(f"{key}: {n} values are not a multiple of {LANES} "
                         f"within {data.numel()}")


def fetch_i32_plain(data: torch.Tensor, n: int) -> torch.Tensor:
    return data[:n].clone().view(n // LANES, LANES)


def fetch_i32(data: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` int32 of ``data`` as [n/128, 128]."""
    _fetch_args(data, torch.int32, n, "fetch_i32")
    if _rows.on_cpu(data, "fetch_i32"):
        return fetch_i32_plain(data, n)
    out = torch.empty(n // LANES, LANES, dtype=torch.int32, device=data.device)
    if n:
        _check_aligned("fetch_i32", data)
        _launch("vbz_probe_fetch_i32", "fetch_i32", data, out, n)
    return out


def fetch_i8_widen_plain(data: torch.Tensor, n: int) -> torch.Tensor:
    return (data[:n].to(torch.int32) & 0xFF).view(n // LANES, LANES)


def fetch_i8_widen(data: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` int8 of ``data`` widened to int32 with ``& 0xFF``
    (zero-extended), as [n/128, 128]."""
    _fetch_args(data, torch.int8, n, "fetch_i8_widen")
    if _rows.on_cpu(data, "fetch_i8_widen"):
        return fetch_i8_widen_plain(data, n)
    out = torch.empty(n // LANES, LANES, dtype=torch.int32, device=data.device)
    if n:
        _check_aligned("fetch_i8_widen", data)
        _launch("vbz_probe_fetch_i8", "fetch_i8_widen", data, out, n)
    return out


# ---------------------------------------------------------------------------
# i16roll: a butterfly of static flat shifts and selects
# ---------------------------------------------------------------------------


def butterfly_plain(x: torch.Tensor,
                    stages: int = BUTTERFLY_STAGES) -> torch.Tensor:
    """For j = stages-1 .. 0: rolled = the flat array shifted right by 2^j
    (zero fill); keep rolled where its bit 1+j is set, else the value where
    its own bit 1+j is clear, else 0. In ``x``'s dtype throughout."""
    chan = x.reshape(-1)
    for j in range(stages - 1, -1, -1):
        s = 1 << j
        rolled = torch.cat([torch.zeros(min(s, chan.numel()), dtype=x.dtype,
                                        device=x.device), chan[:-s]])
        bit_rolled = (rolled >> (1 + j)) & 1
        bit_stay = (chan >> (1 + j)) & 1
        chan = torch.where(bit_rolled == 1, rolled,
                           torch.where(bit_stay == 0, chan,
                                       torch.zeros_like(chan)))
    return chan.view(x.shape)


def butterfly(x: torch.Tensor, stages: int = BUTTERFLY_STAGES) -> torch.Tensor:
    """The ``probe_i16roll.py`` butterfly on a 2-D int16 or int32 tensor,
    ``stages`` in [1, 15]; one kernel launch for every stage on the card."""
    if x.dtype not in (torch.int16, torch.int32) or x.dim() != 2:
        raise ValueError(f"butterfly: want 2-D int16 or int32, got "
                         f"{x.dim()}-D {x.dtype}")
    if not 1 <= stages <= 15:
        raise ValueError(f"stages {stages} outside [1, 15]")
    key = f"butterfly_i{8 * x.element_size()}"
    if _rows.on_cpu(x, key):
        return butterfly_plain(x, stages)
    out = torch.empty_like(x)
    if x.numel():
        _launch("vbz_probe_butterfly", key, x, out, x.numel(), stages,
                x.element_size())
    return out
