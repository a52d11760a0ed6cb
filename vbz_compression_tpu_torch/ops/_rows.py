"""Helpers shared by the StreamVByte row wrappers (``svb_w2``, ``svb_w4``,
``svb_v1``) and the probe kernels: argument checks, length masks, key
packing for the plain versions, the look-back state of the one-pass kernels,
and the kernel launch."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_KEY_SHIFTS = (0, 2, 4, 6)
MAX_B = 65535  # the kernels' grid y dimension


def check_2d(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype or t.dim() != 2:
        raise ValueError(f"{name}: want 2-D {dtype}, got "
                         f"{t.dim()}-D {t.dtype}")


def check_lens(lens: torch.Tensor, B: int, ref: torch.Tensor,
               name: str) -> None:
    if lens.dtype != torch.int32 or tuple(lens.shape) != (B,):
        raise ValueError(f"{name}: want int32 [{B}], got {lens.dtype} "
                         f"{tuple(lens.shape)}")
    if lens.device != ref.device:
        raise ValueError(f"{name} is on {lens.device}, data on {ref.device}")


def check_encode_args(x: torch.Tensor, dtype: torch.dtype,
                      lens: torch.Tensor) -> tuple[int, int]:
    check_2d(x, dtype, "x")
    B, N = x.shape
    if N % 4:
        raise ValueError(f"row width {N} is not a multiple of 4")
    check_lens(lens, B, x, "lens")
    return B, N


def check_decode_args(keys: torch.Tensor, data: torch.Tensor,
                      counts: torch.Tensor) -> int:
    check_2d(keys, torch.uint8, "keys")
    check_2d(data, torch.uint8, "data")
    B = keys.shape[0]
    if data.shape[0] != B or data.device != keys.device:
        raise ValueError(f"data {tuple(data.shape)} on {data.device} does "
                         f"not match keys {tuple(keys.shape)} on "
                         f"{keys.device}")
    check_lens(counts, B, keys, "counts")
    return B


def on_cpu(t: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (run the plain version), False for a CUDA one
    (launch the kernel); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no {what} for device {t.device}")
    return False


def check_kernel_args(B: int, N: int, max_n: int,
                      *tensors: torch.Tensor) -> None:
    if N > max_n or B > MAX_B:
        raise ValueError(f"batch [{B}, {N}] exceeds the kernel's "
                         f"[{MAX_B}, {max_n}]")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous")


def valid_mask(lens: torch.Tensor, N: int) -> torch.Tensor:
    """[B, N] mask of the values before each row's (clamped) length."""
    n = lens.to(torch.int64).clamp(0, N)
    return torch.arange(N, device=lens.device)[None, :] < n[:, None]


def pack_keys(code: torch.Tensor) -> torch.Tensor:
    """[B, N] 2-bit codes -> [B, N/4] key bytes, LSB first."""
    B, N = code.shape
    shifts = torch.tensor(_KEY_SHIFTS, dtype=torch.int32, device=code.device)
    return (code.to(torch.int32).view(B, N // 4, 4) << shifts).sum(
        dim=2).to(torch.uint8)


def unpack_keys(keys: torch.Tensor) -> torch.Tensor:
    """[B, N/4] key bytes -> [B, N] int32 codes."""
    B, NK = keys.shape
    shifts = torch.tensor(_KEY_SHIFTS, dtype=torch.int32, device=keys.device)
    return ((keys.to(torch.int32)[:, :, None] >> shifts) & 3).view(B, 4 * NK)


def row_ends(sizes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exclusive offsets of per-value sizes along each row, and the rows'
    totals (int64)."""
    ends = torch.cumsum(sizes.to(torch.int64), dim=1)
    total = ends[:, -1] if sizes.shape[1] else torch.zeros(
        sizes.shape[0], dtype=torch.int64, device=sizes.device)
    return ends - sizes, total


def stream_sections(streams: torch.Tensor, lengths: torch.Tensor,
                    out_n: int):
    """The key and data sections of v0 stream rows [B, M], each row's
    ``(lengths + 3) // 4`` key bytes and then its data bytes, as the row
    decoders take them: ``(keys [B, out_n/4], data [B, M], key lengths
    int64)``, keys the rows' first bytes and data their bytes from the key
    length on, both 0 past M."""
    M = streams.shape[1]
    keys = F.pad(streams[:, :out_n // 4], (0, max(out_n // 4 - M, 0)))
    kl = ((lengths + 3) // 4).to(torch.int64)
    p = torch.arange(M, device=streams.device)
    data = torch.gather(F.pad(streams, (0, 1)), 1,
                        (p + kl[:, None]).clamp(max=M))
    return keys.contiguous(), data, kl


def stream_ok(keys: torch.Tensor, lengths: torch.Tensor, kl: torch.Tensor,
              stream_lens: torch.Tensor) -> torch.Tensor:
    """[B] bool: each v0 stream is well formed as ``jax_svb`` decides it:
    the data end that its keys give (the key length plus code + 1 over the
    row's first ``lengths`` values) is its stream length, and the key
    section fits in it."""
    sizes = (unpack_keys(keys) + 1) * valid_mask(lengths, 4 * keys.shape[1])
    data_end = kl + sizes.sum(dim=1)
    return (data_end == stream_lens) & (kl <= stream_lens)


def lookback_scratch(tile: int, B: int, N: int, carries: int,
                     device: torch.device, row_words: int = 0
                     ) -> torch.Tensor:
    """The zeroed look-back state of a one-pass kernel (``csrc/lookback.cuh``)
    on [B, N] in tiles of ``tile`` values: the ticket word, then one 8-byte
    status word per tile for each carried value (a byte offset, an un-delta
    sum), then ``row_words`` words a row. The one fill that comes with a
    launch."""
    tiles = B * -(-N // tile)
    return torch.zeros(1 + carries * tiles + row_words * B,
                       dtype=torch.int64, device=device)


def launch(fn, what: str, *args) -> None:
    """Call a kernel library entry point on the current stream of the first
    tensor argument's device, entering that device's guard only where it is
    not the current device; raise on a nonzero CUDA error."""
    index = next(a.get_device() for a in args if isinstance(a, torch.Tensor))
    stream = torch._C._cuda_getCurrentRawStream(index)
    raw = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if index == torch._C._cuda_getDevice():
        rc = fn(*raw, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*raw, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
