"""Data-parallel codec over ``torch.distributed``, one process per card.

The counterpart of ``vbz_compression_tpu.parallel.sharded``. There a 1-D
device mesh split a batch of equal-padded chunks over its ``data`` axis and
``shard_map`` ran the codec on each device's rows. Here each process holds
its rank's contiguous rows (:func:`shard_batch`) on its own card and runs
the port's codec kernels on them:

- stream lengths are all-gathered in rank order, so every rank can lay out
  the ordered corpus;
- the total of compressed bytes is an ``all_reduce`` SUM.

``group`` names the process group of the collectives. ``group=None`` means
this process alone: the collectives are identities and the batch is the
whole batch. Pass ``torch.distributed.group.WORLD`` for the default group.
Every rank must hold the same number of rows: :func:`shard_batch` gives
them so and refuses a batch that does not divide over the group, as the JAX
plane asserts. The plane itself does not check the shares on each call.

NCCL takes CUDA tensors and gloo CPU tensors, so the small tensors of the
collectives (lengths, ``ok``, totals) move to the backend's device; the
kernels stay on the rank's card. The per-rank codec is the backend's routing
(:func:`..models.codec._route`): kernel E for zz16 and zz8, E4 for none16,
none8, zz32 and none32; D and D4 back. The wire-format plane's decode of
zz16 and zz8 takes D's instance that reads each v0 stream row in place and
writes its ``ok`` (``svb_w2.decode_w2_streams``); the W4 kinds cut each row
into key and data sections for D4 first.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import api
from ..models import codec
from ..ops import _rows, svb_w2
from ..utils import profiling


def rank_world(group=None) -> tuple[int, int]:
    """``(rank, world_size)`` of this process in ``group``; ``(0, 1)``
    without a group."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def rank_device(group=None, device=None) -> torch.device:
    """The device of this process's rows: ``device`` when the caller names
    one, else the api's default (the CPU under ``VBZ_BACKEND=torch``; the
    card under ``VBZ_BACKEND=native``, a host codec, as
    :func:`..api.scan_device` gives it), where a card is
    ``cuda:<rank % device_count>``. Raises without a card and without
    either request, as :func:`..api.default_backend` does."""
    if device is not None:
        return torch.device(device)
    dev = api.scan_device()
    if dev.type == "cuda":
        dev = torch.device("cuda",
                           rank_world(group)[0] % torch.cuda.device_count())
    return dev


def _on_comm_device(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's backend takes it: on the rank's card for
    NCCL (``cuda:<rank % device_count>``, whatever the current device), on
    the CPU for gloo."""
    if dist.get_backend(group) == dist.Backend.NCCL:
        rank = dist.get_rank(group)
        return t.to(torch.device("cuda", rank % torch.cuda.device_count()))
    return t.cpu()


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's 1-D ``t`` of ``group``, concatenated in rank order, on
    ``t``'s device (a bool ``t`` travels as uint8); ``t`` itself without a
    group."""
    if group is None:
        return t
    if t.dtype == torch.bool:
        return all_gather(t.to(torch.uint8), group).bool()
    c = _on_comm_device(t, group)
    parts = [torch.empty_like(c) for _ in range(rank_world(group)[1])]
    dist.all_gather(parts, c, group=group)
    return torch.cat(parts).to(t.device)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, on ``t``'s device;
    ``t`` itself without a group."""
    if group is None:
        return t
    c = _on_comm_device(t, group).clone()
    dist.all_reduce(c, op=dist.ReduceOp.SUM, group=group)
    return c.to(t.device)


def _codec(integer_size: int, use_zigzag: bool):
    """(encode, decode, data bytes per value at most, flavor) of a v0
    option set."""
    kind, flavor = codec._route(integer_size, use_zigzag, 0)
    encode, decode, per_value = codec._KINDS[kind]
    return encode, decode, per_value, flavor


# ---------------------------------------------------------------------------
# The wire-format plane: rows of v0 streams
# ---------------------------------------------------------------------------


def batch_encode_sharded(x: torch.Tensor, lengths: torch.Tensor, *,
                         group=None, integer_size: int = 2,
                         use_zigzag: bool = True):
    """Encode this rank's rows ``x`` [b, N] (N a multiple of 4, the signed
    dtype of ``integer_size``), the first ``lengths[b]`` values of each.

    Returns ``(streams [b, M] u8, stream_lens [B] i32, total)``: each row's
    v0 stream as ``jax_svb.encode_batch`` lays it out (the ``(n+3)//4`` key
    bytes, then the data bytes, then zeros to ``M = N/4 + w*N``, ``w`` the
    largest data bytes per value: 2 on zz16 and zz8, else 4), the streams'
    lengths of every rank in rank order, and their sum over the group
    (int64, 0-d).
    """
    encode, _, per_value, flavor = _codec(integer_size, use_zigzag)
    N = x.shape[1]
    keys, data, data_len = encode(x, lengths, flavor)
    key_len = (lengths + 3) // 4
    M = N // 4 + per_value * N
    p = torch.arange(M, device=x.device)
    kl = key_len.to(torch.int64)[:, None]
    moved = torch.gather(data, 1, (p - kl).clamp(0, max(data.shape[1] - 1, 0)))
    streams = torch.where(p < kl, F.pad(keys, (0, M - keys.shape[1])),
                          torch.where(p < kl + data_len[:, None], moved, 0))
    stream_lens = key_len + data_len
    total = stream_lens.sum(dtype=torch.int64)
    return (streams, all_gather(stream_lens, group),
            all_reduce_sum(total, group))


# kind -> the decoder of v0 stream rows in place, ``(streams, lengths,
# stream_lens, out_n, flavor) -> (x, ok)``: kernel D reads each row where it
# lies and writes its ok. Looked up on every call; a kind without one (W4)
# takes the composition of the key slice, the data gather and the row
# decoder.
_STREAM_DECODERS = {"w2": svb_w2.decode_w2_streams}


def batch_decode_sharded(streams: torch.Tensor, lengths: torch.Tensor,
                         stream_lens: torch.Tensor, *, group=None,
                         integer_size: int = 2, use_zigzag: bool = True,
                         out_n: int = 4096):
    """Decode this rank's rows of v0 streams ``streams`` [b, M] (as
    :func:`batch_encode_sharded` gives them), ``lengths[b]`` values each.

    Returns ``(x [b, out_n], ok [B] bool)``: the values (0 past each row's
    length), and for every rank's rows in rank order whether the stream is
    well formed as ``jax_svb`` decides it: the data end that the keys give
    equals ``stream_lens[b]``, and the key section fits in it.

    Host spans (the enqueue, not the card's time): ``plane.decode``, the
    root of a call, around ``plane.launch`` (the decoder's wrapper). A kind
    without an in-place decoder (``_STREAM_DECODERS``) has two more:
    ``plane.layout`` (the padded key slice and the data gather) before it
    and ``plane.ok`` (the key counts behind ``ok``) after it.
    """
    with profiling.call("plane.decode"):
        kind, flavor = codec._route(integer_size, use_zigzag, 0)
        if out_n % 4:
            raise ValueError(f"out_n={out_n} is not a multiple of 4")
        in_place = _STREAM_DECODERS.get(kind)
        if in_place is not None:
            with profiling.span("plane.launch"):
                out, ok = in_place(streams, lengths, stream_lens, out_n,
                                   flavor)
        else:
            with profiling.span("plane.layout"):
                keys, data, kl = _rows.stream_sections(streams, lengths,
                                                       out_n)
            with profiling.span("plane.launch"):
                out = codec._KINDS[kind][1](keys, data, lengths, flavor)
            with profiling.span("plane.ok"):
                ok = _rows.stream_ok(keys, lengths, kl, stream_lens)
        return out, all_gather(ok, group)


# ---------------------------------------------------------------------------
# The rows plane: the kernels' own layouts
# ---------------------------------------------------------------------------


def batch_encode_sharded_rows(x: torch.Tensor,
                              lens: torch.Tensor | None = None, *,
                              group=None, integer_size: int = 2,
                              use_zigzag: bool = True):
    """Encode this rank's rows ``x`` [b, N] in the kernels' layout, the first
    ``lens[b]`` values of each (all N by default).

    Returns ``(keys [b, N/4] u8, data [b, w*N] u8, data_len [B] i32,
    total)``: the key and data sections (``data[r, data_len[r]:]``
    unspecified), the data lengths of every rank in rank order, and the
    group's ``sum(data_len) + B*N/4`` (int64, 0-d). Every content encodes:
    there is no overflow output.
    """
    encode, _, _, flavor = _codec(integer_size, use_zigzag)
    b, N = x.shape
    if lens is None:
        lens = torch.full((b,), N, dtype=torch.int32, device=x.device)
    keys, data, data_len = encode(x, lens, flavor)
    total = data_len.sum(dtype=torch.int64) + b * (N // 4)
    return keys, data, all_gather(data_len, group), all_reduce_sum(total,
                                                                    group)


def batch_decode_sharded_rows(keys: torch.Tensor, data: torch.Tensor,
                              counts: torch.Tensor | None = None, *,
                              group=None, integer_size: int = 2,
                              use_zigzag: bool = True) -> torch.Tensor:
    """Inverse of :func:`batch_encode_sharded_rows` on this rank's rows:
    ``counts[b]`` values of each (all ``4 * keys.shape[1]`` by default);
    returns [b, N] of the flavor's dtype."""
    _, decode, _, flavor = _codec(integer_size, use_zigzag)
    b = keys.shape[0]
    if counts is None:
        counts = torch.full((b,), 4 * keys.shape[1], dtype=torch.int32,
                            device=keys.device)
    return decode(keys, data, counts, flavor)


# ---------------------------------------------------------------------------
# Host-facing helpers
# ---------------------------------------------------------------------------


def shard_batch(arr: np.ndarray, group=None, device=None) -> torch.Tensor:
    """This rank's contiguous slice of the leading axis of a host batch, on
    the rank's device (:func:`rank_device`)."""
    rank, world = rank_world(group)
    if arr.shape[0] % world:
        raise ValueError(f"a batch of {arr.shape[0]} rows does not divide "
                         f"over {world} ranks")
    b = arr.shape[0] // world
    part = np.ascontiguousarray(arr[rank * b:(rank + 1) * b])
    return torch.from_numpy(part).to(rank_device(group, device))


def pad_chunks(chunks: list[np.ndarray], pad_to: int | None = None,
               mode: str = "zero"):
    """Pad a ragged list of 1-D arrays into a [B, N] batch + lengths.

    ``mode='edge'`` repeats each chunk's last value into the padding — on
    the zig-zag paths the pad region then encodes as code-0 bytes, which the
    Pallas batch codec relies on for exact truncation."""
    n = max((c.size for c in chunks), default=0)
    N = pad_to or max(4, -(-n // 4) * 4)
    B = len(chunks)
    out = np.zeros((B, N), dtype=chunks[0].dtype if chunks else np.int16)
    lens = np.zeros(B, dtype=np.int32)
    for i, c in enumerate(chunks):
        out[i, : c.size] = c
        if mode == "edge" and 0 < c.size < N:
            out[i, c.size:] = c[-1]
        lens[i] = c.size
    return out, lens
