"""The VBZ sized pipeline on the PyTorch backend — the ``vbz.h`` C-ABI
surface, in Python.

The port's own copy of the pipeline in ``vbz_compression_tpu.api`` (the
reference ``vbz/vbz.cpp``): option validation, v0/v1 version dispatch, the
optional StreamVByte stage, the optional zstd stage (host-side libzstd,
or the from-scratch RFC 8878 encoder of ``ops.zstd_seq`` that
``VBZ_ZSTD_ENCODER`` chooses) and the 4-byte little-endian sized framing.
libzstd is reached through the ``zstandard`` package where it imports, as
the JAX package reaches it, else through ``libzstd.so.1`` by ctypes
(:mod:`.utils.libzstd`); :func:`zstd_route` says which.
The StreamVByte stage is the ``backend=`` argument: a
:class:`~.models.codec.TorchSvbBackend`, or any object with the same
methods, such as the NumPy oracle (``oracle``) or the native C++ codec
(:class:`~.native_backend.NativeSvbBackend`).

``default_backend()`` is the CUDA backend when a card is visible.
``VBZ_BACKEND=torch`` chooses the plain PyTorch version on the CPU instead,
``VBZ_BACKEND=native`` the native C++ codec on the CPU (built from
``native/`` at first use). Without a card and without the variable it
raises: nothing moves silently to another codec.

A backend that sets ``gil_free_svb`` (the native codec: its ctypes calls
release the interpreter lock) runs each chunk's whole pipeline, StreamVByte
and zstd, in the batch calls' thread pool, as the JAX package's api does.
"""

from __future__ import annotations

import functools
import os
import struct
import warnings

import numpy as np
import torch

from .errors import (
    VBZ_DESTINATION_SIZE_ERROR,
    VBZ_INPUT_SIZE_ERROR,
    VBZ_ZSTD_ERROR,
    VbzError,
)
from .models.codec import TorchSvbBackend
from .ops import scalar, zstd_match, zstd_seq
from .options import CompressionOptions
from .utils import libzstd, profiling

SIZED_HEADER_BYTES = 4  # VbzSizedHeader{uint32 original_size}, vbz/vbz.cpp:52-55


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible; set VBZ_BACKEND=torch to "
                           "run the plain PyTorch version on the CPU, or "
                           "VBZ_BACKEND=native for the native C++ codec")


def default_backend():
    forced = os.environ.get("VBZ_BACKEND", "").lower()
    if forced == "torch":
        return TorchSvbBackend("cpu")
    if forced == "native":
        from . import native_backend

        native_backend.lib()
        return native_backend.NativeSvbBackend()
    if forced:
        raise ValueError(f"unknown VBZ_BACKEND {forced!r} for the PyTorch "
                         "port (want torch or native, or leave it unset)")
    _require_card()
    return TorchSvbBackend("cuda")


def _resolved(backend):
    return default_backend() if backend is None else backend


def _as_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    return np.ascontiguousarray(data).tobytes()


# ---------------------------------------------------------------------------
# zstd stage (host-side libzstd; frame-compatible with the reference)
# ---------------------------------------------------------------------------


@functools.cache
def _zstandard():
    """The ``zstandard`` module where it imports, else None: the stage then
    calls ``libzstd.so.1`` through :mod:`.utils.libzstd`. Chosen once;
    tests patch this attribute to force the ctypes route."""
    try:
        import zstandard
    except ImportError:
        return None
    return zstandard


def zstd_route() -> str:
    """The library the zstd stage calls: ``"zstandard <ver> (libzstd
    <ver>)"`` or ``"libzstd.so.1 <ver>"``; ``OSError`` where neither
    loads."""
    zstandard = _zstandard()
    if zstandard is not None:
        return (f"zstandard {zstandard.__version__} (libzstd "
                f"{'.'.join(map(str, zstandard.ZSTD_VERSION))})")
    return f"{libzstd.lib().name} {libzstd.version_string()}"


def zstd_compress_bound(source_size: int) -> int:
    """The public ``ZSTD_COMPRESSBOUND`` formula (zstd.h macro)."""
    margin = ((128 << 10) - source_size) >> 11 if source_size < (128 << 10) else 0
    return source_size + (source_size >> 8) + margin


ZSTD_ENCODERS = ("libzstd", "own", "own-tpu")


def zstd_encoder(encoder: str | None = None) -> str:
    """``encoder``, else ``VBZ_ZSTD_ENCODER``, else "libzstd"; raises
    ``ValueError`` for a name outside :data:`ZSTD_ENCODERS`."""
    encoder = encoder or os.environ.get("VBZ_ZSTD_ENCODER", "libzstd")
    if encoder not in ZSTD_ENCODERS:
        raise ValueError(f"unknown zstd encoder {encoder!r} (want one of "
                         f"{ZSTD_ENCODERS})")
    return encoder


def scan_device(backend=None) -> torch.device:
    """The device of the "own-tpu" match scan (and of the corpus driver's
    rows): the backend's where it has one, else :func:`default_backend`'s
    (the card, or the CPU under ``VBZ_BACKEND=torch``), else the card (the
    backend is a host codec: the oracle, or the native codec); it raises
    without one."""
    device = getattr(backend, "device", None)
    if device is None:
        device = getattr(default_backend(), "device", None)
    if device is None:
        _require_card()
        device = "cuda"
    return torch.device(device)


def zstd_compress(data: bytes, level: int, encoder: str | None = None, *,
                  device=None) -> bytes:
    """zstd stage. ``encoder`` (or env ``VBZ_ZSTD_ENCODER``):
    - "libzstd" (default): libzstd (:func:`zstd_route`), with the tuned
      level-1 dfast profile below;
    - "own": the from-scratch RFC 8878 encoder (:mod:`.ops.zstd_seq` —
      Huffman literals + LZ77 matches + FSE sequences), hash index on the
      host;
    - "own-tpu": the same, with the match scan on ``device``
      (:mod:`.ops.zstd_match`: kernel M on the card, its plain version on
      the CPU; :func:`scan_device` when ``device`` is None). The JAX
      package's name, so a deployment's environment carries over.
    All three emit frames any stock zstd decoder reads.

    The from-scratch encoders are single-profile (roughly a level-1 work
    factor) and **ignore** ``level``, with a warning when a level above 1
    was asked for.

    Span ``zstd.compress``, counting the frame's bytes."""
    with profiling.span("zstd.compress") as s:
        frame = _zstd_compress(data, level, encoder, device)
        s.add(len(frame))
    return frame


def _zstd_compress(data: bytes, level: int, encoder: str | None,
                   device) -> bytes:
    encoder = zstd_encoder(encoder)
    if encoder != "libzstd":
        if int(level) > 1:
            warnings.warn(
                f"zstd level {level} requested but the '{encoder}' encoder "
                "is single-profile (~level 1); level is ignored",
                stacklevel=3)
        if encoder == "own":
            return zstd_seq.compress_frame(bytes(data), matcher="host")
        return zstd_seq.compress_frame(
            bytes(data), matcher="device",
            device=scan_device() if device is None else device)
    zstandard = _zstandard()
    if zstandard is None:
        return libzstd.compress(data, level)
    level = max(min(int(level), zstandard.MAX_COMPRESSION_LEVEL), -131072)
    try:
        if level == 1:
            # Level-1 profile tuned on the signal corpus: double-fast matcher
            # with a 512 KiB window compresses StreamVByte payloads tighter
            # than stock level 1 at equivalent speed. The zstd level is an
            # encoder-only knob — decode compatibility is unaffected.
            params = zstandard.ZstdCompressionParameters(
                window_log=19, chain_log=14, hash_log=16, search_log=1,
                min_match=5, target_length=0,
                strategy=zstandard.STRATEGY_DFAST,
                write_checksum=0, write_content_size=1)
            cctx = zstandard.ZstdCompressor(compression_params=params)
        else:
            cctx = zstandard.ZstdCompressor(
                level=level, write_checksum=False, write_content_size=True)
        return cctx.compress(data)
    except zstandard.ZstdError as exc:  # pragma: no cover
        raise VbzError(VBZ_ZSTD_ERROR, str(exc))


def zstd_frame_content_size(data: bytes) -> int:
    """``ZSTD_getFrameContentSize`` equivalent; raises VBZ_ZSTD_ERROR when the
    frame is invalid or the content size is unknown (``vbz/vbz.cpp:236-240``)."""
    zstandard = _zstandard()
    if zstandard is None:
        return libzstd.frame_content_size(data)

    try:
        params = zstandard.get_frame_parameters(data)
    except zstandard.ZstdError as exc:
        raise VbzError(VBZ_ZSTD_ERROR, str(exc))
    if params.content_size in (zstandard.CONTENTSIZE_UNKNOWN,
                               zstandard.CONTENTSIZE_ERROR):
        raise VbzError(VBZ_ZSTD_ERROR, "unknown frame content size")
    return int(params.content_size)


def zstd_decompress(data: bytes, expected_size: int) -> bytes:
    """The frame's content, at most ``expected_size`` bytes (at least 1).
    Span ``zstd.decompress``, counting the frame's bytes."""
    with profiling.span("zstd.decompress", len(data)):
        zstandard = _zstandard()
        if zstandard is None:
            return libzstd.decompress(data, expected_size)

        try:
            dctx = zstandard.ZstdDecompressor()
            return dctx.decompress(data,
                                   max_output_size=max(expected_size, 1))
        except zstandard.ZstdError as exc:
            raise VbzError(VBZ_ZSTD_ERROR, str(exc))


def _own_scan_device(backend):
    """The match scan's device for this backend when the zstd stage is
    "own-tpu", with kernel M loaded before any thread launches it; None
    for the other encoders."""
    if zstd_encoder() != "own-tpu":
        return None
    device = scan_device(backend)
    zstd_match.preload(device)
    return device


def _map_zstd(fn, items: list) -> list:
    """Run the host zstd stage across chunks on a thread pool (libzstd
    releases the GIL); a plain loop for one chunk or one core. Span
    ``zstd.pool``; the pool threads' spans lie under it."""
    with profiling.span("zstd.pool"):
        if len(items) <= 1 or (os.cpu_count() or 1) <= 1:
            return [fn(x) for x in items]
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
                max_workers=min(len(items), os.cpu_count())) as pool:
            return list(pool.map(profiling.carry(fn), items))


# ---------------------------------------------------------------------------
# Core API (mirrors vbz/vbz.h:56-141)
# ---------------------------------------------------------------------------


def vbz_max_compressed_size(source_size: int, options: CompressionOptions) -> int:
    """Worst-case compressed size incl. the sized header (``vbz/vbz.cpp:79-114``)."""
    options.validate().validate_version()
    max_size = source_size
    if options.integer_size != 0:
        max_size = scalar.svb_max_compressed_size(options.integer_size, source_size)
    if options.zstd_compression_level != 0:
        max_size = zstd_compress_bound(max_size)
    return max_size + SIZED_HEADER_BYTES


def vbz_compress(data, options: CompressionOptions, backend=None) -> bytes:
    """Compress without framing (``vbz/vbz.cpp:116-208``). The root span
    ``api.compress`` of a public call, counting the raw bytes."""
    with profiling.call("api.compress") as s:
        backend = _resolved(backend)
        options.validate()
        raw = _as_bytes(data)
        s.add(len(raw))
        return _vbz_compress(raw, options, backend)


def _vbz_compress(raw: bytes, options: CompressionOptions, backend) -> bytes:
    if options.zstd_compression_level == 0 and options.integer_size == 0:
        return raw
    current = raw
    if options.integer_size != 0:
        options.validate_version()
        current = bytes(backend.svb_compress(
            raw, options.integer_size, options.perform_delta_zig_zag,
            options.vbz_version))
    if options.zstd_compression_level == 0:
        return current
    return zstd_compress(current, options.zstd_compression_level,
                         device=_own_scan_device(backend))


def _check_destination(size: int, options: CompressionOptions) -> int:
    """Values in a destination of ``size`` bytes."""
    if size % options.integer_size != 0:
        raise VbzError(VBZ_DESTINATION_SIZE_ERROR,
                       f"{size} % {options.integer_size} != 0")
    return size // options.integer_size


def vbz_decompress(stream, destination_size: int, options: CompressionOptions,
                   backend=None) -> bytes:
    """Decompress a stream into exactly ``destination_size`` bytes
    (``vbz/vbz.cpp:210-300``). The root span ``api.decompress`` of a public
    call, counting the raw bytes out."""
    with profiling.call("api.decompress") as s:
        backend = _resolved(backend)
        options.validate()
        out = _vbz_decompress(_as_bytes(stream), destination_size, options,
                              backend)
        s.add(len(out))
        return out


def _vbz_decompress(raw: bytes, destination_size: int,
                    options: CompressionOptions, backend) -> bytes:
    if options.zstd_compression_level == 0 and options.integer_size == 0:
        if len(raw) > destination_size:
            raise VbzError(VBZ_DESTINATION_SIZE_ERROR)
        return raw
    current = raw
    if options.zstd_compression_level != 0:
        content_size = zstd_frame_content_size(raw)
        if options.integer_size == 0 and content_size > destination_size:
            raise VbzError(VBZ_DESTINATION_SIZE_ERROR)
        current = zstd_decompress(raw, content_size)
    if options.integer_size == 0:
        return current
    options.validate_version()
    count = _check_destination(destination_size, options)
    out = backend.svb_decompress(
        current, count, options.integer_size, options.perform_delta_zig_zag,
        options.vbz_version)
    return np.ascontiguousarray(out).tobytes()


def vbz_compress_sized(data, options: CompressionOptions, backend=None) -> bytes:
    """Compress with the 4-byte little-endian original-size header
    (``vbz/vbz.cpp:302-330``). Root span ``api.compress``."""
    with profiling.call("api.compress") as s:
        raw = _as_bytes(data)
        s.add(len(raw))
        header = struct.pack("<I", len(raw))
        return header + vbz_compress(raw, options, backend=backend)


def vbz_decompressed_size(stream, options: CompressionOptions) -> int:
    """Read the original size from a sized stream (``vbz/vbz.cpp:369-386``)."""
    options.validate()
    raw = _as_bytes(stream)
    if len(raw) < SIZED_HEADER_BYTES:
        raise VbzError(VBZ_INPUT_SIZE_ERROR, "stream shorter than sized header")
    return struct.unpack_from("<I", raw)[0]


def vbz_decompress_sized(stream, options: CompressionOptions,
                         backend=None) -> bytes:
    """Inverse of :func:`vbz_compress_sized` (``vbz/vbz.cpp:332-367``).
    Root span ``api.decompress``."""
    with profiling.call("api.decompress") as s:
        options.validate()
        raw = _as_bytes(stream)
        original_size = vbz_decompressed_size(raw, options)
        out = vbz_decompress(raw[SIZED_HEADER_BYTES:], original_size,
                             options, backend=backend)
        s.add(len(out))
        return out


# ---------------------------------------------------------------------------
# Batch API: a backend with svb_*_batch methods gets every chunk of the call
# at once (one padded batch on the card); other backends loop.
# ---------------------------------------------------------------------------


def vbz_compress_sized_batch(chunks, options: CompressionOptions,
                             backend=None) -> list:
    """Sized-compress many chunks in one StreamVByte batch. Root span
    ``api.compress_batch``, counting the raw bytes."""
    with profiling.call("api.compress_batch") as s:
        backend = _resolved(backend)
        options.validate()
        raws = [_as_bytes(c) for c in chunks]
        if s:
            s.add(sum(map(len, raws)))
        return _compress_sized_batch(raws, options, backend)


def _compress_sized_batch(raws: list, options: CompressionOptions,
                          backend) -> list:
    headers = [struct.pack("<I", len(r)) for r in raws]
    current = raws
    if options.integer_size != 0 and options.zstd_compression_level != 0 \
            and getattr(backend, "svb_compress_batch", None) is None \
            and getattr(backend, "gil_free_svb", False):
        # Host codec with both stages active: run the WHOLE per-chunk
        # pipeline in the thread pool — this backend's svb stage advertises
        # that it releases the GIL (gil_free_svb), and libzstd does too, so
        # svb and zstd parallelize across chunks instead of svb running as
        # a serial prelude. Pure-Python backends skip this path (the pool
        # would add overhead without parallelism).
        options.validate_version()
        device = _own_scan_device(backend)

        def one(r):
            s = backend.svb_compress(
                r, options.integer_size, options.perform_delta_zig_zag,
                options.vbz_version)
            return zstd_compress(bytes(s), options.zstd_compression_level,
                                 device=device)

        return [h + bytes(x)
                for h, x in zip(headers, _map_zstd(one, raws))]
    if options.integer_size != 0:
        options.validate_version()
        args = (options.integer_size, options.perform_delta_zig_zag,
                options.vbz_version)
        batch_fn = getattr(backend, "svb_compress_batch", None)
        if batch_fn is not None:
            current = batch_fn(raws, *args)
        else:
            current = [backend.svb_compress(r, *args) for r in raws]
        current = [bytes(x) for x in current]
    if options.zstd_compression_level != 0:
        device = _own_scan_device(backend)
        current = _map_zstd(
            lambda x: zstd_compress(x, options.zstd_compression_level,
                                    device=device),
            current)
    return [h + bytes(x) for h, x in zip(headers, current)]


def vbz_decompress_sized_batch(streams, options: CompressionOptions,
                               backend=None) -> list:
    """Inverse of :func:`vbz_compress_sized_batch`; returns a list of
    ``bytes`` (each chunk's original buffer). Root span
    ``api.decompress_batch``, counting the raw bytes out."""
    with profiling.call("api.decompress_batch") as s:
        backend = _resolved(backend)
        options.validate()
        outs = _decompress_sized_batch([_as_bytes(x) for x in streams],
                                       options, backend)
        if s:
            s.add(sum(map(len, outs)))
        return outs


def _decompress_sized_batch(raws: list, options: CompressionOptions,
                            backend) -> list:
    sizes = [vbz_decompressed_size(r, options) for r in raws]
    bodies = [r[SIZED_HEADER_BYTES:] for r in raws]
    if options.zstd_compression_level != 0 and options.integer_size != 0 \
            and getattr(backend, "svb_decompress_batch", None) is None \
            and getattr(backend, "gil_free_svb", False):
        # Host codec, both stages: whole per-chunk pipeline per thread
        # (mirror of the compress path — both stages release the GIL).
        options.validate_version()

        def one(bd):
            body, dst = bd
            count = _check_destination(dst, options)
            content = zstd_decompress(body, zstd_frame_content_size(body))
            out = backend.svb_decompress(
                content, count, options.integer_size,
                options.perform_delta_zig_zag, options.vbz_version)
            return np.ascontiguousarray(out).tobytes()

        return _map_zstd(one, list(zip(bodies, sizes)))
    if options.zstd_compression_level != 0:
        content_sizes = [zstd_frame_content_size(b) for b in bodies]
        if options.integer_size == 0:
            for content_size, dst in zip(content_sizes, sizes):
                if content_size > dst:
                    raise VbzError(VBZ_DESTINATION_SIZE_ERROR)
        contents = _map_zstd(
            lambda bc: zstd_decompress(bc[0], bc[1]),
            list(zip(bodies, content_sizes)))
    else:
        contents = bodies
    if options.integer_size == 0:
        for content, dst in zip(contents, sizes):
            if len(content) > dst:
                raise VbzError(VBZ_DESTINATION_SIZE_ERROR)
        return contents
    options.validate_version()
    counts = [_check_destination(dst, options) for dst in sizes]
    args = (options.integer_size, options.perform_delta_zig_zag,
            options.vbz_version)
    batch_fn = getattr(backend, "svb_decompress_batch", None)
    if batch_fn is not None:
        outs = batch_fn(contents, counts, *args)
    else:
        outs = [backend.svb_decompress(content, count, *args)
                for content, count in zip(contents, counts)]
    return [np.ascontiguousarray(o).tobytes() for o in outs]


# ---------------------------------------------------------------------------
# pyvbz-compatible numpy API (reference: python/pyvbz/vbz/__init__.py:21-76)
# ---------------------------------------------------------------------------


def compress(data: np.ndarray, options: CompressionOptions | None = None,
             backend=None) -> np.ndarray:
    """Compress a numpy array to a sized stream; options inferred from dtype
    when omitted (signed → zig-zag, itemsize → integer width)."""
    if options is None:
        options = CompressionOptions.for_dtype(data.dtype,
                                               zstd_compression_level=1)
    with profiling.call("api.compress") as s:
        raw = _as_bytes(data)
        s.add(len(raw))
        out = vbz_compress_sized(raw, options, backend=backend)
        return np.frombuffer(out, dtype=np.uint8)


def decompress(data, dtype, options: CompressionOptions | None = None,
               backend=None) -> np.ndarray:
    """Decompress a sized stream back to a numpy array of ``dtype``."""
    dt = np.dtype(dtype)
    if options is None:
        options = CompressionOptions.for_dtype(dt, zstd_compression_level=1)
    with profiling.call("api.decompress") as s:
        out = vbz_decompress_sized(data, options, backend=backend)
        s.add(len(out))
        return np.frombuffer(out, dtype=dt)
