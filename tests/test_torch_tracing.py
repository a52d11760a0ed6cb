"""The port's own host spans (``vbz_compression_tpu_torch.utils.profiling``)
on the plain PyTorch backend (``VBZ_BACKEND=torch``): off by default with
outputs unchanged, and, on, one root a public call, children inside their
parents and carrying its call (also on the zstd pool's threads), the byte
counts of validation and of the copies, and nothing recorded outside
``recording()``."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from vbz_compression_tpu import api as jax_api
from vbz_compression_tpu.models.codec import JaxSvbBackend
from vbz_compression_tpu.options import CompressionOptions as JaxOptions
from vbz_compression_tpu_torch import CompressionOptions, api
from vbz_compression_tpu_torch.parallel import sharded
from vbz_compression_tpu_torch.utils import profiling

OPTS = CompressionOptions.from_cd_values((0, 2, 1, 1))
V0 = CompressionOptions.from_cd_values((0, 2, 1, 0))
LENGTHS = (5000, 3001, 1, 0, 7000)

API = {"api.decompress", "api.compress", "api.decompress_batch",
       "api.compress_batch"}
DECODE = {"backend.decode", "backend.validate", "backend.pack",
          "backend.h2d", "backend.launch", "backend.gather", "backend.d2h",
          "backend.unpack"}
ENCODE = DECODE - {"backend.decode", "backend.validate"} | {"backend.encode"}


@pytest.fixture(autouse=True)
def torch_cpu(monkeypatch):
    monkeypatch.setenv("VBZ_BACKEND", "torch")


def _reads():
    rng = np.random.default_rng(7)
    return [(rng.normal(0, 30, n).cumsum() % 3000).astype(np.int16)
            for n in LENGTHS]


def _stream_lens(reads):
    """Each read's v0 stream length: its level-0 sized frame less the
    header."""
    return [len(api.vbz_compress_sized(r, V0)) - 4 for r in reads]


def _record(fn):
    with profiling.recording():
        out = fn()
    return out, profiling.spans()


# Each public call: (what it does, the names of its spans, how many reads).
CALLS = {
    "decompress": (lambda r, f: api.decompress(f[0], np.int16, OPTS),
                   {"api.decompress", "zstd.decompress"} | DECODE, 1),
    "vbz_decompress_sized": (
        lambda r, f: api.vbz_decompress_sized(f[0], OPTS),
        {"api.decompress", "zstd.decompress"} | DECODE, 1),
    "compress": (lambda r, f: api.compress(r[0], OPTS),
                 {"api.compress", "zstd.compress"} | ENCODE, 1),
    "vbz_compress_sized": (lambda r, f: api.vbz_compress_sized(r[0], OPTS),
                           {"api.compress", "zstd.compress"} | ENCODE, 1),
    "decompress_batch": (
        lambda r, f: api.vbz_decompress_sized_batch(f, OPTS),
        {"api.decompress_batch", "zstd.pool", "zstd.decompress"} | DECODE,
        len(LENGTHS)),
    "compress_batch": (
        lambda r, f: api.vbz_compress_sized_batch(r, OPTS),
        {"api.compress_batch", "zstd.pool", "zstd.compress"} | ENCODE,
        len(LENGTHS)),
}


def test_off_by_default_records_nothing_and_changes_no_byte():
    reads = _reads()
    frames = [api.vbz_compress_sized(r, OPTS) for r in reads]
    _record(lambda: None)  # empties the records
    assert profiling.span("x") is profiling.call("y")
    assert not profiling.span("x")
    jax_opts = JaxOptions(True, 2, 1, 0)
    for r, f in zip(reads, frames):
        assert f == jax_api.vbz_compress_sized(r, jax_opts,
                                               backend=JaxSvbBackend())
        assert api.compress(r, OPTS).tobytes() == f
        np.testing.assert_array_equal(api.decompress(f, np.int16, OPTS), r)
    assert api.vbz_compress_sized_batch(reads, OPTS) == frames
    assert [np.frombuffer(b, np.int16).tolist() for b in
            api.vbz_decompress_sized_batch(frames, OPTS)] == \
        [r.tolist() for r in reads]
    assert profiling.spans() == []
    for name, (fn, _, _) in CALLS.items():
        on, _ = _record(lambda: fn(reads, frames))
        off = fn(reads, frames)
        assert (np.array_equal(on, off) if isinstance(on, np.ndarray)
                else on == off), name
    assert len(profiling.spans()) > 0


@pytest.mark.parametrize("name", CALLS)
def test_spans_of_a_public_call(name):
    fn, names, count = CALLS[name]
    reads, frames = _reads(), [api.vbz_compress_sized(r, OPTS)
                               for r in _reads()]
    _, recs = _record(lambda: fn(reads, frames))
    assert {r.name for r in recs} == names
    roots = [r for r in recs if r.parent == 0]
    assert len(roots) == 1 and roots[0].name in API
    root = roots[0]
    assert all(r.call == root.id for r in recs)
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs)
    for r in recs:
        assert r.start <= r.end
        if r.parent:
            p = by_id[r.parent]
            assert p.start <= r.start and r.end <= p.end, (r, p)
    assert [r.name for r in recs if r.name in API] == [root.name]
    raw = sum(2 * n for n in LENGTHS[:count])
    assert root.nbytes == raw
    # The zstd stage runs on pool threads for the batch calls: their spans
    # lie under the pool's span and carry the call.
    zstd = [r for r in recs if r.name.startswith("zstd.")
            and r.name != "zstd.pool"]
    assert len(zstd) == count
    if count > 1 and (os.cpu_count() or 1) > 1:
        pool = next(r for r in recs if r.name == "zstd.pool")
        assert all(r.parent == pool.id for r in zstd)
        assert {r.thread for r in zstd} - {root.thread}
    assert sum(r.nbytes for r in zstd) == sum(
        len(f) - 4 for f in frames[:count])
    assert not [r for r in recs if r.name == "backend.wait"]
    assert len([r for r in recs if r.name == "backend.launch"]) == 1


@pytest.mark.parametrize("name", CALLS)
def test_byte_counts_of_validation_and_copies(name):
    fn, names, count = CALLS[name]
    reads = _reads()
    frames = [api.vbz_compress_sized(r, OPTS) for r in reads]
    streams = _stream_lens(reads)[:count]
    lengths = LENGTHS[:count]
    live = sum(1 for n in lengths if n)
    _, recs = _record(lambda: fn(reads, frames))
    if "backend.decode" in names:
        h2d, d2h = sum(streams) + 4 * live, 2 * sum(lengths)
        [validate] = [r for r in recs if r.name == "backend.validate"]
        assert validate.nbytes == sum(streams)
    else:
        h2d, d2h = 2 * sum(lengths) + 4 * live, 4 * live + sum(streams)
    copies = {k: [r.nbytes for r in recs if r.name == k]
              for k in ("backend.h2d", "backend.d2h")}
    assert sum(copies["backend.h2d"]) == h2d
    assert sum(copies["backend.d2h"]) == d2h
    assert len(copies["backend.h2d"]) == 2
    assert len(copies["backend.d2h"]) == (
        1 if "backend.decode" in names else 2)


def _plane_decode_records(**kw):
    reads = [r for r in _reads() if r.size]
    x, lens = sharded.pad_chunks(reads)
    x, lens = torch.from_numpy(x), torch.from_numpy(lens)
    streams, slen, _ = sharded.batch_encode_sharded(x, lens, **kw)
    (out, ok), recs = _record(lambda: sharded.batch_decode_sharded(
        streams, lens, slen, out_n=x.shape[1], **kw))
    assert bool(ok.all()) and torch.equal(out, x)
    root = recs[-1]
    assert root.parent == 0 and root.call == root.id
    assert all(r.parent == root.id and r.call == root.id
               and root.start <= r.start <= r.end <= root.end
               for r in recs[:-1])
    return [r.name for r in recs]


def test_plane_decode_spans():
    """zz16 takes the in-place decoder, which gives ok too: no layout and
    no key counts to enqueue."""
    assert _plane_decode_records() == ["plane.launch", "plane.decode"]


def test_plane_decode_spans_of_the_composition():
    """A W4 kind (none16) cuts the sections, decodes them, and counts the
    keys behind ok, each in its span."""
    assert _plane_decode_records(use_zigzag=False) == [
        "plane.layout", "plane.launch", "plane.ok", "plane.decode"]


def test_no_record_escapes_recording():
    reads = _reads()
    frame = api.vbz_compress_sized(reads[0], OPTS)
    before = threading.Event()
    leave = threading.Event()

    def straddling():
        # Opened while on, closed after the recorder stops.
        with profiling.span("straddle"):
            before.set()
            assert leave.wait(10)

    with profiling.recording():
        t = threading.Thread(target=straddling)
        t.start()
        assert before.wait(10)
        api.decompress(frame, np.int16, OPTS)
    leave.set()
    t.join(10)
    assert not t.is_alive()
    recs = profiling.spans()
    assert recs and "straddle" not in {r.name for r in recs}
    api.decompress(frame, np.int16, OPTS)
    api.vbz_compress_sized_batch(reads, OPTS)
    assert profiling.spans() == recs


def test_threads_record_concurrently():
    """More threads than cores open nested spans while the interpreter
    switches often: every record is kept, under its own thread's parent."""
    threads, depth, rounds = 4 * (os.cpu_count() or 1), 3, 50

    def work():
        for _ in range(rounds):
            with profiling.call("api.decompress"):
                with profiling.span("backend.decode"):
                    with profiling.span("backend.launch"):
                        pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    recs = profiling.spans()
    assert len(recs) == threads * depth * rounds
    assert len({r.id for r in recs}) == len(recs)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent:
            p = by_id[r.parent]
            assert (p.thread, p.call) == (r.thread, r.call)
        else:
            assert r.name == "api.decompress" and r.call == r.id
