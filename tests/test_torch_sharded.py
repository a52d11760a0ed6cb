"""The port's data-parallel plane (``vbz_compression_tpu_torch.parallel``)
against the JAX plane (``vbz_compression_tpu.parallel.sharded``) on the
8-device CPU mesh, exactly: every row's stream bytes, the gathered stream
lengths, the total and ``ok`` of the wire-format plane, and the rows plane
against ``batch_encode_sharded_pallas5`` in interpret mode, as
``tests/test_sharded.py`` runs them.

The port runs in gloo groups of 1, 2 and 4 CPU ranks, each rank a process of
its own that must end within ``RANK_TIMEOUT`` seconds. The inputs are
``tests/test_sharded.py``'s (B=16 rows of 100-512 uniform int16, N=512, seed
0; B=8 rows of a 2048-sample walk, seed 0) and zz16 rows of 1-7 values and of
the whole row; the wire plane runs zz16 (kernel E's flavor), none16 and zz32
(E4's). Malformed rows (a stream length one short, one long) must give
``ok`` false where JAX's does.
"""

import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbz_compression_tpu.parallel import sharded as jax_sharded
from vbz_compression_tpu_torch.parallel import dryrun, sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120
WORLDS = (1, 2, 4)
_SIGNED = {2: np.int16, 4: np.int32}

# One rank of a gloo group: the port's plane on the inputs of ``inp``, its
# outputs saved to ``out``.
_RANK_CODE = r"""
import sys
import numpy as np
import torch.distributed as dist
from vbz_compression_tpu_torch.parallel import multihost, sharded

inp, out, init, world, rank = sys.argv[1:6]
world, rank = int(world), int(rank)
group = multihost.initialize(init, world, rank, "gloo")


def shard(a):
    return sharded.shard_batch(a, group, "cpu")


def raises(fn):
    try:
        fn()
    except ValueError:
        return 1
    return 0


try:
    z = np.load(inp)
    res = {}
    for i, (size, zigzag, out_n) in enumerate(z["wire_meta"]):
        kw = dict(group=group, integer_size=int(size),
                  use_zigzag=bool(zigzag))
        lens = shard(z[f"lens{i}"])
        streams, stream_lens, total = sharded.batch_encode_sharded(
            shard(z[f"x{i}"]), lens, **kw)
        res[f"streams{i}"] = streams.numpy()
        res[f"stream_lens{i}"] = stream_lens.numpy()
        res[f"total{i}"] = total.numpy()
        for tag, sl in (("good", stream_lens.numpy()), ("bad", z[f"bad{i}"])):
            x, ok = sharded.batch_decode_sharded(
                streams, lens, shard(sl), out_n=int(out_n), **kw)
            res[f"out_{tag}{i}"] = x.numpy()
            res[f"ok_{tag}{i}"] = ok.numpy()
    keys, data, data_len, total = sharded.batch_encode_sharded_rows(
        shard(z["sig"]), group=group)
    res.update(keys=keys.numpy(), data=data.numpy(),
               data_len=data_len.numpy(), rows_total=total.numpy(),
               rows_back=sharded.batch_decode_sharded_rows(
                   keys, data, group=group).numpy())
    res["uneven_raises"] = raises(
        lambda: shard(np.zeros((2 * world + 1, 4), np.int16)))
    np.savez(out, **res)
finally:
    dist.destroy_process_group()
"""


def _wire_cases():
    """[(name, x [B, N], lens, integer_size, zigzag)] of the wire plane."""
    rng = np.random.default_rng(0)
    B, N = 16, 512
    chunks = [rng.integers(-3000, 3000, rng.integers(100, N + 1),
                           dtype=np.int16) for _ in range(B)]
    batch, lens = jax_sharded.pad_chunks(chunks, pad_to=N)
    short = [np.random.default_rng(7).integers(-3000, 3000, n,
                                               dtype=np.int16)
             for n in (1, 2, 3, 4, 5, 6, 7, 64)]
    sbatch, slens = jax_sharded.pad_chunks(short, pad_to=64)
    return [("uniform zz16", batch, lens, 2, True),
            ("uniform none16", batch, lens, 2, False),
            ("uniform zz32", batch.astype(np.int32), lens, 4, True),
            ("lengths 1-7 and 64, zz16", sbatch, slens, 2, True)]


WIRE = _wire_cases()


def _walk() -> np.ndarray:
    rng = np.random.default_rng(0)
    return np.clip(500 + np.cumsum(rng.normal(0, 12, (8, 2048)), axis=1),
                   -2000, 2000).astype(np.int16)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX plane's outputs on every input, on the 8-device mesh."""
    from jax.experimental.pallas import tpu as pltpu

    mesh = jax_sharded.make_mesh()
    out = {"wire": []}
    for _name, x, lens, size, zigzag in WIRE:
        kw = dict(mesh=mesh, integer_size=size, use_zigzag=zigzag)
        lb = jax_sharded.shard_batch(mesh, lens)
        streams, stream_lens, total = jax_sharded.batch_encode_sharded(
            jax_sharded.shard_batch(mesh, x), lb, **kw)
        stream_lens = np.asarray(stream_lens)
        bad = stream_lens.copy()
        bad[0] -= 1
        bad[1] += 1
        case = {"streams": np.asarray(streams), "stream_lens": stream_lens,
                "total": int(total), "bad": bad}
        for tag, sl in (("good", stream_lens), ("bad", bad)):
            dec, ok = jax_sharded.batch_decode_sharded(
                streams, lb, jax_sharded.shard_batch(mesh, sl),
                out_n=x.shape[1], **kw)
            case[f"out_{tag}"], case[f"ok_{tag}"] = (np.asarray(dec),
                                                     np.asarray(ok))
        out["wire"].append(case)
    sig = _walk()
    B, N = sig.shape
    with pltpu.force_tpu_interpret_mode():
        keys, data, lens5, total5, _ovf = \
            jax_sharded.batch_encode_sharded_pallas5(
                jnp.asarray(jax_sharded.flatten_rows(sig)), mesh=mesh,
                batch=B, block=512, slack=256)
    out["rows"] = {"keys": np.asarray(keys).reshape(B, N // 4),
                   "data": np.asarray(data).view(np.uint8).reshape(B, -1),
                   "data_len": np.asarray(lens5), "total": int(total5)}
    return out


def _run_ranks(world: int, inputs: str, tmp) -> list:
    """The rank code in ``world`` processes of one gloo group; each rank's
    outputs. A rank still running after RANK_TIMEOUT seconds is killed and
    fails the test."""
    init = "file://" + os.path.join(tmp, "rendezvous")
    env = {k: v for k, v in os.environ.items() if k != "VBZ_BACKEND"}
    env["PYTHONPATH"] = REPO
    outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_CODE, inputs, outs[r], init, str(world),
         str(r)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            _, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, jax_ref, tmp_path_factory):
    """Every rank's outputs of a gloo group of ``world`` ranks."""
    tmp = str(tmp_path_factory.mktemp(f"world{request.param}"))
    arrays = {"wire_meta": np.array([(size, int(zz), x.shape[1])
                                     for _n, x, _l, size, zz in WIRE]),
              "sig": _walk()}
    for i, (_name, x, lens, _size, _zz) in enumerate(WIRE):
        arrays.update({f"x{i}": x, f"lens{i}": lens,
                       f"bad{i}": jax_ref["wire"][i]["bad"]})
    inputs = os.path.join(tmp, "inputs.npz")
    np.savez(inputs, **arrays)
    return _run_ranks(request.param, inputs, tmp)


CASES = pytest.mark.parametrize("case", range(len(WIRE)),
                                ids=[w[0] for w in WIRE])


@CASES
def test_stream_bytes_match_jax(ranks, jax_ref, case):
    """Every row's stream, zero tail included, in rank order."""
    got = np.concatenate([r[f"streams{case}"] for r in ranks])
    np.testing.assert_array_equal(got, jax_ref["wire"][case]["streams"])


@CASES
def test_stream_lens_and_total_match_jax(ranks, jax_ref, case):
    """Every rank holds all the lengths in rank order, and the total."""
    ref = jax_ref["wire"][case]
    for r in ranks:
        np.testing.assert_array_equal(r[f"stream_lens{case}"],
                                      ref["stream_lens"])
        assert int(r[f"total{case}"]) == ref["total"] \
            == int(ref["stream_lens"].sum())


@CASES
def test_ok_matches_jax(ranks, jax_ref, case):
    """``ok`` on every rank: all true on the streams as written, false on
    the rows whose stream length is one short and one long, as JAX's."""
    ref = jax_ref["wire"][case]
    assert ref["ok_good"].all() and not ref["ok_bad"][:2].any()
    for r in ranks:
        np.testing.assert_array_equal(r[f"ok_good{case}"], ref["ok_good"])
        np.testing.assert_array_equal(r[f"ok_bad{case}"], ref["ok_bad"])


@CASES
def test_decoded_rows_match_jax(ranks, jax_ref, case):
    """The decoded values up to each row's length are JAX's and the input's;
    past it the port gives 0 (JAX's zig-zag decode repeats the last
    value)."""
    _name, x, lens, _size, _zz = WIRE[case]
    got = np.concatenate([r[f"out_good{case}"] for r in ranks])
    ref = jax_ref["wire"][case]["out_good"]
    valid = np.arange(x.shape[1])[None] < lens[:, None]
    np.testing.assert_array_equal(got[valid], ref[valid])
    np.testing.assert_array_equal(got, np.where(valid, x, 0))


def test_rows_plane_matches_pallas5(ranks, jax_ref):
    """The rows plane against the codec5 plane in interpret mode: the keys,
    each row's data bytes, the gathered data lengths and the total; and the
    round trip."""
    ref = jax_ref["rows"]
    np.testing.assert_array_equal(
        np.concatenate([r["keys"] for r in ranks]), ref["keys"])
    data = np.concatenate([r["data"] for r in ranks])
    for b, n in enumerate(ref["data_len"]):
        assert data[b, :n].tobytes() == ref["data"][b, :n].tobytes()
    for r in ranks:
        np.testing.assert_array_equal(r["data_len"], ref["data_len"])
        assert int(r["rows_total"]) == ref["total"]
    np.testing.assert_array_equal(
        np.concatenate([r["rows_back"] for r in ranks]), _walk())


def test_uneven_batches_raise(ranks):
    """A batch that does not divide over the ranks raises ValueError in
    shard_batch (on more than one rank)."""
    if len(ranks) == 1:
        assert [int(r["uneven_raises"]) for r in ranks] == [0]
    else:
        assert all(int(r["uneven_raises"]) for r in ranks)


def test_no_group_matches_jax(jax_ref):
    """Without a group the collectives are identities: the whole batch in
    this process gives JAX's streams, lengths and total."""
    _name, x, lens, size, zigzag = WIRE[0]
    streams, stream_lens, total = sharded.batch_encode_sharded(
        torch.from_numpy(x), torch.from_numpy(lens), integer_size=size,
        use_zigzag=zigzag)
    ref = jax_ref["wire"][0]
    np.testing.assert_array_equal(streams.numpy(), ref["streams"])
    np.testing.assert_array_equal(stream_lens.numpy(), ref["stream_lens"])
    assert int(total) == ref["total"]
    assert sharded.rank_world(None) == (0, 1)



def test_plane_looks_up_its_stream_decoder_each_call(monkeypatch):
    """The wire plane decodes zz16 and zz8 through the in-place decoder it
    finds in ``_STREAM_DECODERS`` on the call (a fault planted there is
    reached), and the W4 kinds without it."""
    calls = []
    original = sharded._STREAM_DECODERS["w2"]

    def recording(*args):
        calls.append(args[-1])
        return original(*args)

    monkeypatch.setitem(sharded._STREAM_DECODERS, "w2", recording)
    lens = torch.tensor([0, 5, 300], dtype=torch.int32)
    for size, zigzag in ((2, True), (1, True), (2, False), (4, True)):
        x = torch.from_numpy(np.random.default_rng(size).integers(
            -100, 100, (3, 512)).astype({1: np.int8, 2: np.int16,
                                         4: np.int32}[size]))
        kw = dict(integer_size=size, use_zigzag=zigzag)
        streams, slen, _ = sharded.batch_encode_sharded(x, lens, **kw)
        out, ok = sharded.batch_decode_sharded(streams, lens, slen,
                                               out_n=512, **kw)
        assert bool(ok.all()) and torch.equal(out, torch.where(
            torch.arange(512)[None] < lens[:, None], x, 0))
    assert calls == ["zz16", "zz8"]

def test_dryrun_world2():
    """The dry run's three checks on two spawned gloo ranks."""
    got = dryrun.run(2, device="cpu", timeout=RANK_TIMEOUT)
    assert [g["rank"] for g in got] == [0, 1]
    assert got[0]["plane_bytes"] == got[1]["plane_bytes"] > 0
    assert got[0]["rows_bytes"] == got[1]["rows_bytes"] > 0


def test_rank_device(monkeypatch):
    """The caller's device wins; VBZ_BACKEND=torch is the CPU; with neither
    and no card the plane raises, with no fallback."""
    assert sharded.rank_device(None, "cpu") == torch.device("cpu")
    monkeypatch.setenv("VBZ_BACKEND", "torch")
    assert sharded.rank_device() == torch.device("cpu")
    monkeypatch.delenv("VBZ_BACKEND")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        sharded.rank_device()
    with pytest.raises(RuntimeError):
        sharded.shard_batch(np.zeros((2, 4), np.int16))


@pytest.mark.parametrize("mode", ["zero", "edge"])
def test_pad_chunks_matches_jax(mode):
    chunks = [np.arange(n, dtype=np.int16) - 3 for n in (0, 1, 5, 9)]
    for pad_to in (None, 16):
        got = sharded.pad_chunks(chunks, pad_to, mode)
        ref = jax_sharded.pad_chunks(chunks, pad_to, mode)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
