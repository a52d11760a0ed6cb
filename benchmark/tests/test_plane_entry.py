"""The resident entry's slots: each call in the window hands the program the
rows of ``cell.batch(k)`` and returns that call's counts, as counted call by
call, over whole periods of a set whose size and call width share no
factor."""

import functools
import math

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cell_mod, counting

READS = {"reads": {"count": 9, "shortest": 300, "longest": 3000}}
TRAFFIC = {"reads_per_call": 4, "sample_calls": 2, "warmup_calls": 1}


@pytest.fixture
def cell():
    cell = cell_mod.Cell.load("resident_zstd0.decode", 2**31 + 11, "cpu",
                              config_override=READS,
                              traffic_override=TRAFFIC)
    assert math.gcd(cell.reads.count, TRAFFIC["reads_per_call"]) == 1
    return cell


def entry_of(cell, program=None):
    module = cell_mod.load_module(cell_mod.BENCH / "entries" /
                                  f"{cell.traffic['entry']}.py")
    return module.Entry(cell, program=program)


def test_a_period_visits_every_start_row_once(cell):
    assert cell.period == cell.reads.count
    starts = {int(cell.batch(k)[0]) for k in range(cell.period)}
    assert starts == set(range(cell.reads.count))
    assert np.array_equal(cell.batch(cell.period), cell.batch(0))


def test_calls_pass_their_batch_and_count_it(cell):
    seen = []
    entry = entry_of(cell)
    program = entry.program

    def recording(streams, lengths, stream_lens, **kw):
        seen.append((streams, lengths, stream_lens))
        return program.func(streams, lengths, stream_lens, **kw)

    entry.program = functools.partial(recording, **program.keywords)
    rs, st = cell.reads, cell.streams
    for k in range(2 * cell.period):
        idx = cell.batch(k)
        done = entry.call(k, idx)
        n, slen = rs.lengths[idx], st.lengths[idx]
        assert done.raw_bytes == 2 * int(n.sum())
        assert done.counts == {"d_bytes": counting.decode_bytes(n, slen)}
        streams, lengths, stream_lens = seen[-1]
        assert lengths.tolist() == n.tolist()
        assert stream_lens.tolist() == slen.tolist()
        for row, i in zip(streams, idx):
            s, sl = int(st.starts[i]), int(st.lengths[i])
            assert torch.equal(row[:sl], st.flat[s:s + sl])
            assert not bool(row[sl:].any())
        assert torch.equal(entry.oks[-1], torch.ones(len(idx),
                                                     dtype=torch.bool))
    assert len(seen) == 2 * cell.period
    assert entry.sample.seen == 2 * cell.period
    # The decoded values of the sampled calls are the reads.
    assert entry.check()["sampled_rows_differing"] == (0, 0)

