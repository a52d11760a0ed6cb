"""Fault site of ``ragged_decode``: ``stand_in_ragged_plane.rows``, which
produces the flat values and each row's ``ok``."""

from __future__ import annotations


def site():
    import stand_in_ragged_plane

    return vars(stand_in_ragged_plane), "rows"


def _altered(rows):
    def broken(flat, offsets, lengths):
        values, ok = rows(flat, offsets, lengths)
        values[0] ^= 1
        return values, ok
    return broken


def _half(rows):
    def broken(flat, offsets, lengths):
        values, ok = rows(flat, offsets, lengths)
        half = len(lengths) // 2
        values[int(lengths[:half].sum()):] = 0
        return values, ok
    return broken


BREAKS = {"answer_altered": _altered, "half_batch_left_out": _half}
