"""Fault site of ``plane_decode``: the wire-format plane's in-place decoder
of W2 stream rows, ``parallel.sharded._STREAM_DECODERS["w2"]``, which
produces the values and each row's ``ok`` and which the plane looks up on
every call."""

from __future__ import annotations


def site():
    from vbz_compression_tpu_torch.parallel import sharded

    return sharded._STREAM_DECODERS, "w2"


def _altered(decode):
    def broken(streams, lengths, stream_lens, out_n, flavor):
        out, ok = decode(streams, lengths, stream_lens, out_n, flavor)
        out[0, 0] ^= 1
        return out, ok
    return broken


def _half(decode):
    def broken(streams, lengths, stream_lens, out_n, flavor):
        out, ok = decode(streams, lengths, stream_lens, out_n, flavor)
        half = out.shape[0] // 2
        if half:
            out[half:] = 0
        return out, ok
    return broken


BREAKS = {"answer_altered": _altered, "half_batch_left_out": _half}
