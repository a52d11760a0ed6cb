"""Faults planted in the program for the checks' own test: each breaks the
timed path where it produces its answer, and the check must read the run as
not correct.

- ``answer_altered``: one value (decode) or one data byte (encode) of the
  batch's first row flipped as the kernel hands it back;
- ``half_batch_left_out``: the second half of a batch's rows left
  undecoded (zeros); the cells that encode take one read a call.

Both replace the W2 pair in the backend's routing table
(``models.codec._KINDS``), which ``api.decompress``, ``api.compress`` and
the plane reach. Cells of one read a call have no half batch to leave out.
"""

from __future__ import annotations

import contextlib

FAULTS = ("answer_altered", "half_batch_left_out")


def _altered(encode, decode):
    def enc(x, lens, flavor):
        keys, data, data_len = encode(x, lens, flavor)
        data[0, 0] ^= 1
        return keys, data, data_len

    def dec(keys, data, counts, flavor):
        out = decode(keys, data, counts, flavor)
        out[0, 0] ^= 1
        return out
    return enc, dec


def _half(encode, decode):
    def dec(keys, data, counts, flavor):
        out = decode(keys, data, counts, flavor)
        half = out.shape[0] // 2
        if half:
            out[half:] = 0
        return out
    return encode, dec


@contextlib.contextmanager
def planted(name: str):
    from vbz_compression_tpu_torch.models import codec

    encode, decode, per_value = codec._KINDS["w2"]
    make = {"answer_altered": _altered, "half_batch_left_out": _half}[name]
    codec._KINDS["w2"] = (*make(encode, decode), per_value)
    try:
        yield
    finally:
        codec._KINDS["w2"] = (encode, decode, per_value)
