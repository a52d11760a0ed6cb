"""Faults planted in the program for the checks' own test: each breaks the
timed path where it produces its answer, and the check must read the run as
not correct.

- ``answer_altered``: one value (decode) or one data byte (encode) of the
  batch's first row flipped as the kernel hands it back;
- ``half_batch_left_out``: the second half of a batch's rows left
  undecoded (zeros); the cells that encode take one read a call.

A fault is planted at its entry's site: what produces the answer, swapped
for a broken copy while the fault is planted. An entry names its own site
in ``faults/<entry>.py``: ``site()`` returns ``(mapping, key)``, where the
program looks it up on every call (a module's globals are
``vars(module)``), and ``BREAKS`` maps each name of ``FAULTS`` to a
function that takes what is there and returns it broken. An entry without
such a file has the default site, the W2 pair in the backend's routing
table (``models.codec._KINDS["w2"]``), which ``api.decompress``,
``api.compress`` and the rows-layout plane reach, broken by
``W2_BREAKS``. Cells of one read a call have no half batch to leave out.
"""

from __future__ import annotations

import contextlib

from . import cell as cell_mod

FAULTS = ("answer_altered", "half_batch_left_out")


def _altered(kind):
    encode, decode, per_value = kind

    def enc(x, lens, flavor):
        keys, data, data_len = encode(x, lens, flavor)
        data[0, 0] ^= 1
        return keys, data, data_len

    def dec(keys, data, counts, flavor):
        out = decode(keys, data, counts, flavor)
        out[0, 0] ^= 1
        return out
    return enc, dec, per_value


def _half(kind):
    encode, decode, per_value = kind

    def dec(keys, data, counts, flavor):
        out = decode(keys, data, counts, flavor)
        half = out.shape[0] // 2
        if half:
            out[half:] = 0
        return out
    return encode, dec, per_value


W2_BREAKS = {"answer_altered": _altered, "half_batch_left_out": _half}


@contextlib.contextmanager
def planted(name: str, entry: str):
    """Fault ``name`` planted at ``entry``'s site while the block runs."""
    own = cell_mod.BENCH / "faults" / f"{entry}.py"
    if own.is_file():
        module = cell_mod.load_module(own)
        (mapping, key), breaks = module.site(), module.BREAKS
    else:
        from vbz_compression_tpu_torch.models import codec

        mapping, key, breaks = codec._KINDS, "w2", W2_BREAKS
    original = mapping[key]
    mapping[key] = breaks[name](original)
    try:
        yield
    finally:
        mapping[key] = original
