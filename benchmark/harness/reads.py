"""The read set of a configuration, made from the seed.

After the upstream perf harness's ``SignalGenerator``
(nanoporetech/vbz_compression ``vbz/perf/test_data_generator.h:28-74``):
about 100 MB of int16 reads whose lengths are uniform over 30,000-200,000
samples. The content is a squiggle as a pore reports it: a level held for a
dwell of a few samples, then the next, with noise on every sample. Each
sample ends a dwell with chance ``1 / dwell``; each dwell's level is normal
(``level_mean``, ``level_sd``); each sample adds normal noise (``noise_sd``);
the sum is clipped to +-``clip`` and truncated to int16. The deltas are then
the noise's, with a heavy tail where a dwell ends: some of them need
two-byte codes, as real signal's do.

The lengths follow the ``reads`` group's ``lengths`` object, absent or
``{"kind": "even"}`` by default. Its ``kind`` names a file,
``lengths/<kind>.py``, whose ``multiset(spec)`` gives the lengths from the
group (``count``, ``shortest``, ``longest`` and the object's own keys): a
new distribution is a new file. ``even`` spreads them evenly over
``shortest``-``longest``; ``lognormal`` follows a published median and N50
(each file's docstring).

Every seed gets the same multiset of lengths, in an order the seed draws;
the seed also draws the content. So two seeds ask for the same work in
another order. The content is drawn on the run's device by one
``torch.Generator``, piece by piece, each piece the next reads of the
set's order that together hold at most ``PIECE`` samples (a longer read is
a piece alone), so that no float or int64 tensor spans a large set; a set
of at most ``PIECE`` samples, such as upstream's 100 MB, is one piece. A
piece's draw is the whole set's draw made over its samples alone: dwell
ends (uniform, one a sample), then its dwells' levels, then its noise
(normal, one a sample); its first sample starts a dwell.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PIECE = 2**26  # samples a piece holds at most


@dataclasses.dataclass
class ReadSet:
    """``lengths[i]`` samples of read ``i`` at ``values[starts[i]:]``,
    ``values`` a flat int16 tensor on the run's device."""

    lengths: np.ndarray  # int64 [R]
    starts: np.ndarray   # int64 [R]
    values: torch.Tensor  # int16 [sum(lengths)]

    @property
    def count(self) -> int:
        return len(self.lengths)

    def host(self) -> list[np.ndarray]:
        """Each read as a contiguous host int16 array, views of one copy."""
        flat = self.values.cpu().numpy()
        return [flat[s:s + n] for s, n in zip(self.starts, self.lengths)]


def multiset(spec: dict) -> np.ndarray:
    """The multiset of lengths every seed shares: ``multiset(spec)`` of
    ``lengths/<kind>.py`` for ``spec``'s ``lengths`` kind."""
    from .cell import BENCH, load_module

    kind = spec.get("lengths", {"kind": "even"})["kind"]
    path = BENCH / "lengths" / f"{kind}.py"
    if not kind.isidentifier() or not path.is_file():
        raise ValueError(f"no length distribution {kind!r}: no {path.name}")
    return load_module(path).multiset(spec)


def lengths_for(spec: dict, seed: int) -> np.ndarray:
    """The multiset of ``spec``'s lengths in the order ``seed`` draws."""
    order = torch.Generator().manual_seed(seed)
    lengths = multiset(spec)
    return lengths[torch.randperm(len(lengths), generator=order).numpy()]


def pieces(lengths: np.ndarray, piece: int) -> list[tuple[int, int]]:
    """Runs ``[r0, r1)`` of consecutive reads that hold at most ``piece``
    samples each, a longer read alone, covering every read in order."""
    out, r0, held = [], 0, 0
    for r, n in enumerate(lengths.tolist()):
        if r > r0 and held + n > piece:
            out.append((r0, r))
            r0, held = r, 0
        held += n
    if r0 < len(lengths):
        out.append((r0, len(lengths)))
    return out


def _squiggle(spec: dict, total: int, gen: torch.Generator,
              device) -> torch.Tensor:
    """``total`` int16 samples of the squiggle, drawn from ``gen``."""
    ends = torch.rand(total, generator=gen, device=device) < 1.0 / float(
        spec["dwell"])
    dwell_of = torch.cumsum(ends, 0)
    del ends
    levels = torch.randn(int(dwell_of[-1]) + 1 if total else 1, generator=gen,
                         device=device, dtype=torch.float32)
    levels = levels * float(spec["level_sd"]) + float(spec["level_mean"])
    noise = torch.randn(total, generator=gen, device=device,
                        dtype=torch.float32)
    values = noise.mul_(float(spec["noise_sd"])).add_(levels[dwell_of])
    del dwell_of, levels
    clip = float(spec["clip"])
    return values.clamp_(-clip, clip).to(torch.int16)


def make(spec: dict, seed: int, device, piece: int = PIECE) -> ReadSet:
    """The read set of ``spec`` (a configuration's ``reads`` group:
    ``count``, ``shortest``, ``longest``, optionally ``lengths``, ``dwell``,
    ``level_mean``, ``level_sd``, ``noise_sd``, ``clip``) for ``seed``, on
    ``device``, drawn in pieces of at most ``piece`` samples."""
    lengths = lengths_for(spec, seed)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    total = int(lengths.sum())
    gen = torch.Generator(device=device).manual_seed(seed)
    values = torch.empty(total, dtype=torch.int16, device=device)
    for r0, r1 in pieces(lengths, piece):
        a = int(starts[r0])
        b = a + int(lengths[r0:r1].sum())
        values[a:b] = _squiggle(spec, b - a, gen, device)
    return ReadSet(lengths=lengths, starts=starts, values=values)
