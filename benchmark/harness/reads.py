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

Every seed gets the same multiset of lengths, an even spread over the range,
in an order the seed draws; the seed also draws the content. So two seeds
ask for the same work in another order. The content is drawn on the run's
device by one ``torch.Generator`` in a few large calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def lengths_of(reads: int, shortest: int, longest: int) -> np.ndarray:
    """The multiset of lengths every seed shares: ``reads`` lengths spread
    evenly over [shortest, longest], the midpoints of equal steps."""
    step = (longest - shortest) / reads
    return (shortest + step * (np.arange(reads) + 0.5)).astype(np.int64)


def make(spec: dict, seed: int, device) -> ReadSet:
    """The read set of ``spec`` (a configuration's ``reads`` group:
    ``count``, ``shortest``, ``longest``, ``dwell``, ``level_mean``,
    ``level_sd``, ``noise_sd``, ``clip``) for ``seed``, on ``device``."""
    order = torch.Generator().manual_seed(seed)
    lengths = lengths_of(spec["count"], spec["shortest"], spec["longest"])
    lengths = lengths[torch.randperm(len(lengths), generator=order).numpy()]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    total = int(lengths.sum())
    gen = torch.Generator(device=device).manual_seed(seed)
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
    values = values.clamp_(-clip, clip).to(torch.int16)
    return ReadSet(lengths=lengths, starts=starts, values=values)
