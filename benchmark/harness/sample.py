"""A reservoir sample of a window's answers, drawn from the seed: the check
compares these once the window has closed. Every answer has the same
chance to be kept, however long the window runs, and the memory held is
bounded, so the window frees what it does not keep, as a reader would."""

from __future__ import annotations

import numpy as np


class Reservoir:
    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.items: list = []
        self.seen = 0

    def add(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1
