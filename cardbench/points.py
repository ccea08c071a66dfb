"""The points a run generates: world coordinates and one value a point."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Points:
    x: np.ndarray       # float64 world coordinates
    y: np.ndarray
    value: np.ndarray   # float32, the reduction's value channel

    def __len__(self) -> int:
        return len(self.x)

    def chunks(self, size: int):
        """[(start, end)] runs of at most `size` points (all of them for
        size <= 0), in order."""
        n = len(self)
        size = n if size <= 0 else int(size)
        return [(a, min(a + size, n)) for a in range(0, n, max(size, 1))]


def rng(seed: int) -> np.random.Generator:
    """The run's generator: any whole number, negative or past 64 bits,
    is a valid seed."""
    return np.random.default_rng(int(seed) & (2 ** 64 - 1))
