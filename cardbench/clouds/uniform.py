"""
Uniform points over the whole grid with uniform values: the glyph suite's
cloud (bench.py:447-453, which copies the upstream's
benchmark_glyph_full.py), from the run's seed.

params: count, value_lo, value_hi.
"""

from __future__ import annotations

import numpy as np

from ..points import Points, rng


def generate(params: dict, grid, seed: int) -> Points:
    r = rng(seed)
    n = int(params["count"])
    x = grid.min_x + r.random(n) * grid.extent_x
    y = grid.min_y + r.random(n) * grid.extent_y
    v = r.uniform(float(params["value_lo"]), float(params["value_hi"]),
                  n).astype(np.float32)
    return Points(x, y, v)
