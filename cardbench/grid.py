"""
The grid of a configuration, and world -> cell as the port's GridConfig
defines it (floor, then clamp, bounds inclusive; north-up, so rows count
down from the top edge). A frozen copy of those semantics
(pcr_tpu_torch/core/grid_config.py: compute_dimensions,
world_to_cell_array, fractional_cell_array, tile_cell_range), so the
reference needs nothing of the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Grid:
    min_x: float
    min_y: float
    extent_x: float
    extent_y: float
    cell: float
    epsg: int
    tile: int

    @staticmethod
    def of(config: dict) -> "Grid":
        g = config["grid"]
        return Grid(float(g["min_x"]), float(g["min_y"]),
                    float(g["extent_x"]), float(g["extent_y"]),
                    float(g["cell"]), int(g["epsg"]), int(g["tile"]))

    @property
    def max_x(self) -> float:
        return self.min_x + self.extent_x

    @property
    def max_y(self) -> float:
        return self.min_y + self.extent_y

    @property
    def width(self) -> int:
        return int(math.ceil(self.extent_x / self.cell))

    @property
    def height(self) -> int:
        return int(math.ceil(self.extent_y / self.cell))

    def fractional(self, x: np.ndarray, y: np.ndarray):
        """Fractional (column, row) of world points, float64; the origin is
        the top-left corner (min_x, max_y) and rows grow southward."""
        return (x - self.min_x) / self.cell, (y - self.max_y) / -self.cell

    def assign(self, x: np.ndarray, y: np.ndarray):
        """(col, row, valid): the cell of each point, floor then clamp;
        points outside the inclusive bounds are invalid."""
        valid = ((x >= self.min_x) & (x <= self.max_x)
                 & (y >= self.min_y) & (y <= self.max_y))
        fc, fr = self.fractional(x, y)
        col = np.clip(np.floor(fc), 0, self.width - 1).astype(np.int64)
        row = np.clip(np.floor(fr), 0, self.height - 1).astype(np.int64)
        return col, row, valid

    def home_tile(self, col: np.ndarray, row: np.ndarray):
        """End-exclusive cell ranges (c0, r0, c1, r1) of each cell's tile."""
        c0 = col // self.tile * self.tile
        r0 = row // self.tile * self.tile
        return (c0, r0, np.minimum(c0 + self.tile, self.width),
                np.minimum(r0 + self.tile, self.height))
