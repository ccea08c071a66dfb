"""
GridConfig — defines the 2-D output grid: bounds, resolution, CRS, tiling.

The port's copy of pcr_tpu/core/grid_config.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

Semantics are cell-exact with the reference (include/pcr/core/grid_config.h,
src/core/grid_config.cpp:7-147): ceil-based dimensions, floor + clamp
world→cell with bbox-inclusive contains, north-up negative cell_size_y,
edge-clamped tile ranges, GDAL geotransform layout.

Adds vectorized `world_to_cell_array` used by both the numpy oracle and the
TPU ingest path (coordinates stay float64 on the host; the device only ever
sees integer cells + float32 sub-cell fractions).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .types import BBox, CRS, NoDataPolicy, Status, StatusCode, TileIndex

__all__ = ["GridConfig"]


@dataclass
class GridConfig:
    # -- Spatial extent ------------------------------------------------------
    bounds: BBox = field(default_factory=BBox)
    crs: CRS = field(default_factory=CRS)

    # -- Resolution ----------------------------------------------------------
    cell_size_x: float = 1.0       # CRS units per cell, X
    cell_size_y: float = -1.0      # typically negative (north-up convention)

    # -- Computed dimensions (call compute_dimensions() after setting above) --
    width: int = 0                 # number of columns
    height: int = 0                # number of rows

    # -- Nodata ----------------------------------------------------------------
    nodata: NoDataPolicy = field(default_factory=NoDataPolicy)

    # -- Tiling (for out-of-core processing) ----------------------------------
    tile_width: int = 4096
    tile_height: int = 4096
    tiles_x: int = 0
    tiles_y: int = 0

    # -- Methods ---------------------------------------------------------------

    def compute_dimensions(self) -> None:
        """Compute width/height/tiles from bounds and cell size
        (reference: grid_config.cpp:7-22)."""
        if not self.bounds.valid():
            self.width = self.height = 0
            self.tiles_x = self.tiles_y = 0
            return
        self.width = int(math.ceil(self.bounds.width() / abs(self.cell_size_x)))
        self.height = int(math.ceil(self.bounds.height() / abs(self.cell_size_y)))
        self.tiles_x = (self.width + self.tile_width - 1) // self.tile_width
        self.tiles_y = (self.height + self.tile_height - 1) // self.tile_height

    # Origin is at (bounds.min_x, bounds.max_y): top-left for north-up grids.
    @property
    def origin_x(self) -> float:
        return self.bounds.min_x

    @property
    def origin_y(self) -> float:
        return self.bounds.max_y

    def world_to_cell(self, wx: float, wy: float):
        """World coord → (col, row), or None if outside the grid bounds
        (reference: grid_config.cpp:24-43 — floor then clamp)."""
        if not self.bounds.contains(wx, wy):
            return None
        col = int(math.floor((wx - self.origin_x) / self.cell_size_x))
        row = int(math.floor((wy - self.origin_y) / self.cell_size_y))
        col = max(0, min(col, self.width - 1))
        row = max(0, min(row, self.height - 1))
        return (col, row)

    def world_to_cell_array(self, wx: np.ndarray, wy: np.ndarray):
        """Vectorized world→cell.

        Returns (col i32, row i32, valid bool) with floor+clamp semantics
        identical to the scalar path. Invalid points get col=row=0.
        """
        wx = np.asarray(wx, dtype=np.float64)
        wy = np.asarray(wy, dtype=np.float64)
        valid = (
            (wx >= self.bounds.min_x) & (wx <= self.bounds.max_x)
            & (wy >= self.bounds.min_y) & (wy <= self.bounds.max_y)
        )
        col = np.floor((wx - self.origin_x) / self.cell_size_x)
        row = np.floor((wy - self.origin_y) / self.cell_size_y)
        # Clamp inside-bbox points to the valid cell range (float edge cases).
        col = np.clip(col, 0, self.width - 1).astype(np.int32)
        row = np.clip(row, 0, self.height - 1).astype(np.int32)
        col = np.where(valid, col, 0).astype(np.int32)
        row = np.where(valid, row, 0).astype(np.int32)
        return col, row, valid

    def fractional_cell_array(self, wx: np.ndarray, wy: np.ndarray):
        """Vectorized fractional cell coordinates (float64) used by glyph
        footprints (reference: glyph_kernels.cu:119-123)."""
        wx = np.asarray(wx, dtype=np.float64)
        wy = np.asarray(wy, dtype=np.float64)
        fcx = (wx - self.origin_x) / self.cell_size_x
        fcy = (wy - self.origin_y) / self.cell_size_y
        return fcx, fcy

    def cell_to_world(self, col: int, row: int):
        """Grid cell → world coord of the cell center
        (reference: grid_config.cpp:45-53)."""
        wx = self.origin_x + (col + 0.5) * self.cell_size_x
        wy = self.origin_y + (row + 0.5) * self.cell_size_y
        return (wx, wy)

    def cell_to_tile(self, col: int, row: int) -> TileIndex:
        return TileIndex(row=row // self.tile_height, col=col // self.tile_width)

    def tile_cell_range(self, idx: TileIndex):
        """Cell range for a tile: (col_start, row_start, col_count, row_count),
        clamped at grid edges (reference: grid_config.cpp:81-91)."""
        col_start = idx.col * self.tile_width
        row_start = idx.row * self.tile_height
        col_count = min(self.tile_width, self.width - col_start)
        row_count = min(self.tile_height, self.height - row_start)
        return (col_start, row_start, col_count, row_count)

    def tile_bounds(self, idx: TileIndex) -> BBox:
        """World-space bbox of a tile (reference: grid_config.cpp:62-79)."""
        col_start, row_start, col_count, row_count = self.tile_cell_range(idx)
        b = BBox()
        b.min_x = self.origin_x + col_start * self.cell_size_x
        b.max_x = self.origin_x + (col_start + col_count) * self.cell_size_x
        # cell_size_y is negative, so top/bottom are swapped
        b.max_y = self.origin_y + row_start * self.cell_size_y
        b.min_y = self.origin_y + (row_start + row_count) * self.cell_size_y
        return b

    def total_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    def total_cells(self) -> int:
        return int(self.width) * int(self.height)

    def gdal_geotransform(self):
        """6-element GDAL-style geotransform
        (reference: grid_config.cpp:93-111)."""
        return [
            self.origin_x, self.cell_size_x, 0.0,
            self.origin_y, 0.0, self.cell_size_y,
        ]

    def validate(self) -> Status:
        """Validate configuration consistency
        (reference: grid_config.cpp:113-145)."""
        if not self.bounds.valid():
            return Status.error(StatusCode.InvalidArgument,
                                "Invalid bounds: max < min")
        if self.cell_size_x == 0.0 or self.cell_size_y == 0.0:
            return Status.error(StatusCode.InvalidArgument,
                                "Cell size cannot be zero")
        if self.tile_width <= 0 or self.tile_height <= 0:
            return Status.error(StatusCode.InvalidArgument,
                                "Tile dimensions must be positive")
        if self.width <= 0 or self.height <= 0:
            return Status.error(
                StatusCode.InvalidArgument,
                "Grid dimensions not computed or invalid. "
                "Call compute_dimensions()")
        if not self.crs.is_valid():
            return Status.error(StatusCode.CrsError, "CRS is not valid")
        return Status.success()

    def __repr__(self) -> str:
        return (f"GridConfig({self.width}x{self.height} cells, "
                f"{self.tiles_x}x{self.tiles_y} tiles, "
                f"cell=({self.cell_size_x}, {self.cell_size_y}))")
