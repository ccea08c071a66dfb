"""
Glyph types — how a point's value is splatted onto the raster.

The port's copy of pcr_tpu/engine/glyph.py. Its imports are the
port's own; nothing in it imports pcr_tpu or jax.

Mirrors the reference (include/pcr/engine/glyph.h:11-42).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..core.types import ReductionType

__all__ = ["GlyphType", "GlyphSpec", "GLYPH_SUPPORTED_REDUCTIONS"]


class GlyphType(enum.IntEnum):
    Point = 0      # 1-cell scatter (no overhead, default)
    Line = 1       # direction + half_length → Bresenham line segment
    Gaussian = 2   # sigma_x, sigma_y, rotation → Gaussian kernel footprint


# Glyph splatting only supports these reductions
# (reference: glyph_kernels.cu:298-305, pipeline.cpp:499-507).
GLYPH_SUPPORTED_REDUCTIONS = frozenset({
    ReductionType.WeightedAverage,
    ReductionType.Average,
    ReductionType.Sum,
    ReductionType.Count,
})


@dataclass
class GlyphSpec:
    """Per-reduction glyph configuration (reference: glyph.h:20-42).

    Channel names reference Float32 channels in the PointCloud. If a channel
    name is empty or absent, the default_ value is used. Per-point values
    <= 0 in sigma channels also fall back to the defaults
    (glyph_kernels.cu:126-130).
    """

    type: GlyphType = GlyphType.Point

    # --- Line params ---
    direction_channel: str = ""
    default_direction: float = 0.0     # radians (0 = East/+X, pi/2 = North/+Y)
    half_length_channel: str = ""
    default_half_length: float = 1.0   # world units

    # --- Gaussian params ---
    sigma_x_channel: str = ""
    default_sigma_x: float = 1.0       # world units
    sigma_y_channel: str = ""
    default_sigma_y: float = 1.0       # world units
    rotation_channel: str = ""
    default_rotation: float = 0.0      # radians

    # --- Safety cap ---
    # Clamp footprint to this many cells in each direction.
    max_radius_cells: float = 32.0

    # Accepted but not applied, matching the reference
    # (glyph_kernels.cu:169-175: "normalize_weights is a future feature").
    normalize_weights: bool = False

    def __repr__(self) -> str:
        return (f"GlyphSpec({GlyphType(self.type).name}, "
                f"max_radius={self.max_radius_cells})")
