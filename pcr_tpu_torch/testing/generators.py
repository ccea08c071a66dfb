"""
Synthetic point-cloud generators with analytically known rasters.

The port's copy of pcr_tpu/testing/generators.py, on the port's own core
types.

Capability rebuild of the reference's pure-Python test-data library
(python/pcr/test_generators.py: checkerboard / stripes / bullseye /
gradient / uniform_grid / gaussian_clusters / planar_surface /
edge_cases). Each generator returns (PointCloud, expected) where
`expected` is the exact raster a given reduction should produce, so
correctness checks need no reference implementation.

All generators keep points strictly inside the bbox by an epsilon margin
(the reference's _safe_uniform trick, test_generators.py:17-24) so
edge-clamping never shifts a point's cell.
"""

from __future__ import annotations

import numpy as np

from ..core.grid_config import GridConfig
from ..core.point_cloud import PointCloud
from ..core.types import BBox, CRS, DataType

__all__ = [
    "make_grid_config", "generate_checkerboard", "generate_stripes",
    "generate_gradient", "generate_bullseye", "generate_uniform_grid",
    "generate_gaussian_clusters", "generate_planar_surface",
    "generate_edge_cases", "generate_text", "generate_shapes",
]

_EPS = 1e-6


def make_grid_config(width=100, height=100, cell=1.0, tile=4096,
                     epsg=3857) -> GridConfig:
    bbox = BBox()
    bbox.min_x, bbox.min_y = 0.0, 0.0
    bbox.max_x, bbox.max_y = width * cell, height * cell
    gc = GridConfig()
    gc.bounds = bbox
    gc.cell_size_x = cell
    gc.cell_size_y = -cell
    gc.tile_width = tile
    gc.tile_height = tile
    gc.crs = CRS.from_epsg(epsg)
    gc.compute_dimensions()
    return gc


def _safe_uniform(rng, lo, hi, n):
    """Uniform samples strictly inside (lo, hi)."""
    span = hi - lo
    return lo + span * _EPS + rng.random(n) * span * (1.0 - 2.0 * _EPS)


def _cloud(x, y, values, value_channel="value"):
    n = len(x)
    c = PointCloud.create(n)
    c.set_x_array(np.asarray(x, np.float64))
    c.set_y_array(np.asarray(y, np.float64))
    c.add_channel(value_channel, DataType.Float32)
    c.set_channel_array_f32(value_channel,
                            np.asarray(values, np.float32))
    return c


def _cell_centers(gc: GridConfig, cols, rows):
    """World coords of cell centers for (col, row) index arrays."""
    x = gc.origin_x + (cols + 0.5) * gc.cell_size_x
    y = gc.origin_y + (rows + 0.5) * gc.cell_size_y
    return x, y


def generate_uniform_grid(gc: GridConfig, points_per_cell=1, value=1.0,
                          seed=0):
    """Exactly `points_per_cell` points at every cell center.

    Expected raster (any of Sum/Average/Count/Max/Min) is uniform."""
    rng = np.random.default_rng(seed)
    H, W = gc.height, gc.width
    rows, cols = np.mgrid[0:H, 0:W]
    cols = np.tile(cols.ravel(), points_per_cell)
    rows = np.tile(rows.ravel(), points_per_cell)
    x, y = _cell_centers(gc, cols, rows)
    vals = np.full(len(x), value, np.float32)
    expected = {
        "sum": np.full((H, W), value * points_per_cell, np.float32),
        "average": np.full((H, W), value, np.float32),
        "count": np.full((H, W), float(points_per_cell), np.float32),
        "max": np.full((H, W), value, np.float32),
        "min": np.full((H, W), value, np.float32),
    }
    return _cloud(x, y, vals), expected


def generate_checkerboard(gc: GridConfig, square=8, lo=0.0, hi=1.0,
                          points_per_cell=2, seed=0):
    """Checkerboard of `square`-cell squares; every cell gets
    points_per_cell identical samples at its center, so Average is exactly
    the board value."""
    rng = np.random.default_rng(seed)
    H, W = gc.height, gc.width
    rows, cols = np.mgrid[0:H, 0:W]
    board = (((rows // square) + (cols // square)) % 2).astype(np.float32)
    board = lo + (hi - lo) * board
    cols_r = np.tile(cols.ravel(), points_per_cell)
    rows_r = np.tile(rows.ravel(), points_per_cell)
    x, y = _cell_centers(gc, cols_r, rows_r)
    vals = np.tile(board.ravel(), points_per_cell)
    return _cloud(x, y, vals), board


def generate_stripes(gc: GridConfig, period=10, horizontal=False,
                     lo=0.0, hi=1.0):
    """Alternating value stripes of `period` cells."""
    H, W = gc.height, gc.width
    rows, cols = np.mgrid[0:H, 0:W]
    axis = rows if horizontal else cols
    img = (((axis // period) % 2).astype(np.float32)) * (hi - lo) + lo
    x, y = _cell_centers(gc, cols.ravel(), rows.ravel())
    return _cloud(x, y, img.ravel()), img


def generate_gradient(gc: GridConfig, direction="x"):
    """Linear gradient: value = normalized col (or row) of the cell."""
    H, W = gc.height, gc.width
    rows, cols = np.mgrid[0:H, 0:W]
    if direction == "x":
        img = (cols / max(W - 1, 1)).astype(np.float32)
    else:
        img = (rows / max(H - 1, 1)).astype(np.float32)
    x, y = _cell_centers(gc, cols.ravel(), rows.ravel())
    return _cloud(x, y, img.ravel()), img


def generate_bullseye(gc: GridConfig, rings=5):
    """Concentric rings of alternating value around the grid center."""
    H, W = gc.height, gc.width
    rows, cols = np.mgrid[0:H, 0:W]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    rad = np.sqrt((rows - cy) ** 2 + (cols - cx) ** 2)
    ring_w = max(H, W) / (2.0 * rings)
    img = ((rad // ring_w) % 2).astype(np.float32)
    x, y = _cell_centers(gc, cols.ravel(), rows.ravel())
    return _cloud(x, y, img.ravel()), img


def generate_planar_surface(gc: GridConfig, a=0.01, b=-0.02, c=5.0,
                            points_per_cell=3, jitter=0.3, seed=0):
    """Points sampled on the plane z = a*wx + b*wy + c with sub-cell jitter.

    Expected Average raster evaluates the plane at each sample's own
    location averaged per cell — returned exactly (computed from the
    samples), plus the plane evaluated at centers for approximate checks."""
    rng = np.random.default_rng(seed)
    H, W = gc.height, gc.width
    n = H * W * points_per_cell
    rows = np.tile(np.mgrid[0:H, 0:W][0].ravel(), points_per_cell)
    cols = np.tile(np.mgrid[0:H, 0:W][1].ravel(), points_per_cell)
    cx, cy = _cell_centers(gc, cols, rows)
    jx = (rng.random(n) - 0.5) * jitter * abs(gc.cell_size_x)
    jy = (rng.random(n) - 0.5) * jitter * abs(gc.cell_size_y)
    x = cx + jx
    y = cy + jy
    z = (a * x + b * y + c).astype(np.float32)
    # exact per-cell average of the sampled z values
    acc = np.zeros((H, W), np.float64)
    cnt = np.zeros((H, W), np.float64)
    np.add.at(acc, (rows, cols), z.astype(np.float64))
    np.add.at(cnt, (rows, cols), 1.0)
    expected_avg = (acc / cnt).astype(np.float32)
    return _cloud(x, y, z), expected_avg


def generate_gaussian_clusters(gc: GridConfig, n_clusters=5,
                               points_per_cluster=2000, sigma_cells=3.0,
                               seed=0):
    """Gaussian point clusters (no analytic raster; returns cluster
    centers for structural checks)."""
    rng = np.random.default_rng(seed)
    H, W = gc.height, gc.width
    centers_col = rng.uniform(0.2 * W, 0.8 * W, n_clusters)
    centers_row = rng.uniform(0.2 * H, 0.8 * H, n_clusters)
    xs, ys, vs = [], [], []
    for i in range(n_clusters):
        c = rng.normal(centers_col[i], sigma_cells, points_per_cluster)
        r = rng.normal(centers_row[i], sigma_cells, points_per_cluster)
        keep = (c >= 0) & (c < W) & (r >= 0) & (r < H)
        x, y = _cell_centers(gc, c[keep], r[keep])
        xs.append(x)
        ys.append(y)
        vs.append(np.full(keep.sum(), float(i + 1), np.float32))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    v = np.concatenate(vs)
    return _cloud(x, y, v), list(zip(centers_col, centers_row))


def generate_edge_cases(gc: GridConfig):
    """Points exactly on bbox corners/edges plus out-of-bounds points.

    Expected: in-bounds points land in clamped edge cells; the two
    out-of-bounds points are dropped. Returns (cloud, expected_count)."""
    b = gc.bounds
    x = np.array([b.min_x, b.max_x, b.min_x, b.max_x,
                  (b.min_x + b.max_x) / 2,
                  b.min_x - 1.0, b.max_x + 1.0])
    y = np.array([b.min_y, b.min_y, b.max_y, b.max_y,
                  (b.min_y + b.max_y) / 2,
                  (b.min_y + b.max_y) / 2, b.max_y + 1.0])
    vals = np.ones(len(x), np.float32)
    H, W = gc.height, gc.width
    expected = np.full((H, W), np.nan, np.float32)
    for xi, yi in zip(x, y):
        cell = gc.world_to_cell(xi, yi)
        if cell is not None:
            c, r = cell
            expected[r, c] = (expected[r, c] + 1.0
                              if np.isfinite(expected[r, c]) else 1.0)
    return _cloud(x, y, vals), expected


# 5x5 block font for generate_text (original glyph set; reference ships a
# 3-letter font, test_generators.py:352-375 — this one covers A-Z subset
# plus digits 0/1, unknown characters render blank)
_FONT = {
    "A": ["01110", "10001", "11111", "10001", "10001"],
    "B": ["11110", "10001", "11110", "10001", "11110"],
    "C": ["01111", "10000", "10000", "10000", "01111"],
    "E": ["11111", "10000", "11110", "10000", "11111"],
    "F": ["11111", "10000", "11110", "10000", "10000"],
    "G": ["01111", "10000", "10011", "10001", "01110"],
    "H": ["10001", "10001", "11111", "10001", "10001"],
    "I": ["11111", "00100", "00100", "00100", "11111"],
    "L": ["10000", "10000", "10000", "10000", "11111"],
    "N": ["10001", "11001", "10101", "10011", "10001"],
    "O": ["01110", "10001", "10001", "10001", "01110"],
    "P": ["11110", "10001", "11110", "10000", "10000"],
    "R": ["11110", "10001", "11110", "10010", "10001"],
    "S": ["01111", "10000", "01110", "00001", "11110"],
    "T": ["11111", "00100", "00100", "00100", "00100"],
    "U": ["10001", "10001", "10001", "10001", "01110"],
    "X": ["10001", "01010", "00100", "01010", "10001"],
    "0": ["01110", "10011", "10101", "11001", "01110"],
    "1": ["00100", "01100", "00100", "00100", "01110"],
    " ": ["00000", "00000", "00000", "00000", "00000"],
}


def generate_text(gc: GridConfig, text="PCR", value_text=100.0,
                  value_background=0.0, points_per_cell=1):
    """Block-letter text centered in the raster (reference
    test_generators.py:314-427: 5x5 letters, 2-cell spacing, points per
    cell carry text/background values). Expected raster is exact."""
    H, W = gc.height, gc.width
    img = np.full((H, W), np.float32(value_background))
    lw, lh, sp = 5, 5, 2
    total_w = len(text) * lw + (len(text) - 1) * sp
    r0 = max(0, (H - lh) // 2)
    c0 = max(0, (W - total_w) // 2)
    for i, ch in enumerate(text.upper()):
        pat = _FONT.get(ch)
        if pat is None:
            continue
        for r in range(lh):
            for c in range(lw):
                rr, cc = r0 + r, c0 + i * (lw + sp) + c
                if pat[r][c] == "1" and 0 <= rr < H and 0 <= cc < W:
                    img[rr, cc] = value_text
    rows, cols = np.mgrid[0:H, 0:W]
    cols_r = np.tile(cols.ravel(), points_per_cell)
    rows_r = np.tile(rows.ravel(), points_per_cell)
    x, y = _cell_centers(gc, cols_r, rows_r)
    vals = np.tile(img.ravel(), points_per_cell)
    return _cloud(x, y, vals), img


def generate_shapes(gc: GridConfig, shape="circle", value_inside=100.0,
                    value_outside=0.0, points_per_cell=1):
    """Filled geometric shape over a background (reference
    test_generators.py:429-500: circle r=0.7 / square s=0.7 / upward
    triangle, coordinates normalized to [-1, 1]). Expected raster exact
    (classified at cell centers)."""
    H, W = gc.height, gc.width
    rows, cols = np.mgrid[0:H, 0:W]
    x_c, y_c = _cell_centers(gc, cols.ravel(), rows.ravel())
    b = gc.bounds
    nx = 2.0 * (x_c - (b.min_x + b.max_x) / 2) / (b.max_x - b.min_x)
    ny = 2.0 * (y_c - (b.min_y + b.max_y) / 2) / (b.max_y - b.min_y)
    if shape == "circle":
        inside = np.sqrt(nx ** 2 + ny ** 2) <= 0.7
    elif shape == "square":
        inside = (np.abs(nx) <= 0.7) & (np.abs(ny) <= 0.7)
    elif shape == "triangle":
        inside = (ny <= 0.5) & (ny >= -0.8 * np.abs(nx) + 0.5)
    else:
        raise ValueError(f"unknown shape: {shape!r}")
    img = np.where(inside.reshape(H, W), np.float32(value_inside),
                   np.float32(value_outside))
    cols_r = np.tile(cols.ravel(), points_per_cell)
    rows_r = np.tile(rows.ravel(), points_per_cell)
    x, y = _cell_centers(gc, cols_r, rows_r)
    vals = np.tile(img.ravel(), points_per_cell)
    return _cloud(x, y, vals), img
