"""The port's Line glyph against the benchmark's plain reference
(cardbench/glyphs/line.py), on the CPU (PCR_TORCH_DEVICE=cpu: K3's plain
version).

The reference walks the upstream's dual-step Bresenham steps cell by cell
in float64; the port folds the closed-form staircase of runs (K3) or, in
CPU mode, walks in numpy and adds in float32. So the comparison also holds
the port's decomposition into runs, its home-tile clips and its halo
copies: a north-up grid of 96 x 80 cells in 32-cell tiles, hl 16 at five
headings and one half length past the cap, ~3000 seeded points, by every
route (staged, host-sourced by the device layout and by the host layout,
and the numpy oracle).

Tolerance: 1e-5 relative a cell. The port adds ~45 values in [0, 1) a cell
in float32 (a relative error of a few 1e-7) and divides by an exact
count; a stroke off by one cell moves a cell's mean by a whole term, 1e-2
or more. The NaN footprint (the cells no stroke reaches) must be the same.
"""

import math

import numpy as np
import pytest

import pcr_tpu_torch as pcr
from cardbench.glyphs import line
from cardbench.grid import Grid
from cardbench.points import Points

W, H, TILE = 96, 80, 32
RTOL = 1e-5
DIRECTIONS = {"30deg": math.pi / 6, "0": 0.0, "0.7": 0.7,
              "90deg": math.pi / 2, "150deg": 5 * math.pi / 6}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")


def red(direction=math.pi / 6, half_length=16.0, cap=32.0):
    return {"glyph": "line", "type": "WeightedAverage",
            "value_channel": "v", "direction": direction,
            "half_length": half_length, "max_radius_cells": cap}


def grid(tile=TILE, w=W, h=H):
    return Grid(0.0, 0.0, float(w), float(h), 1.0, 3857, tile)


def points(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return Points(rng.uniform(-4, W + 4, n), rng.uniform(-4, H + 4, n),
                  rng.uniform(0, 1, n).astype(np.float32))


def port(g, r, pts, mode="GPU", staged=False):
    """The port's band of `pts` under the reduction `r` on `g`."""
    b = pcr.BBox()
    b.min_x, b.min_y, b.max_x, b.max_y = g.min_x, g.min_y, g.max_x, g.max_y
    gc = pcr.GridConfig(bounds=b, cell_size_x=g.cell, cell_size_y=-g.cell,
                        tile_width=g.tile, tile_height=g.tile,
                        crs=pcr.CRS.from_epsg(g.epsg))
    gc.compute_dimensions()
    c = pcr.PipelineConfig()
    c.grid = gc
    c.reductions = [line.spec(pcr, r)]
    c.exec_mode = getattr(pcr.ExecutionMode, mode)
    p = pcr.Pipeline.create(c)
    cloud = pcr.PointCloud.create(len(pts))
    cloud.set_x_array(pts.x)
    cloud.set_y_array(pts.y)
    cloud.add_channel("v", pcr.DataType.Float32)
    cloud.set_channel_array_f32("v", pts.value)
    cloud.set_crs(pcr.CRS.from_epsg(g.epsg))
    p.ingest(p.stage(cloud) if staged else cloud)
    p.finalize()
    return np.asarray(p.result().band_array(0))


def assert_close(got, want):
    want = want.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    both = ~np.isnan(want)
    assert both.sum() > 0.5 * want.size
    np.testing.assert_allclose(got[both], want[both], rtol=RTOL, atol=0)


ROUTES = {"staged": dict(staged=True), "host_sourced": {},
          "host_layout": {}, "oracle": dict(mode="CPU")}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("heading", list(DIRECTIONS))
def test_the_port_is_the_reference(heading, route, monkeypatch):
    if route == "host_layout":
        monkeypatch.setenv("PCR_WIRE_CHEAP", "0")
    r, g, pts = red(DIRECTIONS[heading]), grid(), points()
    assert_close(port(g, r, pts, **ROUTES[route]),
                 line.reference(pts, g, r, "cpu"))


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_half_length_past_the_cap_is_clamped(route, monkeypatch):
    """hl 40 m with a cap of 24 cells at heading 0.7: hx clamps to 24, and
    hy = min(-40, 24) stays -40 on a north-up grid (the upstream's signed
    cap). From (40.5, 39.5), ex = 24 cos 0.7 = 18.36 and ey = -40 sin 0.7
    = -25.77: the ends round to (22, 65) and (59, 14), where a cap of 64
    gives (10, 65) and (71, 14)."""
    if route == "host_layout":
        monkeypatch.setenv("PCR_WIRE_CHEAP", "0")
    r, g = red(0.7, half_length=40.0, cap=24.0), grid()
    one = Points(np.array([40.5]), np.array([40.5]), np.ones(1, np.float32))
    assert np.array_equal(line.endpoints(one, g, r),
                          ([22], [65], [59], [14]))
    wide = dict(r, max_radius_cells=64.0)
    assert np.array_equal(line.endpoints(one, g, wide),
                          ([10], [65], [71], [14]))
    pts = points(seed=3)
    assert_close(port(g, r, pts, **ROUTES[route]),
                 line.reference(pts, g, r, "cpu"))


def test_one_stroke_at_30_degrees_cell_by_cell():
    """One point at (40.5, 40.5) on a one-tile 96 x 80 grid, hl 16 m,
    heading pi / 6: fractional cell (40.5, 39.5), hx = 16, hy = -16, cos =
    0.86602539 (float32), sin = 0.5; the ends (40.5 -+ 13.856, 39.5 -+ 8)
    round half away from zero to (27, 48) and (54, 32), so ddx = 27, ddy =
    16 and err starts at 11. Each step moves a column, and a row up where
    2 err < 27: 28 cells in 17 rows, runs of 1 and 2 cells, ending in
    (54, 32). The point's own cell (40, 39) is not on it: both ends round
    half a row south."""
    runs = [(48, 27, 27), (47, 28, 29), (46, 30, 31), (45, 32, 32),
            (44, 33, 34), (43, 35, 36), (42, 37, 37), (41, 38, 39),
            (40, 40, 41), (39, 42, 43), (38, 44, 44), (37, 45, 46),
            (36, 47, 48), (35, 49, 49), (34, 50, 51), (33, 52, 53),
            (32, 54, 54)]
    want = np.full((H, W), np.nan, np.float32)
    for row, a, b in runs:
        want[row, a:b + 1] = 0.25
    assert np.isfinite(want).sum() == 28
    g, r = grid(tile=4096), red()
    pts = Points(np.array([40.5]), np.array([40.5]),
                 np.array([0.25], np.float32))
    assert np.array_equal(line.endpoints(pts, g, r),
                          ([27], [48], [54], [32]))
    ref = line.reference(pts, g, r, "cpu").numpy()
    np.testing.assert_array_equal(ref, want)
    for route in ("staged", "oracle"):
        np.testing.assert_array_equal(port(g, r, pts, **ROUTES[route]), want)


def test_the_home_tile_cuts_a_stroke():
    """The same stroke on 32-cell tiles: the point's cell (40, 39) lies in
    the tile of rows 32-63 and columns 32-63, so the cells left of column
    32 (five: columns 27-31 of rows 48-46) are dropped and the rest is
    kept (rows 32-48 are all in it)."""
    g, r = grid(), red()
    pts = Points(np.array([40.5]), np.array([40.5]),
                 np.array([0.25], np.float32))
    ref = line.reference(pts, g, r, "cpu").numpy()
    whole = line.reference(pts, grid(tile=4096), r, "cpu").numpy()
    kept = np.isfinite(whole)
    kept[:, :32] = False
    assert np.array_equal(np.isfinite(ref), kept)
    assert np.isfinite(ref).sum() == 28 - 5
    np.testing.assert_array_equal(port(g, r, pts, staged=True), ref)


def test_the_reference_needs_nothing_of_the_port_or_jax():
    """cardbench/glyphs/line.py imports numpy, torch and the harness's own
    modules: neither the port nor JAX."""
    import ast
    tree = ast.parse(open(line.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    assert names <= {"__future__", "sys", "numpy", "torch", "."}
