"""The port's Gaussian glyph on clustered LiDAR against the benchmark's plain
reference (cardbench/glyphs/gaussian.py), on the CPU (PCR_TORCH_DEVICE=cpu:
K2's plain version): the DC LiDAR Gaussian run (sigma 3 m, a cap of 32
cells, so r = 9; a WeightedAverage of the return height z) at a CPU's
size.

The points are the benchmark's own `lidar_tiles` cloud at skew 0.5 on a
north-up 512 x 512 grid of 1 m cells in 128-cell tiles: the hot clusters
pile up to ~500 terms into a cell (ten times the mean) and the home-tile
clip cuts every window that crosses a tile's edge. Each route is compared
cell by cell with the reference: the staged route (Pipeline.stage, the
device layout), the same with the layout's entry budget cut so that the
cloud is several K2 chunks (a 20M job on the card is two), a
host-sourced ingest by the device layout and by the host layout
(PCR_WIRE_CHEAP=0), and the numpy oracle (CPU mode).

Tolerance, cell by cell: the port adds a cell's K positive float32 terms
in an order of its own, and the reference in float64; the error of such a
sum has a standard deviation of about sqrt(K) 2^-24 relative, so 8 of
those, never under the repository's 1e-5 (chip_smoke.py's `cell_rtol`).
K is bounded by the points whose cell lies within r cells of the cell on
both axes. A window one cell off or a clip missed moves a cell by a whole
term, far past it. The NaN footprint must be the same.
"""

import ast

import numpy as np
import pytest

import pcr_tpu_torch as pcr
from cardbench.clouds import lidar_tiles
from cardbench.glyphs import gaussian
from cardbench.grid import Grid

SIZE, TILE, R = 512, 128, 9
RED = {"glyph": "gaussian", "type": "WeightedAverage", "value_channel": "z",
       "sigma_x": 3.0, "sigma_y": 3.0, "max_radius_cells": 32.0}
GRID = Grid(389000.0, 124000.0, float(SIZE), float(SIZE), 1.0, 32110, TILE)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("PCR_TORCH_DEVICE", "cpu")


def points(seed=0, n=40_000):
    return lidar_tiles.generate({"count": n, "tiles": 49, "skew": 0.5},
                                GRID, seed)


def pipeline(mode="GPU"):
    g = GRID
    b = pcr.BBox()
    b.min_x, b.min_y, b.max_x, b.max_y = g.min_x, g.min_y, g.max_x, g.max_y
    gc = pcr.GridConfig(bounds=b, cell_size_x=g.cell, cell_size_y=-g.cell,
                        tile_width=g.tile, tile_height=g.tile,
                        crs=pcr.CRS.from_epsg(g.epsg))
    gc.compute_dimensions()
    c = pcr.PipelineConfig()
    c.grid = gc
    c.reductions = [gaussian.spec(pcr, RED)]
    c.exec_mode = getattr(pcr.ExecutionMode, mode)
    return pcr.Pipeline.create(c)


def cloud(pts):
    c = pcr.PointCloud.create(len(pts))
    c.set_x_array(pts.x)
    c.set_y_array(pts.y)
    c.add_channel("z", pcr.DataType.Float32)
    c.set_channel_array_f32("z", pts.value)
    c.set_crs(pcr.CRS.from_epsg(GRID.epsg))
    return c


def band(pts, mode="GPU", staged=False):
    p = pipeline(mode)
    c = cloud(pts)
    p.ingest(p.stage(c) if staged else c)
    p.finalize()
    return np.asarray(p.result().band_array(0))


def cell_rtol(pts):
    """8 sqrt(K) 2^-24 a cell, never under 1e-5: K the points whose cell
    lies within R cells of it on both axes, by a box sum of the cells'
    histogram."""
    col, row, ok = GRID.assign(pts.x, pts.y)
    H, W, k = GRID.height, GRID.width, 2 * R + 1
    hist = np.bincount(row[ok] * W + col[ok], minlength=H * W).reshape(H, W)
    cs = np.pad(hist, ((R + 1, R), (R + 1, R))).cumsum(0).cumsum(1)
    terms = cs[k:, k:] - cs[:-k, k:] - cs[k:, :-k] + cs[:-k, :-k]
    return np.maximum(1e-5, 8.0 * np.sqrt(terms) * 2.0 ** -24), terms


def assert_close(got, pts):
    want = gaussian.reference(pts, GRID, RED, "cpu").numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    both = ~np.isnan(want)
    assert both.sum() > 0.5 * want.size
    rtol, terms = cell_rtol(pts)
    assert terms.max() > 5 * terms.mean()    # the clusters' deep stacks
    err = np.abs(got[both] - want[both]) / np.abs(want[both])
    assert (err <= rtol[both]).all(), (err / rtol[both]).max()


def _staged(pts, monkeypatch):
    return band(pts, staged=True)


def _staged_chunks(pts, monkeypatch):
    from pcr_tpu_torch.engine import torch_backend
    monkeypatch.setattr(torch_backend, "WIRE_ENTRY_BUDGET", 1 << 15)
    p = pipeline()
    staged = p.stage(cloud(pts))
    assert len(staged.per_spec[0]) > 2
    p.ingest(staged)
    p.finalize()
    return np.asarray(p.result().band_array(0))


def _host_sourced(pts, monkeypatch):
    return band(pts)


def _host_layout(pts, monkeypatch):
    monkeypatch.setenv("PCR_WIRE_CHEAP", "0")
    return band(pts)


def _oracle(pts, monkeypatch):
    return band(pts, mode="CPU")


ROUTES = {"staged": _staged, "staged_chunks": _staged_chunks,
          "host_sourced": _host_sourced, "host_layout": _host_layout,
          "oracle": _oracle}


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 7])
@pytest.mark.parametrize("route", list(ROUTES))
def test_the_port_is_the_reference(route, seed, monkeypatch):
    pts = points(seed)
    assert_close(ROUTES[route](pts, monkeypatch), pts)


def test_the_staged_chunks_are_k2_with_r_9():
    """sigma 3 m on 1 m cells: r = ceil(3 x 3) = 9, K2 (the separable
    splat, with factor tables up to r = 13) and not K5 / K4; its tiles are
    64 x 128, so a point's window meets at most 2 x 2 of them."""
    p = pipeline()
    chunks = p.stage(cloud(points())).per_spec[0]
    assert chunks and {c.kind for c in chunks} == {"gauss"}
    assert {(c.rmax, c.th, c.wt, c.cut) for c in chunks} == \
        {(R, 64, 128, False)}
    entries = sum(c.walk[0] for c in chunks)
    assert 40_000 < entries < 4 * 40_000     # halo copies


def test_the_reference_needs_nothing_of_the_port_or_jax():
    """cardbench/glyphs/gaussian.py imports numpy, torch and the harness's
    own modules: neither the port nor JAX."""
    tree = ast.parse(open(gaussian.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    assert names <= {"__future__", "math", "numpy", "torch", "."}
