"""The point generators: the same seed gives the same points, another seed
other points, and each gives the configuration's size inside its grid."""

from __future__ import annotations

import json

import numpy as np
import pytest

from cardbench import registry
from cardbench.grid import Grid
from cardbench.points import rng


def _config(name, **points):
    cfg = json.load(open(f"{registry.HERE}/configs/{name}.json"))
    cfg["points"].update(points)
    return cfg


@pytest.mark.parametrize("name,count", [("glyph_gauss_s4", 50_000),
                                        ("dc_lidar_point", 490_000)])
def test_a_seed_repeats_its_points(name, count):
    cfg = _config(name, count=count)
    gen = registry.cloud_generator(cfg["points"]["kind"])
    grid = Grid.of(cfg)
    big = 2 ** 31 + 12345
    a, b, c = (gen(cfg["points"], grid, s) for s in (big, big, big + 1))
    for f in ("x", "y", "value"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
        assert not np.array_equal(getattr(a, f), getattr(c, f))
    assert len(a) == len(c)          # every seed the same work
    assert a.x.dtype == np.float64 and a.value.dtype == np.float32
    assert len(a) == count if name == "glyph_gauss_s4" else \
        abs(len(a) - count) <= 49
    _, _, valid = grid.assign(a.x, a.y)
    assert valid.all()


def test_the_lidar_tiles_fill_every_tile_row_and_skew():
    cfg = _config("dc_lidar_point", count=490_000)
    p = registry.cloud_generator("lidar_tiles")(cfg["points"],
                                                Grid.of(cfg), 7)
    grid = Grid.of(cfg)
    col, row, _ = grid.assign(p.x, p.y)
    side = 7
    w = grid.width / side
    tiles = (row // w).astype(int) * side + (col // w).astype(int)
    counts = np.bincount(tiles, minlength=side * side)
    assert (counts.reshape(side, side).sum(axis=1) > 0).all()
    assert counts.max() > 3 * counts.min()         # the power-law core
    cells = np.bincount(row * grid.width + col)
    assert cells.max() >= 10                        # hot clusters stack
    assert 20 < float(p.value.min()) and float(p.value.max()) < 120


def test_seeds_past_64_bits_and_negative_are_seeds():
    assert rng(-1).random() == rng(2 ** 64 - 1).random()
    assert rng(2 ** 70).random() == rng(0).random()
