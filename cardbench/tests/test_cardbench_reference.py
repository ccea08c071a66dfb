"""The plain reference: rasters worked by hand, the port's device path on
torch-CPU at small sizes within each configuration's limits, and the
control (the reference in bfloat16) outside them."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from cardbench import compare, registry
from cardbench.grid import Grid
from cardbench.points import Points

NAN = float("nan")


def _config(glyph, size, **red):
    cfg = {"grid": {"min_x": 0.0, "min_y": 0.0, "extent_x": float(size),
                    "extent_y": float(size), "cell": 1.0, "epsg": 3857,
                    "tile": 4096},
           "reductions": [dict({"glyph": glyph, "type": "Average",
                                "value_channel": "v"}, **red)]}
    return cfg


def _ref(points, cfg, **kw):
    red = cfg["reductions"][0]
    return registry.glyph(red["glyph"]).reference(points, Grid.of(cfg), red,
                                                  "cpu", **kw)


def test_point_average_by_hand():
    p = Points(np.array([0.5, 0.7, 2.2, 4.0, 5.0]),
               np.array([3.5, 3.9, 0.1, 0.0, 5.0]),
               np.array([1, 3, 5, 7, 9], np.float32))
    got = _ref(p, _config("point", 4))
    want = np.full((4, 4), NAN)
    want[0, 0] = 2.0     # two points in the top-left cell: (1 + 3) / 2
    want[3, 2] = 5.0
    want[3, 3] = 7.0     # the corner (4, 0) clamps into the last cell
    assert np.array_equal(got.numpy(), want, equal_nan=True)


def test_gaussian_average_by_hand():
    cfg = _config("gaussian", 9, sigma_x=1.0, sigma_y=1.0,
                  max_radius_cells=32.0)
    p = Points(np.array([4.5, 5.5]), np.array([4.5, 4.5]),
               np.array([1, 3], np.float32))
    got = _ref(p, cfg).numpy()
    # r = 3: the windows cover columns 1..8 and rows 1..7
    assert np.isnan(got[:, 0]).all() and np.isnan(got[0]).all()
    assert np.isnan(got[8]).all() and not np.isnan(got[1:8, 1:]).any()
    # row 4, column 5: both points at offset (+-0.5, -0.5), equal weights
    assert got[4, 5] == pytest.approx(2.0)
    # column 2: the first at (-2.5, -0.5), the second at (-3.5, -0.5)
    w1, w2 = math.exp(-0.5 * 6.5), math.exp(-0.5 * 12.5)
    assert got[4, 2] == pytest.approx((w1 + 3 * w2) / (w1 + w2))
    assert got[4, 1] == pytest.approx(1.0) and got[4, 8] == pytest.approx(3)


def test_the_product_cutoff_and_the_home_tile():
    cfg = _config("gaussian", 9, sigma_x=0.5, sigma_y=0.5,
                  max_radius_cells=32.0)
    p = Points(np.array([4.5]), np.array([4.5]), np.ones(1, np.float32))
    got = _ref(p, cfg).numpy()
    assert np.isnan(got[2, 2]) and got[4, 2] == 1.0   # cut, kept
    cfg["grid"]["tile"] = 5          # the point's home tile: cells 0..4
    got = _ref(p, cfg).numpy()
    assert np.isnan(got[4, 5]) and got[4, 4] == 1.0


def _small(name):
    from conftest import SMALL
    cfg = json.load(open(f"{registry.HERE}/configs/{name}.json"))
    for group, cut in SMALL[name].items():
        cfg[group].update(cut)
    return cfg


def _points(cfg, seed):
    return registry.cloud_generator(cfg["points"]["kind"])(
        cfg["points"], Grid.of(cfg), seed)


@pytest.mark.parametrize("name", ["dc_lidar_point", "glyph_gauss_s4"])
def test_the_port_on_the_cpu_keeps_the_limits(name, on_cpu):
    from cardbench import jobs
    cfg = _small(name)
    pts = _points(cfg, 2 ** 31 + 9)
    feed = jobs.Feed(cfg, {"source": "host", "chunk_points": 0}, pts)
    bands = jobs.job(feed, jobs.Walls())
    got = compare.readings([bands], compare.references(cfg, pts, "cpu"))
    assert got["nan_cells_differ"] == 0
    assert got["max_rel_err"] < cfg["limits"]["max_rel_err"]
    assert compare.judge(got, cfg["limits"])


@pytest.mark.parametrize("name", ["dc_lidar_point", "glyph_gauss_s4"])
def test_the_control_fails_the_limits(name):
    """The reference in bfloat16, in the program's place, is not correct:
    the limits separate float32 from the step below it."""
    cfg = _small(name)
    for seed in (1, 2, 3):
        pts = _points(cfg, seed)
        refs = compare.references(cfg, pts, "cpu")
        ctl = compare.references(cfg, pts, "cpu", control=True)
        assert all(c.dtype == torch.float32 for c in ctl)
        got = compare.readings([tuple(c.numpy() for c in ctl)], refs)
        assert not compare.judge(got, cfg["limits"]), got
        *_, correct = compare.verdict(cfg, [tuple(c.numpy() for c in ctl)],
                                      0, refs)
        assert correct is False


def test_every_band_of_a_job_is_compared():
    """A job of two reductions: the second band is judged as the first."""
    cfg = _config("point", 4)
    cfg["reductions"].append(dict(cfg["reductions"][0]))
    cfg["limits"] = {"max_rel_err": 1e-4, "nan_cells_differ": 0}
    p = Points(np.array([0.5, 2.2]), np.array([3.5, 0.1]),
               np.array([1, 5], np.float32))
    refs = compare.references(cfg, p, "cpu")
    good = refs[0].numpy().astype(np.float32)
    bad = good.copy()
    bad[0, 0] += 1.0
    assert compare.verdict(cfg, [(good, good)], 0, refs)[2] is True
    checks, _, correct = compare.verdict(cfg, [(good, bad)], 0, refs)
    assert correct is False and checks["max_rel_err"] == 1.0
    assert compare.verdict(cfg, [(good, good)], 1, refs)[2] is False
    assert compare.verdict(cfg, [], 0, refs)[2] is False
