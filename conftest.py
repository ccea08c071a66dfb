"""Sizes for the benchmark's CPU tests (cardbench/tests) of the
configurations added after cardbench/conftest.py: each one's cut for the
small copy of the benchmark (`small_bench` in cardbench/tests/conftest.py),
added to that file's SMALL table when pytest loads it. Nothing else is
touched, so tests/ runs as if this file were not here."""

from __future__ import annotations

import os

CARDBENCH_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "cardbench", "tests")

# the Line glyph at its published stroke (hl 16 at 30 degrees, 33 x 17
# cells) on a grid of 96 x 80 cells: K3's plain version and the step walk
# of the reference stay within a second on the CPU
SMALL = {
    "glyph_line_hl16": {"grid": {"extent_x": 96.0, "extent_y": 80.0},
                        "points": {"count": 3_000}},
    # the DC Gaussian at its published sigma (r = 9) on a 512^2 grid of
    # 256-cell tiles, so that the home-tile clip and the hot clusters both
    # bite; the reference's 361 window offsets stay within seconds
    "dc_lidar_gauss_s3": {"grid": {"extent_x": 512.0, "extent_y": 512.0,
                                   "tile": 256},
                          "points": {"count": 50_000}},
}


def pytest_plugin_registered(plugin, manager):
    path = getattr(plugin, "__file__", None) or ""
    if os.path.dirname(os.path.abspath(path)) == CARDBENCH_TESTS and \
            isinstance(getattr(plugin, "SMALL", None), dict):
        for name, cut in SMALL.items():
            plugin.SMALL.setdefault(name, cut)
